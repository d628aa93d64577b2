"""The NB topic decoder (the port of `NbTopicDecoder` from the JAX
package's `models/decoders.py`): mu = library size * softmax-dictionary
proportions, with a learned per-gene dispersion."""

from __future__ import annotations

import torch
from torch import nn

from . import losses

_LOG_EPS = 1e-30


def forward_log(log_z_nk: torch.Tensor, log_beta_kd: torch.Tensor) -> torch.Tensor:
    """log(sum_k z_nk beta_kd) as one matmul in linear space (safe: the
    trainer's topic smoothing floors z and each beta row is a softmax)."""
    return torch.log(torch.exp(log_z_nk) @ torch.exp(log_beta_kd) + _LOG_EPS)


class NbTopicDecoder(nn.Module):
    def __init__(self, n_features: int, n_topics: int, generator: torch.Generator | None = None):
        super().__init__()
        self.n_features = n_features
        self.n_topics = n_topics
        # [K, D] logits, N(0, 1) as flax's `normal(stddev=1.0)`; ln 2 dispersion
        self.dictionary = nn.Parameter(torch.randn(n_topics, n_features, generator=generator))
        self.log_phi = nn.Parameter(torch.full((1, n_features), 0.693))

    def log_beta_kd(self) -> torch.Tensor:
        return torch.log_softmax(self.dictionary, dim=-1)

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        """(recon [N, D], llik [N])."""
        recon = torch.exp(forward_log(log_z_nk, self.log_beta_kd()))
        mu = recon * x_nd.sum(dim=-1, keepdim=True)
        elem = losses.nb_log_likelihood_elem(x_nd, mu, self.log_phi)
        if feature_weights is not None:
            elem = elem * feature_weights
        return recon, elem.sum(dim=-1)

    def get_dictionary(self) -> torch.Tensor:
        """log beta as [D, K]."""
        return self.log_beta_kd().T
