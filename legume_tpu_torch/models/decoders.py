"""The topic decoders (the port of the JAX package's `models/decoders.py`).

Every topic family shares a softmax dictionary: trainable logits `W [K, D]`,
`log beta_kd = log_softmax_D(W)`. `gaussian-nb` (`senna vae`) decodes a
Gaussian latent through a linear map instead, and `DeltaTopicDecoder`
(`joint-topic --decoder delta`) chains per-modality shifts of one base;
`BipartiteDecoder` scores z R F with three likelihoods. `forward_log` is the plain
`exp(log z) @ exp(log beta)` product, as in the JAX package (no Pallas
kernel there). The initialisers are flax's: the logits N(0, 1), `log_phi`
0.693 (ln 2), `log_alpha` 0, `rho_a` -0.5, `rho_b` 0. Each module takes
an explicit `generator` for its random init.
"""

from __future__ import annotations

import torch
from torch import nn

from . import losses

_LOG_EPS = 1e-30


def forward_log(log_z_nk: torch.Tensor, log_beta_kd: torch.Tensor) -> torch.Tensor:
    """log(sum_k z_nk beta_kd) as one matmul in linear space (safe: the
    trainer's topic smoothing floors z and each beta row is a softmax)."""
    return torch.log(torch.exp(log_z_nk) @ torch.exp(log_beta_kd) + _LOG_EPS)


class _SoftmaxTopicDecoder(nn.Module):
    """The [K, D] dictionary logits every family shares."""

    def __init__(self, n_features: int, n_topics: int, generator: torch.Generator | None = None):
        super().__init__()
        self.n_features = n_features
        self.n_topics = n_topics
        self.dictionary = nn.Parameter(torch.randn(n_topics, n_features, generator=generator))

    def log_beta_kd(self) -> torch.Tensor:
        return torch.log_softmax(self.dictionary, dim=-1)

    def get_dictionary(self) -> torch.Tensor:
        """log beta as [D, K]."""
        return self.log_beta_kd().T


class MultinomTopicDecoder(_SoftmaxTopicDecoder):
    """llik = sum_d w_d x_nd log recon_nd."""

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        """(recon [N, D], llik [N])."""
        log_recon = forward_log(log_z_nk, self.log_beta_kd())
        wx = x_nd if feature_weights is None else x_nd * feature_weights
        return torch.exp(log_recon), torch.sum(wx * log_recon, dim=-1)


class NbTopicDecoder(_SoftmaxTopicDecoder):
    """mu = library size * proportions, per-gene learned dispersion."""

    def __init__(self, n_features: int, n_topics: int, generator: torch.Generator | None = None):
        super().__init__(n_features, n_topics, generator)
        self.log_phi = nn.Parameter(torch.full((1, n_features), 0.693))

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        recon = torch.exp(forward_log(log_z_nk, self.log_beta_kd()))
        mu = recon * x_nd.sum(dim=-1, keepdim=True)
        elem = losses.nb_log_likelihood_elem(x_nd, mu, self.log_phi)
        if feature_weights is not None:
            elem = elem * feature_weights
        return recon, elem.sum(dim=-1)


class PoissonTopicDecoder(_SoftmaxTopicDecoder):
    """rate = library size * proportions + 1e-8; llik = x log rate - rate."""

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        recon = torch.exp(forward_log(log_z_nk, self.log_beta_kd()))
        rate = recon * x_nd.sum(dim=-1, keepdim=True) + 1e-8
        elem = x_nd * torch.log(rate) - rate
        if feature_weights is not None:
            elem = elem * feature_weights
        return recon, elem.sum(dim=-1)


class NbMixtureTopicDecoder(_SoftmaxTopicDecoder):
    """NB with a learned ambient profile:

      rho_n = sigmoid(rho_a log(L_n + 1e-8) + rho_b)   per sample
      pi_nd = (1 - rho_n) theta beta + rho_n softmax(log_alpha)
      y_nd ~ NB(L_n pi_nd, phi_d)

    With `rho_prior_weight > 0` the llik gains w ((a-1) log(rho + 1e-6)
    + (b-1) log(1 - rho + 1e-6)), a Beta(a, b) log prior up to its
    constant."""

    def __init__(self, n_features: int, n_topics: int, rho_prior_weight: float = 0.0,
                 rho_prior_alpha: float = 2.0, rho_prior_beta: float = 18.0,
                 generator: torch.Generator | None = None):
        super().__init__(n_features, n_topics, generator)
        self.rho_prior_weight = rho_prior_weight
        self.rho_prior_alpha = rho_prior_alpha
        self.rho_prior_beta = rho_prior_beta
        self.log_phi = nn.Parameter(torch.full((1, n_features), 0.693))
        self.log_alpha = nn.Parameter(torch.zeros(1, n_features))
        self.rho_a = nn.Parameter(torch.full((1, 1), -0.5))
        self.rho_b = nn.Parameter(torch.zeros(1, 1))

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        log_recon = forward_log(log_z_nk, self.log_beta_kd())
        amb = torch.softmax(self.log_alpha, dim=-1)
        lib = x_nd.sum(dim=-1, keepdim=True)
        rho = torch.sigmoid(torch.log(lib + 1e-8) * self.rho_a + self.rho_b)  # [N, 1]
        recon = (1.0 - rho) * torch.exp(log_recon) + rho * amb
        elem = losses.nb_log_likelihood_elem(x_nd, recon * lib, self.log_phi)
        if feature_weights is not None:
            elem = elem * feature_weights
        llik = elem.sum(dim=-1)
        if self.rho_prior_weight > 0.0:
            eps = 1e-6
            log_prior = (self.rho_prior_alpha - 1.0) * torch.log(rho + eps) + (
                self.rho_prior_beta - 1.0
            ) * torch.log(1.0 - rho + eps)
            llik = llik + self.rho_prior_weight * log_prior[:, 0]
        return recon, llik


class _LinearMap(nn.Module):
    """[K, D] loading matrix `kernel` (init N(0, 0.1^2)) and a bias [D]."""

    def __init__(self, n_features: int, n_latent: int, generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(0.1 * torch.randn(n_latent, n_features, generator=generator))
        self.bias = nn.Parameter(torch.zeros(n_features))

    def forward(self, z_nk: torch.Tensor) -> torch.Tensor:
        return z_nk @ self.kernel + self.bias


class GaussianNbDecoder(nn.Module):
    """Gene-axis softmax decoder for a Gaussian latent (`senna vae`):
    proportions = softmax(z W + b) over genes, mu = library size *
    proportions, NB llik with a per-gene dispersion. `n_topics` names
    the latent width, as the topic decoders' does."""

    def __init__(self, n_features: int, n_topics: int, generator: torch.Generator | None = None):
        super().__init__()
        self.n_features = n_features
        self.n_topics = n_topics
        self.dictionary = _LinearMap(n_features, n_topics, generator)
        self.log_phi = nn.Parameter(torch.full((1, n_features), 0.693))

    def forward(self, z_nk, x_nd, feature_weights=None):
        log_prop = torch.log_softmax(self.dictionary(z_nk), dim=-1)
        mu = torch.exp(log_prop) * x_nd.sum(dim=-1, keepdim=True)
        elem = losses.nb_log_likelihood_elem(x_nd, mu, self.log_phi)
        if feature_weights is not None:
            elem = elem * feature_weights
        return torch.exp(log_prop), elem.sum(dim=-1)

    def get_dictionary(self) -> torch.Tensor:
        """[D, K] linear loading matrix."""
        return self.dictionary.kernel.T


DECODERS = {
    "multinomial": MultinomTopicDecoder,
    "nb": NbTopicDecoder,
    "poisson": PoissonTopicDecoder,
    "nb-mixture": NbMixtureTopicDecoder,
    "gaussian-nb": GaussianNbDecoder,
}


class DeltaTopicDecoder(nn.Module):
    """Shared base + cumulative chain deltas for modalities on the same
    feature axis: modality m's dictionary is log_softmax(base + sum_{j<=m}
    delta_j), `base` N(0, 1) and the deltas zero at init. The target is
    the [N, M * D] concatenation; the llik sums the modalities'
    multinomial lliks."""

    def __init__(self, n_features: int, n_topics: int, n_modalities: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_features = n_features
        self.n_topics = n_topics
        self.n_modalities = n_modalities
        self.base = nn.Parameter(torch.randn(n_topics, n_features, generator=generator))
        for m in range(1, n_modalities):
            setattr(self, f"delta_{m}", nn.Parameter(torch.zeros(n_topics, n_features)))

    def forward(self, log_z_nk, x_nmd, feature_weights=None):
        z = torch.exp(log_z_nk)
        logits, recons, llik = self.base, [], 0.0
        d = self.n_features
        for m in range(self.n_modalities):
            if m > 0:
                logits = logits + getattr(self, f"delta_{m}")
            log_beta = torch.log_softmax(logits, dim=-1)
            x_m = x_nmd[:, m * d : (m + 1) * d]
            wx = x_m if feature_weights is None else x_m * feature_weights
            log_recon = torch.log(z @ torch.exp(log_beta) + _LOG_EPS)
            llik = llik + torch.sum(wx * log_recon, dim=-1)
            recons.append(torch.exp(log_recon))
        return torch.cat(recons, dim=-1), llik

    def get_dictionary(self) -> torch.Tensor:
        """Base-modality log dictionary [D, K]."""
        return torch.log_softmax(self.base, dim=-1).T


class BipartiteDecoder(nn.Module):
    """Bipartite block decoder: scores S = z R F with a learned feature
    side F [K, D] and block coupling R [K, K], both initialised N(0, 0.1^2).
    `likelihood` is 'block' (one log-softmax over the whole [N, D]
    matrix), 'symmetric' (column plus row log-softmaxes) or 'poisson'
    (scores are log-rates, clipped to [-20, 20] in the rate)."""

    def __init__(self, n_features: int, n_topics: int, likelihood: str = "block",
                 generator: torch.Generator | None = None):
        super().__init__()
        if likelihood not in ("block", "symmetric", "poisson"):
            raise ValueError(f"unknown bipartite likelihood {likelihood!r}")
        self.likelihood = likelihood
        self.coupling = nn.Parameter(0.1 * torch.randn(n_topics, n_topics, generator=generator))
        self.feature = nn.Parameter(0.1 * torch.randn(n_topics, n_features, generator=generator))

    def forward(self, log_z_nk, x_nd, feature_weights=None):
        """(scores [N, D], llik [N])."""
        scores = torch.exp(log_z_nk) @ self.coupling @ self.feature
        wx = x_nd if feature_weights is None else x_nd * feature_weights
        if self.likelihood == "block":
            log_p = torch.log_softmax(scores.reshape(-1), dim=0).reshape(scores.shape)
            llik = torch.sum(wx * log_p, dim=-1)
        elif self.likelihood == "symmetric":
            log_p = torch.log_softmax(scores, dim=0) + torch.log_softmax(scores, dim=1)
            llik = torch.sum(wx * log_p, dim=-1)
        else:
            rate = torch.exp(torch.clamp(scores, -20.0, 20.0))
            llik = torch.sum(wx * scores - rate, dim=-1)
        return scores, llik

    def get_dictionary(self) -> torch.Tensor:
        """F as [D, K]."""
        return self.feature.T
