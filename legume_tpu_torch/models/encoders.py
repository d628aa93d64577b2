"""The encoders (the port of the JAX package's `models/encoders.py`).

Contract: `forward(x, x0, train=, eps=) -> (log_z, kl)`. The trunk is
Anscombe residual -> Linear+ReLU stack -> BatchNorm -> clamped Gaussian
heads; training draws z = mean + exp(lnvar / 2) * eps with the caller's
standard-normal `eps`, evaluation takes z = mean.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.transforms import anscombe_residual
from ..parallel.mesh import row_moments
from . import losses

CLAMP = 8.0


def soft_clamp(x: torch.Tensor, c: float = CLAMP) -> torch.Tensor:
    """Bound to (-c, c) without killing the gradient: c * tanh(x / c)."""
    return c * torch.tanh(x / c)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax's default Dense init: truncated normal on [-2, 2] standard
    units, variance 1 / fan_in (`weight` is torch's [out, in])."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return weight


def dense(n_in: int, n_out: int, generator: torch.Generator | None = None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class FlaxBatchNorm(nn.Module):
    """BatchNorm with flax's semantics (`momentum=0.9, epsilon=1e-4`):
    training normalises by the biased batch variance mean(x^2) - mean(x)^2
    and moves the running statistics by `r = 0.9 r + 0.1 batch` with that
    same biased variance; evaluation reads the running statistics.
    `torch.nn.BatchNorm1d` would store the unbiased variance instead.

    Under a data-parallel mesh (`mesh`, set by the trainer) each rank holds
    its share of the minibatch, and training normalises by the statistics
    of the whole minibatch, as XLA forms them over the sharded batch
    (`parallel/mesh.py::row_moments`), so every rank moves its running
    statistics alike. A world of one takes the plain path."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        if train and self.mesh is not None:
            mean, var = row_moments(x, self.mesh)
        elif train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GaussianTrunk(nn.Module):
    """Anscombe residual -> ReLU stack -> BatchNorm -> clamped heads.
    Under a data-parallel `mesh` (set by the trainer) the residual's
    per-gene clip scale in training is that of the whole minibatch, as
    the BatchNorm statistics are."""

    def __init__(self, n_features: int, n_latent: int, layers: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mesh = None
        dims = [n_features, *layers]
        self.fc = nn.ModuleList(dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.bn_z = FlaxBatchNorm(dims[-1])
        self.z_mean = dense(dims[-1], n_latent, generator)
        self.z_lnvar = dense(dims[-1], n_latent, generator)

    def forward(self, x_nd, x0_nd=None, *, train: bool):
        h = anscombe_residual(x_nd, x0_nd, mesh=self.mesh if train else None)
        for layer in self.fc:
            h = torch.relu(layer(h))
        h = self.bn_z(h, train=train)
        return soft_clamp(self.z_mean(h)), soft_clamp(self.z_lnvar(h))


class LogSoftmaxEncoder(nn.Module):
    """Dense softmax-simplex encoder: Gaussian trunk -> reparameterise
    -> log_softmax simplex, with the Gaussian KL."""

    def __init__(self, n_features: int, n_topics: int, layers: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_topics = n_topics
        self.layers = tuple(layers)
        self.trunk = GaussianTrunk(n_features, n_topics, layers, generator)

    def forward(self, x_nd, x0_nd=None, *, train: bool, eps: torch.Tensor | None = None):
        z_mean, z_lnvar = self.trunk(x_nd, x0_nd, train=train)
        z = losses.gaussian_reparameterize(z_mean, z_lnvar, eps) if eps is not None else z_mean
        return torch.log_softmax(z, dim=-1), losses.gaussian_kl(z_mean, z_lnvar)

    def latent_gaussian_params(self, x_nd, x0_nd=None, *, train: bool = False):
        """`(mu, lnvar)` heads."""
        return self.trunk(x_nd, x0_nd, train=train)


class GaussianEncoder(nn.Module):
    """Gaussian-latent encoder (`senna vae`): the same trunk, the latent
    returned without the simplex map."""

    def __init__(self, n_features: int, n_latent: int, layers: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_topics = n_latent
        self.layers = tuple(layers)
        self.trunk = GaussianTrunk(n_features, n_latent, layers, generator)

    def forward(self, x_nd, x0_nd=None, *, train: bool, eps: torch.Tensor | None = None):
        z_mean, z_lnvar = self.trunk(x_nd, x0_nd, train=train)
        z = losses.gaussian_reparameterize(z_mean, z_lnvar, eps) if eps is not None else z_mean
        return z, losses.gaussian_kl(z_mean, z_lnvar)

    def latent_gaussian_params(self, x_nd, x0_nd=None, *, train: bool = False):
        return self.trunk(x_nd, x0_nd, train=train)


class LogSoftmaxJointEncoder(nn.Module):
    """Multi-modality softmax encoder: one Gaussian trunk per modality
    slice of the concatenated input (each with its own BatchNorm
    statistics); the modality latents and KLs sum. Training takes one
    standard-normal draw per modality, `eps [M, N, K]`."""

    def __init__(self, n_features: Sequence[int], n_topics: int, layers: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_topics = n_topics
        self.layers = tuple(layers)
        self.n_features = tuple(n_features)
        self.n_draws = len(self.n_features)
        self.trunks = nn.ModuleList(GaussianTrunk(d, n_topics, layers, generator)
                                    for d in self.n_features)

    def _modality_params(self, x_nd, x0_nd, *, train: bool):
        out, lo = [], 0
        for d, trunk in zip(self.n_features, self.trunks):
            x0 = None if x0_nd is None else x0_nd[..., lo : lo + d]
            out.append(trunk(x_nd[..., lo : lo + d], x0, train=train))
            lo += d
        return out

    def forward(self, x_nd, x0_nd=None, *, train: bool, eps: torch.Tensor | None = None):
        params = self._modality_params(x_nd, x0_nd, train=train)
        z = sum(losses.gaussian_reparameterize(m, v, eps[i]) if eps is not None else m
                for i, (m, v) in enumerate(params))
        kl = sum(losses.gaussian_kl(m, v) for m, v in params)
        return torch.log_softmax(z, dim=-1), kl

    def latent_gaussian_params(self, x_nd, x0_nd=None, *, train: bool = False):
        """Summed means; the variances of the summed Gaussians add."""
        params = self._modality_params(x_nd, x0_nd, train=train)
        mean = sum(m for m, _ in params)
        return mean, torch.logsumexp(torch.stack([v for _, v in params]), dim=0)


class _IafLayer(nn.Module):
    """One inverse-autoregressive-flow step (Kingma et al. 2016): masked
    autoregressive (m, s) nets, z' = sigma * z + (1 - sigma) * m with
    log-det sum log sigma. A strictly lower-triangular mask on one [K, K]
    weight makes it autoregressive in z; `h` is the flow context."""

    def __init__(self, n_latent: int, n_context: int, generator: torch.Generator | None = None):
        super().__init__()
        k = n_latent
        self.register_buffer("mask", torch.tril(torch.ones(k, k), -1), persistent=False)
        self.w_ar = nn.Parameter(0.05 * torch.randn(k, k, generator=generator))
        self.ctx = dense(n_context, k, generator)
        self.m = dense(k, k, generator)
        self.s = dense(k, k, generator)

    def forward(self, z, h):
        hidden = torch.tanh(z @ (self.w_ar * self.mask) + self.ctx(h))
        sigma = torch.sigmoid(self.s(hidden) + 2.0)  # bias toward identity at init
        z_new = sigma * z + (1.0 - sigma) * self.m(hidden)
        return z_new, torch.sum(torch.log(sigma + 1e-8), dim=-1)


class IafSoftmaxEncoder(nn.Module):
    """`LogSoftmaxEncoder` with an IAF posterior: a richer than Gaussian
    q(z|x), its KL the Monte-Carlo estimate log q(z) - log p(z) with the
    flows' log-det correction. Training draws eps from `generator`
    (standard normal); evaluation takes eps = 0."""

    def __init__(self, n_features: int, n_topics: int, layers: Sequence[int], n_flows: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_topics = n_topics
        self.layers = tuple(layers)
        self.trunk = GaussianTrunk(n_features, n_topics, layers, generator)
        self.flows = nn.ModuleList(_IafLayer(n_topics, self.layers[-1], generator)
                                   for _ in range(n_flows))
        self.h_proj = dense(n_topics, self.layers[-1], generator)

    def forward(self, x_nd, x0_nd=None, *, train: bool, generator: torch.Generator | None = None):
        z_mean, z_lnvar = self.trunk(x_nd, x0_nd, train=train)
        if train:
            eps = torch.randn(z_mean.shape, generator=generator, dtype=z_mean.dtype,
                              device=z_mean.device)
        else:
            eps = torch.zeros_like(z_mean)
        z = z_mean + torch.exp(0.5 * z_lnvar) * eps
        log_2pi = math.log(2.0 * math.pi)
        log_q = -0.5 * torch.sum(eps**2 + z_lnvar + log_2pi, dim=-1)
        h = self.h_proj(z_mean)
        for flow in self.flows:
            z, log_det = flow(z, h)
            log_q = log_q - log_det
        log_p = -0.5 * torch.sum(z**2 + log_2pi, dim=-1)
        return torch.log_softmax(z, dim=-1), log_q - log_p
