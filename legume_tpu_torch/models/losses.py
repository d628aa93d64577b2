"""Likelihoods and divergences of the topic model (the port of the
parts of the JAX package's `models/losses.py` that `senna topic` uses).
All reduce over the trailing (feature) axis."""

from __future__ import annotations

import torch


def gaussian_kl(z_mean: torch.Tensor, z_lnvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, e^lnvar) || N(0, I)) summed over the last axis."""
    return 0.5 * torch.sum(torch.exp(z_lnvar) - 1.0 + z_mean**2 - z_lnvar, dim=-1)


def gaussian_reparameterize(
    z_mean: torch.Tensor, z_lnvar: torch.Tensor, eps: torch.Tensor
) -> torch.Tensor:
    """mean + exp(lnvar / 2) * eps, with the caller's standard-normal eps."""
    return z_mean + torch.exp(0.5 * z_lnvar) * eps


def approx_lgamma(x: torch.Tensor) -> torch.Tensor:
    """The reference engine's fast lgamma surrogate (used for ELBO-trace
    parity; `torch.lgamma` would be the exact form)."""
    return -0.0810614667 - x - torch.log(x) + (0.5 + x) * torch.log1p(x)


def nb_log_likelihood_elem(x: torch.Tensor, mu: torch.Tensor, log_phi: torch.Tensor) -> torch.Tensor:
    """Elementwise NB llik, no reduction:

    lgamma(x+phi) - lgamma(phi) - lgamma(x+1)
      + phi log(phi/(phi+mu)) + x log(mu/(phi+mu))

    with mu clamped to [1e-6, 1e6] and phi to [e^-10, e^10]."""
    phi = torch.exp(torch.clamp(log_phi, -10.0, 10.0))
    mu = torch.clamp(mu, 1e-6, 1e6)
    eps = 1e-8
    log_denom = torch.log(phi + mu + eps)
    term_phi = phi * (torch.log(phi + eps) - log_denom)
    term_x = x * (torch.log(mu + eps) - log_denom)
    lg = approx_lgamma
    return lg(x + phi) - lg(phi) - lg(x + 1.0) + term_phi + term_x


def smooth_topics(log_z_nk: torch.Tensor, alpha: float) -> torch.Tensor:
    """Mix the simplex with uniform in log space."""
    if alpha <= 0.0:
        return log_z_nk
    k = log_z_nk.shape[-1]
    return torch.log(torch.exp(log_z_nk) * (1.0 - alpha) + alpha / k)
