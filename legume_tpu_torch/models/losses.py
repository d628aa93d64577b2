"""Likelihoods and divergences of the model stack (the port of the JAX
package's `models/losses.py`). All reduce over the trailing (feature)
axis. NB takes the reference engine's fast `approx_lgamma` unless
`exact_lgamma=True` asks for `torch.lgamma`."""

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


def gaussian_neg_log_prob(z: torch.Tensor, mean: torch.Tensor, lnvar: torch.Tensor) -> torch.Tensor:
    """0.5 * sum[(z - mu)^2 / var + lnvar] per row."""
    diff = z - mean
    return 0.5 * torch.sum(diff * diff / torch.exp(lnvar) + lnvar, dim=-1)


def topic_log_likelihood(x_nd: torch.Tensor, log_recon_nd: torch.Tensor) -> torch.Tensor:
    """Multinomial llik with a log-scale reconstruction."""
    return torch.sum(torch.clamp(x_nd, min=0.0) * log_recon_nd, dim=-1)


def topic_likelihood(x_nd: torch.Tensor, recon_nd: torch.Tensor) -> torch.Tensor:
    """Multinomial llik with a probability-scale reconstruction."""
    return topic_log_likelihood(x_nd, torch.log(recon_nd + 1e-8))


def poisson_log_likelihood(x_nd: torch.Tensor, rate_nd: torch.Tensor) -> torch.Tensor:
    """sum[x log(rate) - rate] per row."""
    return torch.sum(x_nd * torch.log(rate_nd) - rate_nd, dim=-1)


def approx_lgamma(x: torch.Tensor) -> torch.Tensor:
    """The reference engine's fast lgamma surrogate (used for ELBO-trace
    parity; `torch.lgamma` would be the exact form)."""
    return -0.0810614667 - x - torch.log(x) + (0.5 + x) * torch.log1p(x)


def nb_log_likelihood_elem(x: torch.Tensor, mu: torch.Tensor, log_phi: torch.Tensor, *,
                           exact_lgamma: bool = False) -> torch.Tensor:
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
    lg = torch.lgamma if exact_lgamma else approx_lgamma
    return lg(x + phi) - lg(phi) - lg(x + 1.0) + term_phi + term_x


def nb_log_likelihood(x_nd: torch.Tensor, mu_nd: torch.Tensor, log_phi_1d: torch.Tensor, *,
                      exact_lgamma: bool = False) -> torch.Tensor:
    """Row-summed NB llik with a per-feature dispersion."""
    return torch.sum(nb_log_likelihood_elem(x_nd, mu_nd, log_phi_1d, exact_lgamma=exact_lgamma),
                     dim=-1)


def zi_topic_log_likelihood(x_nd: torch.Tensor, log_recon_nd: torch.Tensor,
                            dropout_logit_1d: torch.Tensor) -> torch.Tensor:
    """Zero-inflated multinomial llik: a zero is either a dropout
    (log pi) or a multinomial draw (log(1 - pi) + log recon)."""
    eps = 1e-20
    log_pi = torch.log(torch.sigmoid(dropout_logit_1d) + eps)
    log_1mpi = torch.log(torch.sigmoid(-dropout_logit_1d) + eps)
    log_term2 = log_1mpi + log_recon_nd
    m = torch.maximum(log_pi, log_term2)
    zero_llik = m + torch.log(torch.exp(log_pi - m) + torch.exp(log_term2 - m))
    nonzero_llik = log_1mpi + x_nd * log_recon_nd
    return torch.sum(torch.where(x_nd == 0.0, zero_llik, nonzero_llik), dim=-1)


def dirichlet_log_likelihood(x_nd: torch.Tensor, mass_nd: torch.Tensor) -> torch.Tensor:
    """Dirichlet-multinomial llik."""
    a_nd = x_nd + mass_nd
    term1 = torch.sum(torch.lgamma(a_nd) - torch.lgamma(mass_nd), dim=-1)
    term2 = torch.lgamma(torch.sum(mass_nd, dim=-1)) - torch.lgamma(torch.sum(a_nd, dim=-1))
    return term1 + term2


def gaussian_log_likelihood(x_nd: torch.Tensor, hat_nd: torch.Tensor) -> torch.Tensor:
    """-0.5 sum (x - xhat)^2."""
    return -0.5 * torch.sum((x_nd - hat_nd) ** 2, dim=-1)


def smooth_topics(log_z_nk: torch.Tensor, alpha: float) -> torch.Tensor:
    """Mix the simplex with uniform in log space."""
    if alpha <= 0.0:
        return log_z_nk
    k = log_z_nk.shape[-1]
    return torch.log(torch.exp(log_z_nk) * (1.0 - alpha) + alpha / k)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Stable log sigmoid: min(x, 0) - log1p(exp(-|x|))."""
    return torch.minimum(x, torch.zeros_like(x)) - torch.log1p(torch.exp(-torch.abs(x)))


def stick_breaking_log_simplex(logits_nk: torch.Tensor) -> torch.Tensor:
    """Deterministic stick-breaking logits -> log-simplex:
    log theta_k = eta_k + sum_{j<=k} log(1 - v_j) for k < K-1, and the
    last topic takes the closing mass (rows sum to 1 by telescoping)."""
    k = logits_nk.shape[-1]
    if k == 1:
        return torch.zeros_like(logits_nk)
    eta = logits_nk[..., : k - 1]
    incl = torch.cumsum(log_sigmoid(-eta), dim=-1)
    return torch.cat([eta + incl, incl[..., -1:]], dim=-1)
