"""Standalone sparse spike-slab regression by MCMC (the port of the JAX
package's `ops/sparse_regression.py`).

The combined effect is

    theta = sum_c alpha_c (.) effect_c,   alpha_c = sigmoid(incl_c)

with Gaussian latents `incl_c` (soft inclusion weights) and `effect_c`
(slab values) per component, updated together by elliptical-slice steps
against a black-box log-likelihood of theta (the Gaussian regression
lnpdf by default). The components stack into one [C, 2, P] state and
each transition is one batched ESS step of the port's `ops/mcmc.py`, on
the device, with the JAX package's threefry draws; PIPs and posterior
means are read off the retained draws on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import prng
from .mcmc import ess as ess_diag
from .mcmc import run_ess_chains, split_rhat


@dataclass
class SparseRegressionResult:
    pip: np.ndarray  # [P] posterior inclusion probability
    beta_mean: np.ndarray  # [P] posterior mean combined effect
    theta_draws: np.ndarray  # [S, P]
    rhat: float
    ess: float


def fit_sparse_regression_mcmc(
    x: np.ndarray,  # [n, P] design
    y: np.ndarray,  # [n]
    *,
    num_components: int = 5,
    num_samples: int = 400,
    burn_in: int = 200,
    incl_scale: float = 2.0,
    effect_scale: float = 1.0,
    noise_sd: float | None = None,
    lnpdf=None,
    seed: int = 0,
    device="cuda",
) -> SparseRegressionResult:
    """One ESS chain over the stacked (inclusion latent, effect) state.
    `lnpdf`, when given, maps one theta [P] tensor to a scalar tensor."""
    device = torch.device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32).ravel()
    n, p = x.shape
    c = num_components
    if noise_sd is None:
        noise_sd = float(max(np.std(y), 1e-3))
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def thetas_of(states):  # [B, C*2*P] -> [B, P]
        s = states.view(-1, c, 2, p)
        alpha = torch.sigmoid(incl_scale * s[:, :, 0, :])
        return torch.sum(alpha * effect_scale * s[:, :, 1, :], dim=1)

    if lnpdf is None:
        def batch_lnpdf(thetas):
            r = yt[None, :] - thetas @ xt.T
            return -0.5 * torch.sum(r * r, dim=1) / (noise_sd**2)
    else:
        def batch_lnpdf(thetas):
            return torch.stack([lnpdf(t) for t in thetas])

    def chain_lnpdf(states, idx):  # [B, C*2*P] -> [B]
        return batch_lnpdf(thetas_of(states))

    def prior_draw(k, shape):
        return prng.normal_exact_keys(k[None], int(np.prod(shape)), device)[0].view(shape)

    samples, _ = run_ess_chains(
        prng.key(seed), torch.zeros((1, c * 2 * p), device=device),
        prior_draw=prior_draw, lnpdf=chain_lnpdf, num_samples=num_samples, burn_in=burn_in,
    )
    draws = samples[:, 0, :].cpu().numpy().reshape(num_samples, c, 2, p)
    alphas = 1.0 / (1.0 + np.exp(-incl_scale * draws[:, :, 0, :]))
    thetas = (alphas * effect_scale * draws[:, :, 1, :]).sum(axis=1)  # [S, P]
    # PIP: the soft-inclusion model has no discrete z, so inclusion is read
    # from the combined effect: a variable is "in" on a draw when |theta_j|
    # exceeds a tenth of the slab scale
    pip = np.clip((np.abs(thetas) > 0.1 * effect_scale).mean(axis=0), 1e-15, 1 - 1e-15)
    scalar = thetas[:, np.argmax(np.abs(thetas).mean(0))]
    return SparseRegressionResult(
        pip=pip,
        beta_mean=thetas.mean(0),
        theta_draws=thetas,
        rhat=float(split_rhat(scalar)),
        ess=float(ess_diag(scalar)),
    )
