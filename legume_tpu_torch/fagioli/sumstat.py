"""fagioli: GWAS fine-mapping from summary statistics (the port of the JAX
package's `fagioli/sumstat.py`).

- `simulate_sumstat`: LD-correlated genotypes and causal effects giving
  z-scores (`sim-sumstat --legacy`; numpy, the JAX package's arrays);
- `map_sumstat`: SuSiE-RSS fine-mapping of z-scores against a reference
  genotype panel (eigenspace LD design, SGVB on the device);
- `fit_prs`, `fit_sumstat_sgvb` and `fit_sumstat_mcmc` (elliptical slice
  sampling on the RSS likelihood, the port's `ops/mcmc.py`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.sgvb import (
    RssDesign,
    SgvbConfig,
    contiguous_ld_blocks,
    fit_regression,
    fit_regression_ash,
    fit_regression_grid,
    fit_susie_rss,
    gaussian_llik,
)

log = logging.getLogger(__name__)


@dataclass
class SumstatSim:
    genotypes: np.ndarray  # [n, p] 0/1/2 dosages
    z: np.ndarray  # [p] marginal z-scores
    beta: np.ndarray  # [p] true effects
    causal: np.ndarray  # [p] bool


def simulate_sumstat(
    n: int = 500,
    p: int = 200,
    n_causal: int = 3,
    h2: float = 0.3,
    ld_decay: float = 0.1,
    maf_low: float = 0.05,
    seed: int = 0,
) -> SumstatSim:
    """LD through an AR(1)-correlated latent; marginal z from the realized
    phenotype."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((n, p))
    lat = np.empty((n, p))
    lat[:, 0] = eps[:, 0]
    rho = np.exp(-ld_decay)
    for j in range(1, p):
        lat[:, j] = rho * lat[:, j - 1] + np.sqrt(1 - rho * rho) * eps[:, j]
    from scipy.stats import norm

    maf = rng.uniform(maf_low, 0.5, p)
    thr = norm.ppf(1 - maf)  # lat columns are ~N(0,1)
    x = (lat > thr[None, :]).astype(np.float64) + (
        rng.random((n, p)) < maf[None, :]
    ).astype(np.float64)

    causal = np.zeros(p, bool)
    causal[rng.choice(p, n_causal, replace=False)] = True
    beta = np.where(causal, rng.normal(0, 1, p), 0.0)
    xs = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
    g = xs @ beta
    g_var = g.var()
    noise = rng.standard_normal(n) * np.sqrt(g_var * (1 - h2) / max(h2, 1e-9))
    y = g + noise
    y = (y - y.mean()) / y.std()

    z = (xs * y[:, None]).sum(0) / np.sqrt(n)
    return SumstatSim(genotypes=x, z=z, beta=beta, causal=causal)


def map_sumstat(
    z: np.ndarray,
    ref_genotypes: np.ndarray,
    *,
    L: int = 5,
    rank: Optional[int] = None,
    lam: float = 0.1,
    ldsc_intercept: bool = True,
    pve_adjust: bool = True,
    config: SgvbConfig | None = None,
    multilevel: bool = False,
    block_size: int | None = None,
    ld_blocks: "np.ndarray | None" = None,  # [p] block id per variant
    device="cuda",
) -> dict:
    """SuSiE-RSS fine-mapping: returns pip [p], alpha [L, p], effects.

    `multilevel` takes the hierarchical block / within-block selection
    over positional LD blocks; `ld_blocks` overrides the contiguous
    blocks with user block ids."""
    design = RssDesign.from_genotypes(
        ref_genotypes, z, rank=rank, lam=lam,
        ldsc_intercept=ldsc_intercept, pve_adjust=pve_adjust,
    )
    if multilevel:
        p = z.shape[0]
        out = fit_regression(
            design.x_tilde, design.y_tilde, family="ml-susie", L=L, llik=gaussian_llik,
            config=config,
            groups=(np.asarray(ld_blocks, np.int32) if ld_blocks is not None
                    else contiguous_ld_blocks(p, block_size)),
            device=device,
        )
    else:
        out = fit_susie_rss(design, L=L, config=config, device=device)
    out["pip"] = out["pip"][:, 0]
    return out


def fit_prs(
    z: np.ndarray,
    ref_genotypes: np.ndarray,
    *,
    L: int = 10,
    score_genotypes: np.ndarray | None = None,
    config: SgvbConfig | None = None,
    device="cuda",
) -> dict:
    """Sparse polygenic-score weights by SuSiE on summary statistics
    (`fagioli fit-prs-susie`): the posterior-mean effects are the weights;
    optionally scores a genotype panel (standardized dosages) with them."""
    out = map_sumstat(z, ref_genotypes, L=L, config=config, device=device)
    weights = out["theta_mean"][:, 0]
    result = {"weights": weights, "pip": out["pip"]}
    if score_genotypes is not None:
        xs = np.asarray(score_genotypes, np.float64)
        xs = (xs - xs.mean(0)) / np.maximum(xs.std(0), 1e-8)
        result["prs"] = xs @ weights
    return result


def fit_sumstat_mcmc(
    z: np.ndarray,
    ref_genotypes: np.ndarray,
    *,
    rank: Optional[int] = None,
    lam: float = 0.1,
    ldsc_intercept: bool = True,
    pve_adjust: bool = True,
    prior_sd: float = 0.3,
    num_samples: int = 1000,
    burn_in: int = 200,
    n_chains: int = 4,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Posterior over effects by elliptical slice sampling on the RSS
    likelihood (`fagioli fit-sumstat-mcmc`): beta ~ N(0, prior_sd^2 I),
    y_tilde ~ N(X_tilde beta, I). The chains step together on the device;
    the draws are the JAX package's threefry normals (`prng.normal_exact_rows`).
    Returns the posterior mean and sd with split-Rhat and ESS diagnostics."""
    from ..ops.mcmc import ess as ess_diag
    from ..ops.mcmc import run_ess_chains, split_rhat
    from ..utils import prng

    device = torch.device(device)
    design = RssDesign.from_genotypes(
        ref_genotypes, z, rank=rank, lam=lam,
        ldsc_intercept=ldsc_intercept, pve_adjust=pve_adjust,
    )
    x_t = torch.from_numpy(design.x_tilde).to(device)  # [r, p]
    y_t = torch.from_numpy(np.ascontiguousarray(design.y_tilde[:, 0])).to(device)

    def lnpdf(beta, idx):  # [C, p] -> [C]
        resid = y_t[None, :] - beta @ x_t.T
        return -0.5 * torch.sum(resid**2, dim=-1)

    def prior_draw(k, shape):
        return prior_sd * prng.normal_exact_keys(k[None], int(np.prod(shape)), device)[0].view(shape)

    p = z.shape[0]
    key = prng.key(seed)
    init = prior_draw(key, (n_chains, p))
    samples, _ = run_ess_chains(
        key, init, prior_draw=prior_draw, lnpdf=lnpdf, num_samples=num_samples,
        burn_in=burn_in,
    )  # [num_samples, C, p]
    s = samples.cpu().numpy()
    flat = s.reshape(-1, p)
    rhat = np.asarray([split_rhat(s[:, :, j].T.reshape(-1)) for j in range(p)])
    ess_j = np.asarray([ess_diag(flat[:, j]) for j in range(p)])
    return {
        "beta_mean": flat.mean(0),
        "beta_sd": flat.std(0),
        "rhat": rhat,
        "ess": ess_j,
        "samples": s,
    }


def fit_sumstat_sgvb(
    z: np.ndarray,
    ref_genotypes: np.ndarray,
    *,
    model: str = "susie",
    prior_type: str = "single",
    prior_vars: Optional[Sequence[float]] = None,
    L: int = 5,
    rank: Optional[int] = None,
    lam: float = 0.1,
    ldsc_intercept: bool = True,
    pve_adjust: bool = True,
    config=None,
    block_size: Optional[int] = None,
    device="cuda",
) -> dict:
    """SGVB fine-mapping on summary statistics with a choice of family and
    prior (`fagioli fit-sumstat-sgvb`):

    - model: susie / bisusie / spike-slab / ml-susie
    - prior_type "single": grid search over `prior_vars`, keep the
      max-ELBO fit (reports `prior_var`, `grid_elbos`)
    - prior_type "ash": mixture-of-Gaussians prior over the grid with
      learnable weights (spike-slab family; reports `mix_weights`)
    """
    grid = list(prior_vars) if prior_vars else [0.01, 0.1, 1.0]
    cfg = config or SgvbConfig(num_steps=1000)
    design = RssDesign.from_genotypes(
        ref_genotypes, z, rank=rank, lam=lam,
        ldsc_intercept=ldsc_intercept, pve_adjust=pve_adjust,
    )
    if prior_type == "ash":
        if model not in ("spike-slab",):
            log.info("ash prior runs on the spike-slab family (requested %s)", model)
        out = fit_regression_ash(
            design.x_tilde, design.y_tilde, prior_vars=grid, llik=gaussian_llik, config=cfg,
            device=device,
        )
    else:
        groups = contiguous_ld_blocks(z.shape[0], block_size) if model == "ml-susie" else None
        out = fit_regression_grid(
            design.x_tilde, design.y_tilde, prior_vars=grid, family=model, L=L,
            llik=gaussian_llik, config=cfg, groups=groups, device=device,
        )
    pip = np.asarray(out["pip"])
    out["pip"] = pip[:, 0] if pip.ndim > 1 else pip
    return out
