"""`faba dyn-assoc` — between-branch Bayesian modality contrast
(the port's copy of the JAX package's `faba/assoc.py`, numpy and scipy
only; `faba/src/assoc/` equivalent).

Given per-cell modality counts at called sites (m6A conversions,
editing events, APA usage — any faba site x cell backend), per-cell
exposure (coverage or total counts), and a branch labeling of the
cells (from `faba lineage` / `senna pseudotime`), score each site for
a rate difference between branches:

- Gamma-Poisson posterior per (site, branch): rate | data ~
  Gamma(a0 + k_b, b0 + n_b)
- contrast = posterior log fold-change between the two branches,
  z-scored by moment matching of the log-Gamma posteriors
- evidence = log Bayes factor of split (independent rates) vs pooled
  (one shared rate), exact via Gamma marginal likelihoods.

All sites are scored in one vectorized pass — the per-site loop of the
reference becomes [S, B] array ops (digamma/gammaln on device-sized
arrays), which numpy handles at memory bandwidth.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.special import gammaln, polygamma, psi

log = logging.getLogger(__name__)


def _gamma_marginal_ll(k, n, a0, b0):
    """log integral Poisson(k | rate * n) Gamma(rate; a0, b0) d rate
    (up to the k! term, which cancels in the Bayes factor)."""
    return (
        a0 * np.log(b0)
        - gammaln(a0)
        + gammaln(a0 + k)
        - (a0 + k) * np.log(b0 + n)
    )


def dyn_assoc(
    counts_sn: np.ndarray,  # [S, N] modality counts per site x cell
    exposure_n: np.ndarray,  # [N] per-cell exposure (coverage / totals)
    branch_n: np.ndarray,  # [N] integer branch label
    *,
    a0: float = 1.0,
    b0: float = 1.0,
) -> dict:
    """Pairwise branch contrast per site. With >2 branches, scores the
    best-vs-rest split per site. Returns log fold change, z, logBF."""
    counts_sn = np.asarray(counts_sn, np.float64)
    exposure_n = np.asarray(exposure_n, np.float64)
    branch_n = np.asarray(branch_n)
    branches = np.unique(branch_n)
    s = counts_sn.shape[0]

    # sufficient stats per (site, branch)
    k_sb = np.stack(
        [counts_sn[:, branch_n == b].sum(1) for b in branches], axis=1
    )  # [S, B]
    n_b = np.asarray([exposure_n[branch_n == b].sum() for b in branches])

    # posterior log-rate moments: E[log rate] = psi(a) - log(b),
    # Var[log rate] = psi'(a)
    a_sb = a0 + k_sb
    b_sb = b0 + n_b[None, :]
    mean_log = psi(a_sb) - np.log(b_sb)
    var_log = polygamma(1, a_sb)

    # best-vs-rest: branch with max posterior mean vs the pooled rest
    best = np.argmax(mean_log, axis=1)
    rows = np.arange(s)
    k_best = k_sb[rows, best]
    n_best = n_b[best]
    k_rest = k_sb.sum(1) - k_best
    n_rest = n_b.sum() - n_best

    a_r, b_r = a0 + k_rest, b0 + n_rest
    mean_r = psi(a_r) - np.log(b_r)
    var_r = polygamma(1, a_r)

    lfc = mean_log[rows, best] - mean_r
    z = lfc / np.sqrt(var_log[rows, best] + var_r)

    # Bayes factor: independent (best, rest) rates vs one pooled rate
    ll_split = _gamma_marginal_ll(k_best, n_best, a0, b0) + _gamma_marginal_ll(
        k_rest, n_rest, a0, b0
    )
    ll_pool = _gamma_marginal_ll(k_best + k_rest, n_best + n_rest, a0, b0)
    log_bf = ll_split - ll_pool

    from scipy.stats import norm

    return {
        "branch": branches[best],
        "log_fold_change": lfc,
        "z": z,
        "log_bf": log_bf,
        "pvalue": 2.0 * norm.sf(np.abs(z)),
        "k_best": k_best,
        "k_rest": k_rest,
    }


def dyn_assoc_pseudotime(
    counts_sn: np.ndarray,
    exposure_n: np.ndarray,
    pseudotime_n: np.ndarray,
    *,
    n_windows: int = 8,
    a0: float = 1.0,
    b0: float = 1.0,
) -> dict:
    """Dynamic association along pseudotime: bin cells into windows,
    fit Gamma posteriors per window, and score each site by the
    posterior slope of log-rate against window center (precision-
    weighted least squares)."""
    counts_sn = np.asarray(counts_sn, np.float64)
    q = np.quantile(pseudotime_n, np.linspace(0, 1, n_windows + 1))
    q[-1] += 1e-9
    win = np.clip(np.searchsorted(q, pseudotime_n, side="right") - 1, 0, n_windows - 1)

    k_sw = np.stack([counts_sn[:, win == w].sum(1) for w in range(n_windows)], 1)
    n_w = np.asarray([np.asarray(exposure_n)[win == w].sum() for w in range(n_windows)])
    centers = 0.5 * (q[:-1] + q[1:])

    a_sw = a0 + k_sw
    b_sw = b0 + np.maximum(n_w, 1e-9)[None, :]
    y = psi(a_sw) - np.log(b_sw)  # [S, W] E[log rate]
    w_prec = 1.0 / polygamma(1, a_sw)  # precision weights

    # weighted least squares slope per site
    x = centers[None, :]
    wx = (w_prec * x).sum(1) / w_prec.sum(1)
    wy = (w_prec * y).sum(1) / w_prec.sum(1)
    cov = (w_prec * (x - wx[:, None]) * (y - wy[:, None])).sum(1)
    varx = (w_prec * (x - wx[:, None]) ** 2).sum(1)
    slope = cov / np.maximum(varx, 1e-12)
    se = 1.0 / np.sqrt(np.maximum(varx, 1e-12))
    z = slope / se

    from scipy.stats import norm

    return {
        "slope": slope,
        "z": z,
        "pvalue": 2.0 * norm.sf(np.abs(z)),
        "window_centers": centers,
        "window_log_rate": y,
    }
