"""Frequentist binomial / quasi-binomial spline GAM trends (the port of
the JAX package's `faba/gam.py`; `faba/src/assoc/gam.rs` + `trend.rs`
equivalents — `faba dyn-assoc --trend-method quasi|binomial`).

Per site and branch, fit `logit(p_i) = f(x_i)` with a restricted cubic
(natural) spline over pseudotime and test the smooth against an
intercept-only null. Coverage is the binomial denominator. The
quasi-binomial default estimates a Pearson dispersion (floored at 1)
and uses an F-test; `overdispersion=False` gives the plain deviance LRT.

Within one branch every site shares the same design matrix, so the
sites' IRLS runs batched on the device: [S, p, p] normal equations
solved together, a fixed `max_iter` Fisher-scoring steps (no early
stop), in float32 as the JAX package computes them (`dtype=torch.float64`
runs the same steps in float64 from the same float32 inputs).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger(__name__)

_RIDGE = 1e-8  # gam.rs:355 near-separation guard
_ETA_CLAMP = 30.0  # gam.rs:383
_EFFECT_CLAMP = 60.0  # gam.rs:224


def quantile_knots(sorted_distinct: np.ndarray, k: int) -> np.ndarray:
    """Type-7 quantile knots over the distinct sorted values
    (gam.rs:253-275)."""
    n = len(sorted_distinct)
    if n == 0:
        return np.empty(0, np.float64)
    if k <= 1 or n == 1:
        return sorted_distinct[:1].astype(np.float64)
    h = (n - 1) * np.arange(k) / (k - 1)
    lo = np.floor(h).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    knots = sorted_distinct[lo] + (h - lo) * (sorted_distinct[hi] - sorted_distinct[lo])
    keep = np.concatenate([[True], np.abs(np.diff(knots)) >= 1e-7])
    return knots[keep]


def _restricted_cubic_design(x: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """[m, k] natural-spline design, intercept in column 0
    (gam.rs:277-311)."""
    if len(knots) < 3:
        return np.stack([np.ones_like(x), x], axis=1)
    t1, tk, tkm1 = knots[0], knots[-1], knots[-2]
    denom = tk - tkm1
    scale = (tk - t1) ** 2
    cube = lambda u: np.maximum(u, 0.0) ** 3  # noqa: E731
    cols = [np.ones_like(x), x]
    for tj in knots[:-2]:
        cols.append(
            (
                cube(x - tj)
                - cube(x - tkm1) * (tk - tj) / denom
                + cube(x - tk) * (tkm1 - tj) / denom
            )
            / scale
        )
    return np.stack(cols, axis=1)


def spline_design(
    x: np.ndarray, n_knots: int = 5
) -> tuple[np.ndarray, np.ndarray] | None:
    """Standardized design + start->end contrast for one branch's cells
    (gam.rs:105-190 `build_spline_design`, minus the per-site coverage
    filter — that lives in the batched IRLS weights here). Returns
    None when the branch can't support a spline."""
    x = np.asarray(x, np.float64)
    finite = np.isfinite(x)
    m = int(finite.sum())
    if m < 4 or not finite.all():
        # callers pass pre-filtered cells; a NaN abscissa is not an
        # observation to fit (gam.rs:99-104 contract)
        x = x[finite]
        if len(x) < 4:
            return None
    lo, hi = float(x.min()), float(x.max())
    span = hi - lo
    if span <= 0:
        return None
    xs = (x - lo) / span

    distinct = np.unique(np.round(xs / 1e-7) * 1e-7)
    k_eff = max(min(n_knots, len(distinct), max(len(xs) - 2, 2)), 2)
    knots = quantile_knots(np.sort(distinct), k_eff)
    xd = _restricted_cubic_design(xs, knots)
    p = xd.shape[1]
    if len(xs) <= p + 1:
        return None

    # center + scale spline columns (intercept untouched, gam.rs:166-177)
    mean = xd[:, 1:].mean(axis=0)
    sd = xd[:, 1:].std(axis=0)
    sd = np.where(sd < 1e-9, 1.0, sd)
    xd[:, 1:] = (xd[:, 1:] - mean) / sd

    imin, imax = int(np.argmin(xs)), int(np.argmax(xs))
    contrast = xd[imax] - xd[imin]
    return xd, contrast


def _xlogy_ratio(a, b):
    return torch.where(a > 0, a * torch.log(a / torch.clamp_min(b, 1e-300)), 0.0)


def _irls_batch(x_mp: torch.Tensor, k_sm: torch.Tensor, n_sm: torch.Tensor, *, max_iter: int):
    """Batched Fisher-scoring of S binomial GLMs sharing one design.
    Zero-trial observations carry zero IRLS weight and zero deviance /
    Pearson mass — identical to dropping them (gam.rs irls_binomial)."""
    mask = n_sm > 0
    n_safe = torch.clamp_min(n_sm, 1.0)
    y = torch.where(mask, k_sm / n_safe, 0.0)

    mu = torch.where(mask, (k_sm + 0.5) / (n_sm + 1.0), 0.5)
    eta = torch.log(mu / (1.0 - mu))
    p = x_mp.shape[1]
    beta = torch.zeros((k_sm.shape[0], p), dtype=x_mp.dtype, device=x_mp.device)
    eye = torch.eye(p, dtype=x_mp.dtype, device=x_mp.device)[None]
    for _ in range(max_iter):
        v = torch.clamp_min(mu * (1.0 - mu), 1e-9)
        w = torch.where(mask, n_sm * v, 0.0)  # [S, m]
        wz = w * (eta + (y - mu) / v)
        xtwx = torch.einsum("mi,sm,mj->sij", x_mp, w, x_mp) + _RIDGE * eye
        xtwz = torch.einsum("mi,sm->si", x_mp, wz)
        beta = torch.linalg.solve(xtwx, xtwz[..., None])[..., 0]
        eta = torch.clamp(beta @ x_mp.T, -_ETA_CLAMP, _ETA_CLAMP)
        mu = torch.sigmoid(eta)

    zero = torch.zeros((), dtype=x_mp.dtype, device=x_mp.device)
    dev = 2.0 * torch.where(
        mask, n_sm * (_xlogy_ratio(y, mu) + _xlogy_ratio(1.0 - y, 1.0 - mu)), zero
    ).sum(dim=1)
    mu_bar = (k_sm * mask).sum(dim=1) / torch.clamp_min((n_sm * mask).sum(dim=1), 1e-12)
    dev_null = 2.0 * torch.where(
        mask,
        n_sm * (_xlogy_ratio(y, mu_bar[:, None]) + _xlogy_ratio(1.0 - y, 1.0 - mu_bar[:, None])),
        zero,
    ).sum(dim=1)
    pearson = torch.where(
        mask, n_sm * (y - mu) ** 2 / torch.clamp_min(mu * (1.0 - mu), 1e-9), zero
    ).sum(dim=1)
    return beta, dev, dev_null, pearson


def gam_association_batch(
    k_sm: np.ndarray,  # [S, m] edited counts per site x covered cell
    n_sm: np.ndarray,  # [S, m] coverage (trials)
    x_m: np.ndarray,  # [m] pseudotime along the branch
    *,
    n_knots: int = 5,
    overdispersion: bool = True,
    max_iter: int = 50,
    device="cuda",
    dtype=torch.float32,
) -> dict | None:
    """`association_test` (gam.rs:194-251) for every site at once.
    Returns per-site arrays: stat, pvalue, effect, dispersion, n_obs,
    ok — or None when the branch can't support a spline at all."""
    from scipy import stats as sps

    design = spline_design(np.asarray(x_m), n_knots)
    if design is None:
        return None
    x_mp, contrast = design
    finite = np.isfinite(np.asarray(x_m, np.float64))
    k_sm = np.asarray(k_sm, np.float64)[:, finite]
    n_sm = np.asarray(n_sm, np.float64)[:, finite]
    p = x_mp.shape[1]

    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, dtype)  # noqa: E731
    beta, dev, dev_null, pearson = (
        a.cpu().numpy()
        for a in _irls_batch(as_t(x_mp), as_t(k_sm), as_t(n_sm), max_iter=max_iter)
    )
    m_s = (n_sm > 0).sum(axis=1)  # per-site usable observations
    dstat = np.maximum(dev_null - dev, 0.0)
    df1 = float(p - 1)
    df2 = np.maximum(m_s - p, 0).astype(np.float64)
    ok = (m_s >= 4) & (df2 >= 1) & (df1 >= 1)

    effect = np.clip(beta @ contrast, -_EFFECT_CLAMP, _EFFECT_CLAMP)
    if overdispersion:
        phi = np.maximum(pearson / np.maximum(df2, 1.0), 1.0)
        stat = (dstat / df1) / phi
        pval = np.where(
            ok, sps.f.sf(stat, df1, np.maximum(df2, 1.0)), np.nan
        )
    else:
        phi = np.ones_like(dstat)
        stat = dstat
        pval = np.where(ok, sps.chi2.sf(dstat, df1), np.nan)

    return {
        "stat": stat.astype(np.float32),
        "pvalue": np.clip(pval, 0.0, 1.0).astype(np.float32),
        "effect": effect.astype(np.float32),
        "dispersion": phi.astype(np.float32),
        "n_obs": m_s.astype(np.int64),
        "ok": ok,
    }
