"""Site-level hypothesis tests for RNA-modification calling
(`faba/src/hypothesis_tests.rs` equivalent — dartseq/m6A C->T contrast,
A-to-I editing).

Vectorized over sites (the reference runs per-gene rayon loops,
SURVEY.md section 2.7.2); scipy provides exact tails.

The port's copy of the JAX package's `faba/site_tests.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import numpy as np
from scipy.special import betaln, gammaln
from scipy.stats import fisher_exact as _scipy_fisher


def betabinom_pvalue_greater(
    k: np.ndarray, n: np.ndarray, eps: float, rho: float
) -> np.ndarray:
    """Upper-tail beta-binomial p-value P(K >= k) under a noise null of
    mean error `eps` and intra-site correlation `rho`
    (hypothesis_tests.rs:17-52; JACUSA2 call-1 / SAILOR style).
    rho <= 0 reduces to the Binomial tail."""
    k = np.asarray(k, np.int64)
    n = np.asarray(n, np.int64)
    out = np.ones(np.broadcast(k, n).shape, np.float64)
    k, n = np.broadcast_arrays(k, n)
    eps = float(np.clip(eps, 1e-9, 1 - 1e-9))
    if out.size == 0:  # no candidate sites
        return out

    it = np.nditer([k, n], flags=["multi_index"])
    for kv, nv in it:
        kv, nv = int(kv), int(nv)
        idx = it.multi_index
        if nv == 0 or kv == 0:
            out[idx] = 1.0
            continue
        if kv > nv:
            out[idx] = 0.0
            continue
        i = np.arange(kv, nv + 1)
        ln_choose = gammaln(nv + 1) - gammaln(i + 1) - gammaln(nv - i + 1)
        if rho <= 0:
            logp = ln_choose + i * np.log(eps) + (nv - i) * np.log1p(-eps)
        else:
            r = min(rho, 1 - 1e-9)
            s = (1 - r) / r
            a, b = eps * s, (1 - eps) * s
            logp = ln_choose + betaln(i + a, nv - i + b) - betaln(a, b)
        m = logp.max()
        out[idx] = min(np.exp(m) * np.exp(logp - m).sum(), 1.0)
    return out.astype(np.float32)


def fisher_exact_greater(a_w, u_w, a_m, u_m) -> np.ndarray:
    """One-sided Fisher exact on the 2x2 (alt/ref x WT/control) table:
    P(editing in WT >= observed | margins) (hypothesis_tests.rs:125)."""
    a_w, u_w, a_m, u_m = np.broadcast_arrays(
        np.asarray(a_w), np.asarray(u_w), np.asarray(a_m), np.asarray(u_m)
    )
    out = np.ones(a_w.shape, np.float32)
    if out.size == 0:  # no candidate sites
        return out
    it = np.nditer([a_w, u_w, a_m, u_m], flags=["multi_index"])
    for aw, uw, am, um in it:
        _, p = _scipy_fisher([[int(aw), int(uw)], [int(am), int(um)]], alternative="greater")
        out[it.multi_index] = p
    return out


def log_odds_ratio(a_w, u_w, a_m, u_m, *, pseudo: float = 0.5) -> np.ndarray:
    """Haldane-corrected log odds ratio (hypothesis_tests.rs:234)."""
    a_w = np.asarray(a_w, np.float64) + pseudo
    u_w = np.asarray(u_w, np.float64) + pseudo
    a_m = np.asarray(a_m, np.float64) + pseudo
    u_m = np.asarray(u_m, np.float64) + pseudo
    return np.log(a_w * u_m / (u_w * a_m))


def log_odds_ratio_woolf(a_w, u_w, a_m, u_m, *, pseudo: float = 0.5):
    """(log OR, Woolf SE) (hypothesis_tests.rs:292)."""
    lor = log_odds_ratio(a_w, u_w, a_m, u_m, pseudo=pseudo)
    se = np.sqrt(
        1.0 / (np.asarray(a_w, np.float64) + pseudo)
        + 1.0 / (np.asarray(u_w, np.float64) + pseudo)
        + 1.0 / (np.asarray(a_m, np.float64) + pseudo)
        + 1.0 / (np.asarray(u_m, np.float64) + pseudo)
    )
    return lor, se


def contrast_sites(
    alt_wt: np.ndarray,
    ref_wt: np.ndarray,
    alt_ctrl: np.ndarray,
    ref_ctrl: np.ndarray,
    *,
    eps: float = 0.01,
    rho: float = 0.05,
) -> dict:
    """WT-vs-control site contrast (the dartseq m6A core, m6a/run.rs):
    beta-binomial single-sample test in WT + Fisher contrast against
    control. NOT BH-adjusted here — reads are shared across sites
    (SURVEY.md section 3.5 note)."""
    p_bb = betabinom_pvalue_greater(alt_wt, alt_wt + ref_wt, eps, rho)
    p_fisher = fisher_exact_greater(alt_wt, ref_wt, alt_ctrl, ref_ctrl)
    lor, se = log_odds_ratio_woolf(alt_wt, ref_wt, alt_ctrl, ref_ctrl)
    return {
        "pvalue_betabinom": p_bb,
        "pvalue_fisher": p_fisher,
        "log_odds_ratio": lor,
        "lor_se": se,
    }
