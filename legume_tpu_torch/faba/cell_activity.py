"""Null-cell calling: which WT cells actually carry the editing enzyme
(`faba/src/editing/cell_activity.rs` equivalent — `dartseq/atoi
--cell-scan`).

Expression QC cannot see the fusion protein (rat APOBEC1 doesn't map;
10x 3' chemistry misses the vector UTR), so a healthy cell with no
functional enzyme passes every expression gate and then dilutes every
site's contrast with coverage-without-signal. This stage scores each
WT cell's genome-wide conversion activity against DEPTH-MATCHED
control (catalytically-dead) cells and keeps the editing-competent
ones. It is QC, not a hypothesis test (the reference's module doc
makes the case): the cut is placed where the DISCARDED pool's pooled
conversion rate equals the control's — "what I am throwing away is
indistinguishable from the dead enzyme" — with no alpha to tune.

Mechanics (cell_activity.rs:388-556, vectorized):
1. stratify WT + control cells by coverage (equal-count strata);
2. fit each stratum's control null by closed-form beta-binomial
   method-of-moments (Kleinman 1973) — deep null cells are ~4x
   overdispersed vs binomial, so rho matters;
3. score every cell as a standardized deviate vs its stratum null
   (not a tail probability: p-values underflow and collapse the top
   of the ranking into ties);
4. rank, then sweep the cut from reject-everything toward
   reject-nothing; stop at the first cut whose rejected pool edits at
   <= `reject_tolerance` x the control rate (1.0 = parameter-free),
   or cut at the control's own `1 - control_tail` quantile.

The port's copy of the JAX package's `faba/cell_activity.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

log = logging.getLogger(__name__)

DEFAULT_REJECT_TOLERANCE = 1.0
DEFAULT_SCAN_MIN_COVERAGE = 50


def fit_betabinom_mom(y: np.ndarray, n: np.ndarray) -> tuple[float, float]:
    """Closed-form beta-binomial method-of-moments: returns (mean, rho)
    with rho in [0, 0.99] (cell_activity.rs:186-220; Kleinman 1973)."""
    y = np.asarray(y, np.float64)
    n = np.asarray(n, np.float64)
    live = n > 0
    y, n = y[live], n[live]
    total_n = n.sum()
    if total_n <= 0:
        return 0.0, 0.0
    mean = float(y.sum() / total_n)
    k = len(n)
    if k < 3 or mean <= 0.0 or mean >= 1.0:
        return mean, 0.0
    s = float((n * (y / n - mean) ** 2).sum())
    denom = total_n - float((n * n).sum()) / total_n
    if denom <= 0:
        return mean, 0.0
    rho = (s / (mean * (1.0 - mean)) - (k - 1)) / denom
    return mean, float(np.clip(rho, 0.0, 0.99))


def quantile_strata(
    values: np.ndarray, n_strata: int = 12, min_per: int = 50
) -> np.ndarray:
    """Equal-count strata labels, deterministic tie-break by index
    (cell_activity.rs:221-242)."""
    values = np.asarray(values, np.float64)
    n = len(values)
    if n == 0:
        return np.zeros(0, np.int64)
    k = max(min(n_strata, n // max(min_per, 1)), 1)
    if k <= 1:
        return np.zeros(n, np.int64)
    order = np.lexsort((np.arange(n), values))
    label = np.empty(n, np.int64)
    label[order] = np.arange(n) * k // n
    return label


def _stratum_scores(
    e: np.ndarray, n: np.ndarray, mean: np.ndarray, rho: np.ndarray
) -> np.ndarray:
    """Depth-adjusted deviate vs the stratum's beta-binomial null
    (cell_activity.rs:364-386); -inf for uncovered cells."""
    m = np.clip(mean, 1e-9, 1.0 - 1e-9)
    nn = np.asarray(n, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        var = m * (1.0 - m) / nn * (1.0 + np.maximum(nn - 1.0, 0.0) * rho)
        s = (e / nn - m) / np.sqrt(var)
    return np.where((nn > 0) & (var > 0), s, -np.inf)


@dataclass
class NullCellCall:
    keep: np.ndarray  # bool over ALL WT cells passed in
    n_scored: int
    selected_rate: float
    rejected_rate: float
    control_rate: float
    control_percentile: float

    @property
    def kept_frac(self) -> float:
        return float(self.keep.sum() / max(self.n_scored, 1)) if self.n_scored else 0.0

    @property
    def rejected_over_control(self) -> float:
        return self.rejected_rate / self.control_rate if self.control_rate > 0 else float("nan")


def call_competent_cells(
    wt_edited: np.ndarray,  # [C] per WT cell
    wt_covered: np.ndarray,
    ctrl_edited: np.ndarray,  # [C2] per control cell
    ctrl_covered: np.ndarray,
    *,
    min_coverage: int = DEFAULT_SCAN_MIN_COVERAGE,
    n_strata: int = 12,
    min_per_stratum: int = 50,
    reject_tolerance: float = DEFAULT_REJECT_TOLERANCE,
    max_reject_frac: float = 0.95,
    control_tail: float = 0.0,
) -> NullCellCall:
    """The null-cell call (cell_activity.rs:388-556). Returns a keep
    mask over the WT cells in input order; under-covered cells are
    rejected without a score, and with no usable control the call
    refuses to cut (keeps everything)."""
    wt_e = np.asarray(wt_edited, np.float64)
    wt_n = np.asarray(wt_covered, np.float64)
    ct_e = np.asarray(ctrl_edited, np.float64)
    ct_n = np.asarray(ctrl_covered, np.float64)

    ct_ok = ct_n >= min_coverage
    control_rate = (
        float(ct_e[ct_ok].sum() / ct_n[ct_ok].sum()) if ct_n[ct_ok].sum() > 0 else 0.0
    )
    scored = wt_n >= min_coverage
    idx = np.nonzero(scored)[0]
    if len(idx) == 0 or control_rate <= 0.0:
        # no null to calibrate against: refuse to cut
        tot = wt_n.sum()
        return NullCellCall(
            keep=np.ones(len(wt_e), bool),
            n_scored=0,
            selected_rate=float(wt_e.sum() / tot) if tot > 0 else 0.0,
            rejected_rate=0.0,
            control_rate=control_rate,
            control_percentile=float("nan"),
        )
    n_wt = len(idx)

    # strata over BOTH arms' coverages; nulls fit from control ONLY
    depths = np.concatenate([wt_n[idx], ct_n[ct_ok]])
    strata = quantile_strata(depths, n_strata, min_per_stratum)
    k_str = int(strata.max()) + 1
    means = np.full(k_str, control_rate)
    rhos = np.zeros(k_str)
    ctrl_strata = strata[n_wt:]
    for s in range(k_str):
        sel = ctrl_strata == s
        if sel.sum() >= 3:
            means[s], rhos[s] = fit_betabinom_mom(ct_e[ct_ok][sel], ct_n[ct_ok][sel])

    wt_scores = _stratum_scores(
        wt_e[idx], wt_n[idx], means[strata[:n_wt]], rhos[strata[:n_wt]]
    )
    ctrl_scores = np.sort(
        _stratum_scores(
            ct_e[ct_ok], ct_n[ct_ok], means[ctrl_strata], rhos[ctrl_strata]
        )
    )

    # rank best-first, ties by original index (the reference ties by
    # barcode; input order here is the caller's barcode order)
    order = np.lexsort((idx, -wt_scores))
    ranked_e = wt_e[idx][order]
    ranked_n = wt_n[idx][order]
    n = n_wt
    suf_e = np.concatenate([np.cumsum(ranked_e[::-1])[::-1], [0.0]])
    suf_n = np.concatenate([np.cumsum(ranked_n[::-1])[::-1], [0.0]])
    min_keep = max(int(np.ceil((1.0 - max_reject_frac) * n)), 1)

    if control_tail > 0.0 and len(ctrl_scores):
        qi = min(int(np.floor((1.0 - control_tail) * len(ctrl_scores))), len(ctrl_scores) - 1)
        threshold = ctrl_scores[qi]
        cut = max(int(np.searchsorted(-wt_scores[order], -threshold, side="left")), min_keep)
    else:
        cut = n
        with np.errstate(invalid="ignore"):
            for k in range(min_keep, n + 1):
                rej = suf_e[k] / suf_n[k] / control_rate if suf_n[k] > 0 else 0.0
                if rej <= reject_tolerance:
                    cut = k
                    break

    boundary = wt_scores[order][cut - 1] if cut >= 1 else np.inf
    control_percentile = (
        100.0 * np.searchsorted(ctrl_scores, boundary, side="left") / len(ctrl_scores)
        if len(ctrl_scores)
        else float("nan")
    )

    keep = np.zeros(len(wt_e), bool)
    keep[idx[order[:cut]]] = True
    sel_n = suf_n[0] - suf_n[cut]
    sel_e = suf_e[0] - suf_e[cut]
    return NullCellCall(
        keep=keep,
        n_scored=n,
        selected_rate=float(sel_e / sel_n) if sel_n > 0 else 0.0,
        rejected_rate=float(suf_e[cut] / suf_n[cut]) if suf_n[cut] > 0 else 0.0,
        control_rate=control_rate,
        control_percentile=float(control_percentile),
    )
