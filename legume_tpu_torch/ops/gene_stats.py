"""Per-gene streaming statistics: HVG selection and NB-Fisher weights
(the port of the JAX package's `ops/gene_stats.py`).

The streaming pass sums per-gene moments of raw counts on the device;
the dispersion trend and the ranking are small host math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.visitors import visit_columns_by_block
from . import sparse as sparse_ops

MIN_MEAN_FOR_FIT = 1e-4
PHI_FLOOR = 0.0
PHI_CEIL = 100.0


@dataclass
class DispersionTrend:
    """Weighted log-log fit of NB dispersion against the mean:
    phi_hat = (var - mu) / mu^2, log(phi_hat) regressed on log(mu) with
    weights mu."""

    a: float
    b: float
    num_fit: int

    @classmethod
    def fit(cls, means: np.ndarray, vars_: np.ndarray) -> "DispersionTrend":
        means = np.asarray(means, np.float64)
        vars_ = np.asarray(vars_, np.float64)
        phi_hat = (vars_ - means) / np.maximum(means * means, 1e-30)
        ok = np.isfinite(means) & np.isfinite(vars_) & (means >= MIN_MEAN_FOR_FIT) & (phi_hat > 0)
        if ok.sum() < 2:
            return cls(a=-np.inf, b=0.0, num_fit=int(ok.sum()))
        x = np.log(means[ok])
        y = np.log(phi_hat[ok])
        w = means[ok]
        wsum = w.sum()
        xm = (x * w).sum() / wsum
        ym = (y * w).sum() / wsum
        sxx = (w * (x - xm) ** 2).sum()
        sxy = (w * (x - xm) * (y - ym)).sum()
        if sxx <= 0:
            return cls(a=-np.inf, b=0.0, num_fit=int(ok.sum()))
        b = sxy / sxx
        return cls(a=float(ym - b * xm), b=float(b), num_fit=int(ok.sum()))

    def phi_at(self, mu: np.ndarray) -> np.ndarray:
        mu = np.asarray(mu, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            phi = np.exp(self.a + self.b * np.log(np.maximum(mu, 1e-30)))
        return np.clip(np.nan_to_num(phi, nan=0.0, posinf=PHI_CEIL), PHI_FLOOR, PHI_CEIL)

    def excess(self, mu: np.ndarray, var: np.ndarray) -> np.ndarray:
        """Excess dispersion above the trend."""
        mu = np.asarray(mu, np.float64)
        var = np.asarray(var, np.float64)
        phi_hat = (var - mu) / np.maximum(mu * mu, 1e-30)
        out = phi_hat - self.phi_at(mu)
        out[~np.isfinite(mu) | (mu <= 0) | ~np.isfinite(var)] = -np.inf
        return out

    def fisher_weights(self, pi: np.ndarray, means: np.ndarray, avg_s: float) -> np.ndarray:
        """DC-Poisson gene weight `1 / (1 + pi * s * phi(mu))`, in (0, 1]."""
        return 1.0 / (1.0 + np.asarray(pi) * avg_s * self.phi_at(means))


@dataclass
class GeneStreamStats:
    mean: np.ndarray  # [D]
    var: np.ndarray  # [D]
    pi: np.ndarray  # [D] marginal nonzero probability
    n_cells: int


def streaming_gene_stats(data, *, block_size: int = 8192, device="cuda") -> GeneStreamStats:
    """One pass over column blocks -> per-gene raw-count moments."""
    d = data.num_rows
    s1 = torch.zeros(d, dtype=torch.float32, device=device)
    s2 = torch.zeros_like(s1)
    cnt = torch.zeros_like(s1)
    n = 0
    for blk in visit_columns_by_block(data, block_size=block_size):
        b1, b2, bc = sparse_ops.block_row_stats(
            torch.from_numpy(blk.row_ids).to(device),
            torch.from_numpy(blk.vals).to(device),
            num_genes=d,
        )
        s1 += b1
        s2 += b2
        cnt += bc
        n += blk.ncols
    mean = s1.cpu().numpy() / max(n, 1)
    var = s2.cpu().numpy() / max(n, 1) - mean * mean
    pi = cnt.cpu().numpy() / max(n, 1)
    return GeneStreamStats(mean=mean, var=np.maximum(var, 0.0), pi=pi, n_cells=n)


def reduce_gene_stats(local: GeneStreamStats, reduce_sums) -> GeneStreamStats:
    """Merge per-rank gene moments: rebuild the raw sums (s1 = mean n,
    s2 = (var + mean^2) n, cnt = pi n), sum them with the caller's
    collective (`DistContext.reduce_sums`) and derive the global moments
    again: the exact merge, not an average of averages."""
    n = max(local.n_cells, 1)
    s1 = local.mean * n
    s2 = (local.var + local.mean * local.mean) * n
    cnt = local.pi * n
    s1, s2, cnt, ntot = reduce_sums(s1, s2, cnt, np.asarray([float(local.n_cells)], np.float64))
    n_glob = max(float(ntot[0]), 1.0)
    mean = s1 / n_glob
    var = np.maximum(s2 / n_glob - mean * mean, 0.0)
    return GeneStreamStats(mean=mean, var=var, pi=cnt / n_glob, n_cells=int(round(float(ntot[0]))))


def select_hvg_by_stats(means, vars_, n_genes: int) -> np.ndarray:
    """Top-N gene indices by excess dispersion, ascending."""
    d = len(means)
    if n_genes >= d or n_genes == 0:
        return np.arange(d)
    trend = DispersionTrend.fit(means, vars_)
    score = trend.excess(means, vars_)
    return np.sort(np.argpartition(-score, n_genes)[:n_genes])


def hvg_row_weights(
    data, n_genes: int, *, block_size: int = 8192, stats: GeneStreamStats | None = None,
    device="cuda",
) -> np.ndarray:
    """0/1 row weights gating the projection basis (every gene still
    trains)."""
    d = data.num_rows
    if n_genes == 0 or n_genes >= d:
        return np.ones(d, np.float32)
    if stats is None:
        stats = streaming_gene_stats(data, block_size=block_size, device=device)
    w = np.zeros(d, np.float32)
    w[select_hvg_by_stats(stats.mean, stats.var, n_genes)] = 1.0
    return w


def nb_fisher_weights(
    data, *, block_size: int = 8192, stats: GeneStreamStats | None = None, device="cuda"
) -> np.ndarray:
    """Per-gene NB-Fisher loss weights from the streaming moments."""
    if stats is None:
        stats = streaming_gene_stats(data, block_size=block_size, device=device)
    trend = DispersionTrend.fit(stats.mean, stats.var)
    avg_s = float(stats.mean.sum())
    return trend.fisher_weights(stats.pi, stats.mean, max(avg_s, 1.0)).astype(np.float32)


def hvg_feature_qc(
    counts_rows: np.ndarray,  # [R, D] count rows (cells or pseudobulks)
    *,
    min_excess: float = 0.0,
    min_nnz: float = 0.0,
) -> np.ndarray:
    """Feature QC for the NCE engine (`feature_qc.rs` contract): keep
    genes whose NB dispersion exceeds the fitted mean-dispersion trend by
    more than `min_excess`, drop genes detected in fewer than `min_nnz`
    rows, and keep every gene when the cut would drop 95% or more."""
    x = np.asarray(counts_rows, np.float64)
    mu = x.mean(axis=0)
    var = x.var(axis=0)
    nnz = (x > 0).sum(axis=0)
    trend = DispersionTrend.fit(mu, var)
    keep = trend.excess(mu, var) > min_excess
    if min_nnz > 0:
        keep &= nnz >= min_nnz
    if keep.sum() < 0.05 * keep.size:
        return np.ones(keep.size, bool)
    return keep
