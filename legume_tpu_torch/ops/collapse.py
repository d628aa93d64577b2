"""The pseudobulk collapse engine (the port of the JAX package's
`ops/collapse.py`).

1. sufficient statistics: per-group and per-batch sums in one streaming
   pass, and with more than one batch the counterfactual matched sums
   from exact kNN across batches with softmax(-distance) weights. On the
   card every group sum goes through kernel K3 (`kernels.collapse`),
   accumulating into a [D, S] plane that stays on the device;
2. `optimize`: Poisson-Gamma coordinate descent over the [D, S] planes;
3. `CollapsedOut`: Gamma posteriors per plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.visitors import csc_to_coo_block, visit_columns_by_block
from . import kernels
from . import sparse as sparse_ops
from .gamma import GammaParam
from .random_projection import block_to_device


@dataclass
class CollapsedStat:
    """Host-side sufficient statistics."""

    observed_sum_ds: np.ndarray  # [D, S]
    imputed_sum_ds: np.ndarray  # [D, S]
    residual_sum_ds: np.ndarray  # [D, S]
    size_s: np.ndarray  # [S]
    observed_sum_db: np.ndarray  # [D, B]
    n_bs: np.ndarray  # [B, S]

    @classmethod
    def zeros(cls, num_genes: int, num_groups: int, num_batches: int):
        return cls(
            observed_sum_ds=np.zeros((num_genes, num_groups), np.float32),
            imputed_sum_ds=np.zeros((num_genes, num_groups), np.float32),
            residual_sum_ds=np.zeros((num_genes, num_groups), np.float32),
            size_s=np.zeros(num_groups, np.float32),
            observed_sum_db=np.zeros((num_genes, num_batches), np.float32),
            n_bs=np.zeros((num_batches, num_groups), np.float32),
        )

    @property
    def num_genes(self):
        return self.observed_sum_ds.shape[0]

    @property
    def num_groups(self):
        return self.observed_sum_ds.shape[1]

    @property
    def num_batches(self):
        return self.observed_sum_db.shape[1]


@dataclass
class CollapsedOut:
    """Gamma posteriors per plane."""

    mu_observed: GammaParam
    mu_adjusted: Optional[GammaParam] = None
    mu_residual: Optional[GammaParam] = None
    gamma: Optional[GammaParam] = None
    delta: Optional[GammaParam] = None


def collect_basic_stats(
    data,
    groups: np.ndarray,
    num_groups: int,
    *,
    num_batches: int = 1,
    batches: np.ndarray | None = None,
    block_size: int = 8192,
    device="cuda",
) -> CollapsedStat:
    """Observed per-group (and per-batch) sums in one streaming pass; the
    running planes stay on the device and each block adds into them."""
    d = data.num_rows
    stat = CollapsedStat.zeros(d, num_groups, num_batches)
    groups = np.asarray(groups, dtype=np.int32)
    obs_ds = torch.zeros(d, num_groups, dtype=torch.float32, device=device)
    obs_db = (
        torch.zeros(d, num_batches, dtype=torch.float32, device=device)
        if num_batches > 1
        else None
    )
    batch_codes = None if obs_db is None else np.asarray(batches, dtype=np.int32)
    for blk in visit_columns_by_block(data, block_size=block_size):
        r, p, v = block_to_device(blk, device)
        cols = slice(blk.lb, blk.lb + blk.ncols)
        seg = torch.from_numpy(groups[cols]).to(device)
        kernels.collapse(r, p, v, seg, num_genes=d, num_groups=num_groups, out=obs_ds)
        if obs_db is not None:
            bseg = torch.from_numpy(batch_codes[cols]).to(device)
            kernels.collapse(r, p, v, bseg, num_genes=d, num_groups=num_batches, out=obs_db)
    stat.observed_sum_ds = obs_ds.cpu().numpy()
    np.add.at(stat.size_s, groups, 1.0)
    if obs_db is not None:
        stat.observed_sum_db = obs_db.cpu().numpy()
        np.add.at(stat.n_bs, (batch_codes.astype(np.int64), groups.astype(np.int64)), 1.0)
    return stat


def _matched_weights(dist: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """softmax(-distance) per query over its pooled matched set."""
    neg = torch.where(valid, -dist, -torch.inf)
    mx = neg.max(dim=-1, keepdim=True).values
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.where(valid, torch.exp(neg - mx), 0.0)
    s = e.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, e / torch.clamp(s, min=1e-30), 0.0)


MATCHED_CELL_BLOCK = 1024  # queries per K3 launch of the matched plane


def matched_block(data, groups, m_idx, m_dist, m_valid, lb: int, ub: int, *, device="cuda"):
    """The matched cells of queries [lb, ub) as one column-sorted block,
    query-major with M = m_idx.shape[1] columns per query: (row_ids,
    col_ptr, vals weighted by softmax(-distance), col_ids, and the query's
    group of each column) on `device`."""
    m = m_idx.shape[1]
    w = _matched_weights(
        torch.as_tensor(m_dist[lb:ub], device=device),
        torch.as_tensor(m_valid[lb:ub], device=device),
    ).reshape(-1)  # [(ub - lb) * M]
    y0_blk = csc_to_coo_block(data.read_columns_csc(m_idx[lb:ub].reshape(-1)))
    rows, ptr, vals = block_to_device(y0_blk, device)
    cols = sparse_ops.col_ids_from_ptr(ptr)
    seg = torch.from_numpy(np.asarray(groups[lb:ub], np.int32).repeat(m)).to(device)
    return rows, ptr, (vals * w[cols]).contiguous(), cols, seg


def collect_matched_stats(
    data,
    groups: np.ndarray,
    num_groups: int,
    batches: np.ndarray,
    num_batches: int,
    proj_nk: np.ndarray,  # [N, K] projected cells (kNN coordinates)
    *,
    knn: int = 10,
    cell_block: int = MATCHED_CELL_BLOCK,
    gene_chunk: int = 4096,
    stat: CollapsedStat | None = None,
    query_range: tuple[int, int] | None = None,
    device="cuda",
) -> CollapsedStat:
    """Counterfactual matched sufficient statistics. For each cell j, pool
    the `knn` nearest cells of every other batch, weight them by
    softmax(-L2), and accumulate

        imputed_sum_ds[:, s]  += y_hat_j
        residual_sum_ds[:, s] += y_j / (y_hat_j * scale_j) on the support
            where both are positive, y_j elsewhere,
        scale_j = sum(y_j) / sum(y_hat_j).

    `query_range=(lb, ub)` takes the query cells of one rank's column
    range only (their partners are read wherever they lie); the ranks'
    partial planes sum afterwards. Every sum runs in a fixed order
    (`segment_add`), so two card runs give the same planes."""
    from .knn import matched_neighbors_across_batches

    d = data.num_rows
    if stat is None:
        stat = CollapsedStat.zeros(d, num_groups, num_batches)
    groups = np.asarray(groups, dtype=np.int32)
    m_idx, m_dist, m_valid = matched_neighbors_across_batches(
        proj_nk, np.asarray(batches), num_batches, knn, device=device
    )
    m = m_idx.shape[1]
    imputed = torch.zeros(d, num_groups, dtype=torch.float32, device=device)
    residual = torch.zeros(d, num_groups, dtype=torch.float32, device=device)

    q_lb, q_ub = query_range if query_range is not None else (0, data.num_columns)
    for lb in range(q_lb, q_ub, cell_block):
        ub = min(lb + cell_block, q_ub)
        c = ub - lb
        y0_rows, y0_ptr, y0_vals_w, y0_cols, seg_group = matched_block(
            data, groups, m_idx, m_dist, m_valid, lb, ub, device=device
        )

        # imputed: weighted collapse of the matched cells into the query groups
        kernels.collapse(
            y0_rows, y0_ptr, y0_vals_w, seg_group,
            num_genes=d, num_groups=num_groups, out=imputed,
        )

        # per-query totals for the scale: xsum / dsum (dsum = 0 -> 1)
        y_blk = csc_to_coo_block(data.read_columns_csc(np.arange(lb, ub)))
        y_rows, y_ptr, y_vals = block_to_device(y_blk, device)
        y_cols = sparse_ops.col_ids_from_ptr(y_ptr)
        xsum = sparse_ops.block_col_sums(y_cols, y_vals, ncols=c)
        pair_query = torch.div(y0_cols, m, rounding_mode="floor")
        dsum = sparse_ops.segment_add(
            torch.zeros(c, dtype=torch.float32, device=device), 0, pair_query, y0_vals_w
        )
        scale = torch.where(dsum > 0, xsum / torch.clamp(dsum, min=1e-30), 1.0)

        # residual: gene-chunked dense division on y's support
        qgrp = torch.from_numpy(groups[lb:ub].astype(np.int64)).to(device)
        for g_lb in range(0, d, gene_chunk):
            g_ub = min(g_lb + gene_chunk, d)
            y_dense = _densify_gene_chunk(y_rows, y_cols, y_vals, g_lb, g_ub, c)
            yhat_dense = _densify_gene_chunk(y0_rows, pair_query, y0_vals_w, g_lb, g_ub, c)
            adj = torch.where(
                (y_dense > 0) & (yhat_dense > 0),
                y_dense / (yhat_dense * scale[:, None]),
                y_dense,
            )
            res_chunk = torch.zeros(num_groups, g_ub - g_lb, dtype=torch.float32, device=device)
            sparse_ops.segment_add(res_chunk, 0, qgrp, adj)
            residual[g_lb:g_ub] += res_chunk.T

    stat.imputed_sum_ds += imputed.cpu().numpy()
    stat.residual_sum_ds += residual.cpu().numpy()
    return stat


def _densify_gene_chunk(rows, cols, vals, g_lb: int, g_ub: int, ncells: int) -> torch.Tensor:
    """Dense [ncells, g_ub - g_lb] slab of one gene range of a block."""
    keep = (rows >= g_lb) & (rows < g_ub)
    return sparse_ops.densify_block(
        rows[keep] - g_lb, cols[keep], vals[keep], ncols=ncells, num_genes=g_ub - g_lb
    )


def _optimize_device(
    observed_ds, imputed_ds, residual_ds, size_s, observed_db, n_bs,
    *, num_iter: int, batched: bool, a0: float = 1.0, b0: float = 1.0,
) -> dict:
    """DC-Poisson coordinate descent; returns the (a, b) plane pairs."""
    size_row = size_s[None, :]
    mu_obs = (a0 + observed_ds, (b0 + size_row).expand_as(observed_ds).contiguous())
    if not batched:
        return {"mu_observed": mu_obs}

    # mu_resid stays fixed across the loop
    resid_a = a0 + residual_ds
    resid_b = (b0 + size_row).expand_as(residual_ds).contiguous()
    resid_mean = resid_a / resid_b
    mu_adj_a = a0 + observed_ds + imputed_ds
    g_a = a0 + imputed_ds

    # gamma's posterior mean starts at zero, not a0 / b0
    gamma_mean = torch.zeros_like(observed_ds)
    mu_b = torch.ones_like(observed_ds)
    g_b = torch.ones_like(observed_ds)
    for _ in range(num_iter):
        # mu = (observed + imputed) / ((mu_resid + gamma) * size_s)
        mu_b = b0 + (resid_mean + gamma_mean) * size_row
        mu_mean = mu_adj_a / mu_b
        # gamma = imputed / (mu * size_s)
        g_b = b0 + mu_mean * size_row
        gamma_mean = g_a / g_b

    # delta = observed_db / (mu * n_bs^T)
    delta_a = a0 + observed_db
    delta_b = b0 + (mu_adj_a / mu_b) @ n_bs.T
    return {
        "mu_observed": mu_obs,
        "mu_adjusted": (mu_adj_a, mu_b),
        "mu_residual": (resid_a, resid_b),
        "gamma": (g_a, g_b),
        "delta": (delta_a, delta_b),
    }


def optimize(
    stat: CollapsedStat, *, num_iter: int = 100, a0: float = 1.0, b0: float = 1.0, device="cuda"
) -> CollapsedOut:
    """Fit the Gamma posteriors from a populated stat."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    planes = _optimize_device(
        t(stat.observed_sum_ds), t(stat.imputed_sum_ds), t(stat.residual_sum_ds),
        t(stat.size_s), t(stat.observed_sum_db), t(stat.n_bs),
        num_iter=num_iter, batched=stat.num_batches > 1, a0=a0, b0=b0,
    )

    def mk(name) -> Optional[GammaParam]:
        if name not in planes:
            return None
        a, b = planes[name]
        return GammaParam(a=a, b=b, a0=a0, b0=b0)

    return CollapsedOut(
        mu_observed=mk("mu_observed"),
        mu_adjusted=mk("mu_adjusted"),
        mu_residual=mk("mu_residual"),
        gamma=mk("gamma"),
        delta=mk("delta"),
    )


def merge_stat(fine: CollapsedStat, fine_to_coarse: np.ndarray, num_coarse: int) -> CollapsedStat:
    """Aggregate fine-group stats into coarse groups."""
    coarse = CollapsedStat.zeros(fine.num_genes, num_coarse, fine.num_batches)
    f2c = np.asarray(fine_to_coarse, dtype=np.int64)
    np.add.at(coarse.observed_sum_ds.T, f2c, fine.observed_sum_ds.T)
    np.add.at(coarse.imputed_sum_ds.T, f2c, fine.imputed_sum_ds.T)
    np.add.at(coarse.residual_sum_ds.T, f2c, fine.residual_sum_ds.T)
    np.add.at(coarse.size_s, f2c, fine.size_s)
    np.add.at(coarse.n_bs.T, f2c, fine.n_bs.T)
    coarse.observed_sum_db = fine.observed_sum_db.copy()
    return coarse
