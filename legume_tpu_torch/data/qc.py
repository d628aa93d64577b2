"""Cell QC (the port of the JAX package's `data/qc.py`).

Streaming per-cell statistics (total counts, genes detected, mito and
ribo fractions) with a robust MAD-outlier keep rule and a QC report.
The per-block sums run on the device (`ops/sparse.py::block_col_sums`).
Counts are whole numbers, so every float32 sum below 2^24 is exact in
any order and the statistics equal the JAX package's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import sparse as sparse_ops
from ..ops.random_projection import block_to_device
from .visitors import visit_columns_by_block

MITO_PREFIXES = ("MT-", "mt-", "Mt-")


@dataclass
class CellQcStats:
    total: np.ndarray  # [N] total counts
    n_genes: np.ndarray  # [N] genes detected
    mito_frac: np.ndarray  # [N]
    ribo_frac: "np.ndarray | None" = None  # [N] (when a ribo pattern matched)
    feature_cells: "np.ndarray | None" = None  # [D] cells expressing each gene

    def keep_mask(
        self,
        *,
        min_total: float = 0.0,
        min_genes: int = 0,
        max_mito_frac: float = 1.0,
        max_ribo_frac: float = 1.0,
        nmads: float = 5.0,
        mad_on_counts: bool = True,
        mad_on_genes: bool = True,
    ) -> np.ndarray:
        """Hard floors, then log-scale MAD fences on total counts and genes
        detected."""
        keep = (
            (self.total >= min_total)
            & (self.n_genes >= min_genes)
            & (self.mito_frac <= max_mito_frac)
        )
        if self.ribo_frac is not None and max_ribo_frac < 1.0:
            keep &= self.ribo_frac <= max_ribo_frac

        def mad_fence(x):
            lx = np.log1p(x)
            med = np.median(lx)
            mad = np.median(np.abs(lx - med)) * 1.4826
            if mad <= 0:
                return np.ones_like(x, bool)
            return np.abs(lx - med) <= nmads * mad

        if mad_on_counts:
            keep &= mad_fence(self.total)
        if mad_on_genes:
            keep &= mad_fence(self.n_genes)
        return keep

    def feature_keep_mask(self, min_cells: int = 0) -> "np.ndarray | None":
        """Gene-side keep rule over all streamed cells; for the kept-cells
        rule use `feature_cells_kept` with the keep mask."""
        if self.feature_cells is None:
            return None
        return self.feature_cells >= min_cells

    def report(self) -> dict:
        doc = {
            "n_cells": len(self.total),
            "median_total": float(np.median(self.total)),
            "median_genes": float(np.median(self.n_genes)),
            "median_mito_frac": float(np.median(self.mito_frac)),
        }
        if self.ribo_frac is not None:
            doc["median_ribo_frac"] = float(np.median(self.ribo_frac))
        return doc


def _gene_mask(names, pattern: "str | None", prefixes=()) -> np.ndarray:
    if pattern:
        rx = re.compile(pattern)
        return np.asarray([bool(rx.search(str(g))) for g in names], bool)
    return np.asarray([any(str(g).startswith(p) for p in prefixes) for g in names], bool)


def compute_cell_qc(
    data,
    *,
    block_size: int = 8192,
    mito_pattern: "str | None" = None,  # regex; default: the MITO_PREFIXES
    ribo_pattern: "str | None" = None,  # regex
    with_feature_cells: bool = False,  # an extra per-gene count, for `--feature-min-cells`
    device="cuda",
) -> CellQcStats:
    n, d = data.num_columns, data.num_rows
    names = data.row_names()
    mito = _gene_mask(names, mito_pattern, MITO_PREFIXES)
    ribo = _gene_mask(names, ribo_pattern) if ribo_pattern else None
    mito_t = torch.from_numpy(mito).to(device) if mito.any() else None
    ribo_t = None if ribo is None else torch.from_numpy(ribo).to(device)

    total = torch.zeros(n, dtype=torch.float32, device=device)
    n_genes = torch.zeros(n, dtype=torch.float32, device=device)
    mito_total = torch.zeros(n, dtype=torch.float32, device=device)
    ribo_total = torch.zeros(n, dtype=torch.float32, device=device) if ribo is not None else None
    feature_cells = torch.zeros(d, dtype=torch.float64, device=device)
    for blk in visit_columns_by_block(data, block_size=block_size):
        rows, ptr, vals = block_to_device(blk, device)
        cols = sparse_ops.col_ids_from_ptr(ptr)
        sl = slice(blk.lb, blk.lb + blk.ncols)
        total[sl] = sparse_ops.block_col_sums(cols, vals, ncols=blk.ncols)
        nz = (vals != 0).float()
        n_genes[sl] = sparse_ops.block_col_sums(cols, nz, ncols=blk.ncols)
        if with_feature_cells:
            feature_cells += sparse_ops.block_row_stats(rows, vals, num_genes=d)[2].double()
        for mask, acc in ((mito_t, mito_total), (ribo_t, ribo_total)):
            if mask is not None and acc is not None:
                part = torch.where(mask[rows.long()], vals.float(), 0.0)
                acc[sl] = sparse_ops.block_col_sums(cols, part, ncols=blk.ncols)
    total_np = total.cpu().numpy()
    return CellQcStats(
        total=total_np,
        n_genes=n_genes.cpu().numpy(),
        mito_frac=mito_total.cpu().numpy() / np.maximum(total_np, 1.0),
        ribo_frac=(
            ribo_total.cpu().numpy() / np.maximum(total_np, 1.0) if ribo_total is not None else None
        ),
        feature_cells=feature_cells.cpu().numpy() if with_feature_cells else None,
    )


def feature_cells_kept(data, keep: np.ndarray, *, block_size: int = 8192, device="cuda") -> np.ndarray:
    """[D] cells expressing each gene among the kept cells only (a gene
    seen only in discarded cells does not pass the gene gate)."""
    d = data.num_rows
    keep = np.asarray(keep, bool)
    out = torch.zeros(d, dtype=torch.float64, device=device)
    for blk in visit_columns_by_block(data, block_size=block_size):
        rows, ptr, vals = block_to_device(blk, device)
        kcol = torch.from_numpy(keep[blk.lb : blk.lb + blk.ncols]).to(device)
        cols = sparse_ops.col_ids_from_ptr(ptr)
        nz = torch.where(kcol[cols], (vals != 0).float(), 0.0)
        out += sparse_ops.block_row_stats(rows, nz, num_genes=d)[2].double()
    return out.cpu().numpy()
