"""Plain torch block ops over column-sorted COO blocks (the port of the
JAX package's `ops/sparse.py`).

A block is `(row_ids [nnz], col_ids [nnz], vals [nnz])` with `col_ids`
sorted, each in [0, ncols). These are the plain versions the CUDA
kernels in `ops/kernels.py` are held against, and the path the CPU
takes. Their sums go through `index_add_`, so on a CUDA tensor their
order is not fixed from run to run; `block_row_stats` (the streaming
gene moments every card run forms) and `block_col_sums` (the library
sizes of the matched statistics) sum through `segment_add`, whose order
is.
"""

from __future__ import annotations

import torch


def segment_add(out: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`out.index_add_(dim, index, src)` in a fixed order of addition on
    every device: a CUDA `index_add_` adds with float atomics, whose order
    (and so whose rounding) changes from run to run; `index_put_` with
    `accumulate=True` sorts the indices stably and adds the entries of one
    index in the order of `src` (on the CPU it runs serially, in the same
    order as `index_add_`). `dim` is 0 or 1."""
    if dim == 0:
        return out.index_put_((index,), src, accumulate=True)
    lead = torch.arange(out.shape[0], device=out.device)[:, None]
    return out.index_put_((lead, index[None, :]), src, accumulate=True)


def col_ids_from_counts(col_counts: torch.Tensor) -> torch.Tensor:
    """int64 [nnz] local cell id of each entry, from per-cell counts."""
    ncols = col_counts.shape[0]
    return torch.repeat_interleave(
        torch.arange(ncols, device=col_counts.device), col_counts.long()
    )


def col_ids_from_ptr(col_ptr: torch.Tensor) -> torch.Tensor:
    """int64 [nnz] local cell id of each entry, from the [ncols + 1] scan."""
    return col_ids_from_counts(col_ptr[1:] - col_ptr[:-1])


def project_block(
    basis_dk: torch.Tensor,  # [D, K] f32
    row_ids: torch.Tensor,  # [nnz] gene ids
    col_ids: torch.Tensor,  # [nnz] local cell ids, sorted
    vals: torch.Tensor,  # [nnz]
    *,
    ncols: int,
) -> torch.Tensor:
    """Projected block [ncols, K]: out[j] = sum_nz basis[row, :] * val."""
    contrib = basis_dk[row_ids.long()] * vals.float()[:, None]
    out = torch.zeros(ncols, basis_dk.shape[1], dtype=torch.float32, device=basis_dk.device)
    return out.index_add_(0, col_ids.long(), contrib)


def project_block_normed(basis_dk, row_ids, col_ids, vals, *, ncols: int) -> torch.Tensor:
    """log1p + per-cell L2 normalisation + projection: the plain version
    of K1 (`random_projection._project_block_normed` in the JAX package)."""
    lv = torch.log1p(vals.float())
    sq = torch.zeros(ncols, dtype=torch.float32, device=lv.device)
    sq.index_add_(0, col_ids.long(), lv * lv)
    norm = torch.clamp(torch.sqrt(sq), min=1e-8)
    return project_block(basis_dk, row_ids, col_ids, lv, ncols=ncols) / norm[:, None]


def collapse_block(
    row_ids: torch.Tensor,
    col_ids: torch.Tensor,
    vals: torch.Tensor,
    seg_of_col: torch.Tensor,  # [ncols] group of each local cell; >= num_groups drops it
    *,
    num_genes: int,
    num_groups: int,
) -> torch.Tensor:
    """[num_genes, num_groups] sums: out[gene, seg_of_col[cell]] += val."""
    seg = seg_of_col.long()[col_ids.long()]
    keep = seg < num_groups
    flat = row_ids.long()[keep] * num_groups + seg[keep]
    out = torch.zeros(num_genes * num_groups, dtype=torch.float32, device=vals.device)
    out.index_add_(0, flat, vals.float()[keep])
    return out.view(num_genes, num_groups)


def densify_block(
    row_ids: torch.Tensor, col_ids: torch.Tensor, vals: torch.Tensor, *, ncols: int, num_genes: int
) -> torch.Tensor:
    """Dense [ncols, num_genes] slab (cells as rows)."""
    out = torch.zeros(ncols, num_genes, dtype=torch.float32, device=vals.device)
    out.index_put_((col_ids.long(), row_ids.long()), vals.float(), accumulate=True)
    return out


def block_col_sums(col_ids: torch.Tensor, vals: torch.Tensor, *, ncols: int) -> torch.Tensor:
    """Per-cell library sizes of a block [ncols], summed in a fixed order."""
    out = torch.zeros(ncols, dtype=torch.float32, device=vals.device)
    return segment_add(out, 0, col_ids.long(), vals.float())


def block_row_stats(row_ids: torch.Tensor, vals: torch.Tensor, *, num_genes: int):
    """Per-gene (sum, sum of squares, nnz count) of a block, summed in a
    fixed order (`segment_add`)."""
    r = row_ids.long()
    v = vals.float()
    z = lambda: torch.zeros(num_genes, dtype=torch.float32, device=v.device)  # noqa: E731
    return (
        segment_add(z(), 0, r, v),
        segment_add(z(), 0, r, v * v),
        segment_add(z(), 0, r, (v != 0).float()),
    )
