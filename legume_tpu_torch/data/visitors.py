"""Streaming column-block visitors (the port's copy of the JAX
package's `data/visitors.py`).

A block is a column-sorted COO slab: row ids and values in CSC order,
with per-cell entry counts. The port hands the device the exclusive scan
of those counts (`col_ptr`), which is what the CUDA kernels walk; the
plain torch versions expand it to per-entry cell ids. There is no
padding: each block is exactly its nonzeros.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np
import scipy.sparse as sp


class CooBlock:
    """A COO slab of `ncols` cells starting at global column `lb`."""

    __slots__ = ("lb", "ncols", "row_ids", "vals", "col_counts")

    def __init__(self, lb, ncols, row_ids, vals, col_counts):
        self.lb = lb  # global column offset of this block
        self.ncols = ncols  # cells in this block
        self.row_ids = row_ids  # int32 [nnz] gene ids, column-sorted
        self.vals = vals  # float32 [nnz]
        self.col_counts = col_counts  # int32 [ncols] entries per cell

    @property
    def col_ids(self) -> np.ndarray:
        """int32 [nnz] local cell id of each entry."""
        return np.repeat(np.arange(self.ncols, dtype=np.int32), self.col_counts)

    @property
    def col_ptr(self) -> np.ndarray:
        """int32 [ncols + 1] exclusive scan of `col_counts`."""
        out = np.zeros(self.ncols + 1, np.int32)
        np.cumsum(self.col_counts, out=out[1:])
        return out

    @property
    def nnz(self) -> int:
        return len(self.row_ids)


def csc_to_coo_block(csc: sp.csc_matrix, lb: int = 0) -> CooBlock:
    """Pack a [D, B] CSC slab into a COO block (CSC indices are the row
    ids; the column side rides as per-cell counts)."""
    if not sp.issparse(csc) or csc.format != "csc":
        csc = sp.csc_matrix(csc)
    return CooBlock(
        lb=lb,
        ncols=csc.shape[1],
        row_ids=csc.indices.astype(np.int32, copy=False),
        vals=csc.data.astype(np.float32, copy=False),
        col_counts=np.diff(csc.indptr).astype(np.int32),
    )


def visit_columns_by_block(
    data, block_size: int = 8192, *, prefetch: int = 2
) -> Iterator[CooBlock]:
    """Yield column blocks in order, reading the next ones on host
    threads while the caller works on the current one."""
    n = data.num_columns
    jobs = [(lb, min(lb + block_size, n)) for lb in range(0, n, block_size)]

    def load(job):
        lb, ub = job
        return csc_to_coo_block(data.read_columns_csc(np.arange(lb, ub)), lb=lb)

    with cf.ThreadPoolExecutor(max_workers=max(prefetch, 1)) as pool:
        pending = [pool.submit(load, j) for j in jobs[:prefetch]]
        next_job = prefetch
        for _ in range(len(jobs)):
            fut = pending.pop(0)
            if next_job < len(jobs):
                pending.append(pool.submit(load, jobs[next_job]))
                next_job += 1
            yield fut.result()
