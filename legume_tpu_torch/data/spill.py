"""Bounded-memory triplet ingestion: external sort by column (the port's
copy of the JAX package's `data/spill.py`).

The reference's builders stream unordered triplets into a CSC backend
via slab appends + a two-pass on-disk CSR rebuild
(`data-beans/src/sparse_io/traits.rs:680-843`). Here the same contract
is an external column-sort:

1. `add(rows, cols, vals)` — each chunk is sorted by column and
   spilled to `.npy` files; resident memory is one chunk.
2. `iter_column_slabs(slab_cols)` — k-way merge by memory-mapping the
   spilled chunks and gathering each column range with two
   `searchsorted` probes per chunk, yielding CSC slabs that feed
   `StreamingCscWriter.append` (which then rebuilds CSR gene-chunked).

`peak_resident_nnz` records the largest number of nonzeros ever held
in RAM at once — the bounded-memory contract tests assert on it.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import scipy.sparse as sp


class TripletSpillSorter:
    def __init__(self, spill_dir: str, *, n_rows: int = 0, chunk_nnz: int = 1 << 22):
        self.dir = Path(spill_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_rows = int(n_rows)  # may be set later, before iteration
        self.chunk_nnz = int(chunk_nnz)
        self._n_chunks = 0
        self._pend_r: list[np.ndarray] = []
        self._pend_c: list[np.ndarray] = []
        self._pend_v: list[np.ndarray] = []
        self._pend_nnz = 0
        self.total_nnz = 0
        self.max_col = -1
        self.peak_resident_nnz = 0

    def add(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if len(rows):
            self.max_col = max(self.max_col, int(cols.max()))
        self._pend_r.append(rows)
        self._pend_c.append(cols)
        self._pend_v.append(vals)
        self._pend_nnz += len(rows)
        self.total_nnz += len(rows)
        if self._pend_nnz >= self.chunk_nnz:
            self._flush()

    def _flush(self):
        if self._pend_nnz == 0:
            return
        r = np.concatenate(self._pend_r)
        c = np.concatenate(self._pend_c)
        v = np.concatenate(self._pend_v)
        self.peak_resident_nnz = max(self.peak_resident_nnz, len(r))
        order = np.argsort(c, kind="stable")
        i = self._n_chunks
        np.save(self.dir / f"r{i}.npy", r[order])
        np.save(self.dir / f"c{i}.npy", c[order])
        np.save(self.dir / f"v{i}.npy", v[order])
        self._n_chunks += 1
        self._pend_r, self._pend_c, self._pend_v = [], [], []
        self._pend_nnz = 0

    def iter_column_slabs(self, slab_cols: int, *, n_cols: int | None = None):
        """Yield (lb, csc_slab [n_rows, ub-lb]) in column order, holding
        only one slab's nonzeros in RAM."""
        self._flush()
        n_cols = (self.max_col + 1) if n_cols is None else int(n_cols)
        # per-chunk cursor into the column-sorted files; mmaps open only
        # for the duration of one probe so the cap on resident memory
        # extends to ADDRESS SPACE too (RLIMIT_AS counts open maps)
        cursors = np.zeros(self._n_chunks, np.int64)
        for lb in range(0, max(n_cols, 1), slab_cols):
            ub = min(lb + slab_cols, n_cols)
            rs, cs, vs = [], [], []
            for i in range(self._n_chunks):
                c = np.load(self.dir / f"c{i}.npy", mmap_mode="r")
                a = int(cursors[i])
                b = int(np.searchsorted(c[a:], ub, side="left")) + a
                cursors[i] = b
                if b > a:
                    cs.append(np.asarray(c[a:b]) - lb)
                    del c
                    r = np.load(self.dir / f"r{i}.npy", mmap_mode="r")
                    rs.append(np.asarray(r[a:b]))
                    del r
                    v = np.load(self.dir / f"v{i}.npy", mmap_mode="r")
                    vs.append(np.asarray(v[a:b]))
                    del v
                else:
                    del c
            if rs:
                rr = np.concatenate(rs)
                cc = np.concatenate(cs)
                vv = np.concatenate(vs)
                self.peak_resident_nnz = max(self.peak_resident_nnz, len(rr))
                slab = sp.coo_matrix(
                    (vv, (rr, cc)), shape=(self.n_rows, ub - lb)
                ).tocsc()
                slab.sum_duplicates()
            else:
                slab = sp.csc_matrix((self.n_rows, ub - lb), dtype=np.float32)
            yield lb, slab

    def cleanup(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def build_streaming_from_triplet_chunks(
    chunk_iter,
    output: str,
    *,
    n_rows: int,
    n_cols: int,
    row_names=None,
    column_names=None,
    chunk_nnz: int = 1 << 22,
    slab_cols: int = 16384,
):
    """Assemble a zarr backend from an iterator of (rows, cols, vals)
    triplet chunks with bounded memory; returns (backend, sorter) so
    callers can inspect `peak_resident_nnz`."""
    from .sparse_io import StreamingCscWriter

    sorter = TripletSpillSorter(
        str(output).rstrip("/") + ".sortspill", n_rows=n_rows, chunk_nnz=chunk_nnz
    )
    for rows, cols, vals in chunk_iter:
        sorter.add(rows, cols, vals)
    writer = StreamingCscWriter(str(output), n_rows, row_names=row_names)
    for _lb, slab in sorter.iter_column_slabs(slab_cols, n_cols=n_cols):
        writer.append(slab)
    backend = writer.finalize(column_names=column_names)
    sorter.cleanup()
    return backend, sorter
