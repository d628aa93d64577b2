"""SparseIoVec: a vertical stack of backends presented as one
(features x all-cells) matrix, with the batch registry the collapse
layer needs (the port's copy of the JAX package's `data/vec.py`,
without the multi-host helpers), and `read_data_on_shared_rows`, which
stacks backends whose feature rows differ."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from .sparse_io import SparseBackend


def read_data_on_shared_rows(backends, *, mode: str = "union") -> "SparseIoVec":
    """Stack backends whose feature rows differ, aligned on the union
    (or, with `mode="intersection"`, the intersection) of row names
    (`auxiliary-data/src/data_loading.rs:95` equivalent). Each backend
    is read once into a row-remapped in-memory copy; features it lacks
    read as zeros."""
    from .sparse_io import MemoryBackend

    all_names = [b.row_names() for b in backends]
    if mode == "union":
        shared: list[str] = []
        seen = set()
        for names in all_names:
            for nm in names:
                if nm not in seen:
                    seen.add(nm)
                    shared.append(nm)
    else:
        inter = set(all_names[0])
        for names in all_names[1:]:
            inter &= set(names)
        shared = [nm for nm in all_names[0] if nm in inter]

    pos = {nm: i for i, nm in enumerate(shared)}
    vec = SparseIoVec()
    for b, names in zip(backends, all_names):
        coo = b.read_columns_csc(np.arange(b.num_columns)).tocoo()
        row_map = np.asarray([pos.get(nm, -1) for nm in names], dtype=np.int64)
        ok = row_map[coo.row] >= 0
        remapped = sp.coo_matrix(
            (coo.data[ok], (row_map[coo.row[ok]], coo.col[ok])),
            shape=(len(shared), b.num_columns),
        ).tocsc()
        vec.push(MemoryBackend(remapped, shared, b.column_names()))
    return vec


class SparseIoVec:
    def __init__(self):
        self._backends: list[SparseBackend] = []
        self._offsets: list[int] = [0]
        self._row_names: list[str] | None = None
        self._batch_membership: np.ndarray | None = None
        self._batch_names: list[str] | None = None

    def push(self, backend: SparseBackend):
        """Append a backend; its feature rows must match the stack's."""
        names = backend.row_names()
        if self._row_names is None:
            self._row_names = names
        elif names != self._row_names:
            raise ValueError("backend feature rows disagree with the stack; align/reorder first")
        self._backends.append(backend)
        self._offsets.append(self._offsets[-1] + backend.num_columns)

    @property
    def num_rows(self) -> int:
        return self._backends[0].num_rows if self._backends else 0

    @property
    def num_columns(self) -> int:
        return self._offsets[-1]

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    def row_names(self) -> list[str]:
        return list(self._row_names or [])

    def column_names(self) -> list[str]:
        dup = len(self._backends) > 1
        out: list[str] = []
        for i, b in enumerate(self._backends):
            out.extend(f"{n}@{i}" if dup else n for n in b.column_names())
        return out

    def read_columns_csc(self, columns: Sequence[int] | np.ndarray) -> sp.csc_matrix:
        cols = np.asarray(columns, dtype=np.int64)
        if len(self._backends) == 1:
            return self._backends[0].read_columns_csc(cols)
        which = np.searchsorted(self._offsets, cols, side="right") - 1
        pieces, order = [], []
        for b_idx in range(len(self._backends)):
            m = which == b_idx
            if not m.any():
                continue
            pieces.append(self._backends[b_idx].read_columns_csc(cols[m] - self._offsets[b_idx]))
            order.append(np.nonzero(m)[0])
        stacked = sp.hstack(pieces, format="csc")
        perm = np.concatenate(order)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        return stacked[:, inv]

    def register_batches(self, membership: Sequence[str] | np.ndarray):
        memb = np.asarray(membership)
        if len(memb) != self.num_columns:
            raise ValueError("batch membership length != total cells")
        names, codes = np.unique(memb, return_inverse=True)
        self._batch_names = [str(x) for x in names]
        self._batch_membership = codes.astype(np.int32)

    @property
    def num_batches(self) -> int:
        return len(self._batch_names) if self._batch_names else 1

    def batch_membership(self) -> np.ndarray:
        if self._batch_membership is None:
            return np.zeros(self.num_columns, dtype=np.int32)
        return self._batch_membership

    def batch_names(self) -> list[str]:
        return list(self._batch_names or ["0"])

    def subset_columns(self, keep: np.ndarray) -> "ColumnSubsetVec":
        """View over the kept columns (the QC keep mask)."""
        return ColumnSubsetVec(self, np.asarray(keep))


class ColumnSubsetVec:
    """Column-subset view of a `SparseIoVec`: the keep mask (bool) or
    column indices apply at read time, and nothing is rewritten."""

    def __init__(self, base, keep: np.ndarray):
        keep = np.asarray(keep)
        self._idx = (np.nonzero(keep)[0] if keep.dtype == bool else keep).astype(np.int64)
        self._base = base

    @property
    def num_rows(self) -> int:
        return self._base.num_rows

    @property
    def num_columns(self) -> int:
        return len(self._idx)

    def row_names(self):
        return self._base.row_names()

    def column_names(self):
        names = self._base.column_names()
        return [names[j] for j in self._idx]

    def read_columns_csc(self, columns) -> sp.csc_matrix:
        return self._base.read_columns_csc(self._idx[np.asarray(columns, np.int64)])

    @property
    def num_batches(self) -> int:
        return self._base.num_batches

    def batch_membership(self) -> np.ndarray:
        return self._base.batch_membership()[self._idx]

    def batch_names(self):
        return self._base.batch_names()
