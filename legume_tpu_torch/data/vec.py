"""SparseIoVec: a vertical stack of backends presented as one
(features x all-cells) matrix, with the batch registry the collapse
layer needs (the port's copy of the JAX package's `data/vec.py`,
without the multi-host helpers)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from .sparse_io import SparseBackend


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
