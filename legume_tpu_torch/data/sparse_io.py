"""Sparse count-matrix backends, read side (the port's own copy of the
JAX package's storage engine, reduced to what `senna topic` reads).

Matrix orientation: rows = features/genes (D), columns = cells (N).
`read_columns_csc(cols)` returns a scipy `csc_matrix` of shape
[D, len(cols)].

- ``MemoryBackend``: scipy CSC in RAM (simulations, tests, small runs).
- ``ZarrBackend``: the zarr v3 directory layout the JAX package writes
  (`by_column/{data, indices, indptr}`, `nrow`/`ncol`/`nnz`), read
  through tensorstore. Tensorstore is imported only when such a store is
  opened, so the compute path needs numpy, scipy and torch alone. Names
  come from the `{key}.names.txt` sidecar the writer keeps beside each
  string array.
"""

from __future__ import annotations

import abc
import json
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import scipy.sparse as sp


class SparseBackend(abc.ABC):
    """Column (cell) slabs as CSC, names and shape."""

    @property
    @abc.abstractmethod
    def num_rows(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_columns(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_nonzeros(self) -> int: ...

    @abc.abstractmethod
    def read_columns_csc(self, columns: Sequence[int] | np.ndarray) -> sp.csc_matrix:
        """[D, len(columns)] CSC slab."""

    @abc.abstractmethod
    def row_names(self) -> list[str]: ...

    @abc.abstractmethod
    def column_names(self) -> list[str]: ...

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_columns)


class MemoryBackend(SparseBackend):
    """In-memory backend over a scipy CSC matrix."""

    def __init__(self, csc: sp.csc_matrix, row_names=None, column_names=None):
        self._csc = sp.csc_matrix(csc)
        d, n = self._csc.shape
        self._row_names = list(row_names) if row_names else [f"r{i}" for i in range(d)]
        self._col_names = list(column_names) if column_names else [f"c{j}" for j in range(n)]

    @property
    def num_rows(self):
        return self._csc.shape[0]

    @property
    def num_columns(self):
        return self._csc.shape[1]

    @property
    def num_nonzeros(self):
        return int(self._csc.nnz)

    def read_columns_csc(self, columns):
        cols = np.asarray(columns, dtype=np.int64)
        if len(cols) and cols[-1] - cols[0] == len(cols) - 1 and np.all(np.diff(cols) == 1):
            # a contiguous range slices the CSC arrays without a gather
            return self._csc[:, int(cols[0]) : int(cols[-1]) + 1]
        return self._csc[:, cols]

    def row_names(self):
        return self._row_names

    def column_names(self):
        return self._col_names


class ZarrBackend(SparseBackend):
    """Zarr v3 directory store written by the JAX package (read only)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._col_indptr: np.ndarray | None = None
        self._shape: tuple[int, int, int] | None = None

    def _read_array(self, key: str, lb: int = 0, ub: int | None = None) -> np.ndarray:
        import tensorstore as ts

        spec = {
            "driver": "zarr3",
            "kvstore": {"driver": "file", "path": os.path.join(self.path, key)},
        }
        store = ts.open(spec).result()
        if ub is None:
            return np.asarray(store[...].read().result())
        return np.asarray(store[lb:ub].read().result())

    def _load_shape(self):
        if self._shape is None:
            meta = Path(self.path) / "zarr.json"
            attrs = json.loads(meta.read_text()).get("attributes", {}) if meta.exists() else {}
            if all(k in attrs for k in ("nrow", "ncol", "nnz")):
                self._shape = (int(attrs["nrow"]), int(attrs["ncol"]), int(attrs["nnz"]))
            else:
                self._shape = tuple(int(self._read_array(k)[0]) for k in ("nrow", "ncol", "nnz"))
        return self._shape

    @property
    def num_rows(self):
        return self._load_shape()[0]

    @property
    def num_columns(self):
        return self._load_shape()[1]

    @property
    def num_nonzeros(self):
        return self._load_shape()[2]

    def _column_indptr(self) -> np.ndarray:
        if self._col_indptr is None:
            self._col_indptr = self._read_array("by_column/indptr").astype(np.int64)
        return self._col_indptr

    def read_columns_csc(self, columns):
        idx = np.asarray(columns, dtype=np.int64)
        indptr = self._column_indptr()
        starts, ends = indptr[idx], indptr[idx + 1]
        out_ptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(ends - starts, out=out_ptr[1:])
        data = np.empty(int(out_ptr[-1]), np.float32)
        indices = np.empty(int(out_ptr[-1]), np.int64)
        i = 0
        while i < len(idx):  # one ranged read per contiguous run of columns
            j = i
            while j + 1 < len(idx) and starts[j + 1] == ends[j]:
                j += 1
            lb, ub = int(starts[i]), int(ends[j])
            if ub > lb:
                o = int(out_ptr[i])
                data[o : o + ub - lb] = self._read_array("by_column/data", lb, ub)
                indices[o : o + ub - lb] = self._read_array("by_column/indices", lb, ub)
            i = j + 1
        return sp.csc_matrix((data, indices, out_ptr), shape=(self.num_rows, len(idx)))

    def _names(self, key: str, n: int, prefix: str) -> list[str]:
        p = Path(self.path) / f"{key}.names.txt"
        if p.exists():
            return p.read_text().rstrip("\n").split("\n")
        return [f"{prefix}{i}" for i in range(n)]

    def row_names(self):
        return self._names("row_names", self.num_rows, "r")

    def column_names(self):
        return self._names("column_names", self.num_columns, "c")


def open_sparse_matrix(path: str | os.PathLike) -> SparseBackend:
    """Open an existing zarr backend directory."""
    path = str(path)
    if not Path(path).exists():
        raise FileNotFoundError(path)
    if path.endswith((".h5", ".hdf5", ".zip")):
        raise NotImplementedError(f"{path}: the port reads zarr directory stores only")
    return ZarrBackend(path)
