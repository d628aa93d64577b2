"""Sparse count-matrix backends (the port's own copy of the JAX package's
storage engine, `data/sparse_io.py`).

On-disk layout, the same in both packages and both formats:

    (root)
        nrow, ncol, nnz                                 [1] uint64
        by_column/{data f32, indices u64, indptr u64}   # CSC
        by_row/{data f32, indices u64, indptr u64}      # CSR
        row_names, column_names                         string arrays

Matrix orientation: rows = features/genes (D), columns = cells (N).
`read_columns_csc(cols)` returns a scipy `csc_matrix` of shape
[D, len(cols)], `read_rows_csr(rows)` a `csr_matrix` [len(rows), N].
`StreamingCscWriter` builds a `.zarr` store from column slabs without
holding the matrix: slabs spill to disk, and `finalize()` writes each
array chunk by chunk as it fills.

- ``MemoryBackend``: scipy CSC in RAM (simulations, tests, small runs).
- ``ZarrBackend``: zarr v3 directory (zstd level 5), read and written by
  this module; column arrays up to 1 GiB are decoded whole on the first
  column read, larger ones read by chunk ranges; a `.zarr.zip` archive is
  extracted once beside itself and read as a directory.
- ``H5Backend``: HDF5 through h5py, chunks blosc-compressed by the
  system libblosc and moved with direct chunk reads and writes.

The optional libraries (pyarrow for zstd, h5py and libblosc for `.h5`)
are imported only on the paths that need them, so the compute path needs
numpy, scipy and torch alone. A store
written here is what the JAX package writes for the same matrix, and
each package reads the other's.
"""

from __future__ import annotations

import abc
import json
import logging
import os
import shutil
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
import scipy.sparse as sp

_log = logging.getLogger(__name__)

_CHUNK = 1 << 20  # elements per zarr chunk (the reference's MTX_STREAM_BLOCK)
_ZSTD_LEVEL = 5


# ----------------------------------------------------------------------------
# zarr v3 arrays: the package's own reader and writer
# ----------------------------------------------------------------------------
#
# Each 1-d array is a directory holding a `zarr.json` (regular chunk grid of
# `min(_CHUNK, max(n, 1))` elements, default chunk keys, codecs `bytes`
# little-endian then `zstd` level 5 without checksum, fill value 0) and its
# chunks at `c/{i}`. Every chunk is stored at the full chunk shape (the edge
# chunk padded with the fill value), and a chunk whose bytes all equal the
# fill value is not written, as tensorstore's zarr3 driver does: a missing
# chunk reads as the fill value. zstd is pyarrow's codec, which releases the
# GIL, so chunks are compressed and decoded on a pool of threads; the bytes
# of each chunk do not depend on which thread made them.

_THREADS = min(8, os.cpu_count() or 1)
_pool: ThreadPoolExecutor | None = None


def _chunk_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(_THREADS, thread_name_prefix="zarr-chunk")
    return _pool


def _zstd():
    """pyarrow's zstd codec (level 5), or ImportError."""
    try:
        import pyarrow as pa
    except ImportError as e:  # pragma: no cover - depends on the host
        raise ImportError(
            "zarr stores need zstd: install pyarrow, whose zstd codec this package uses "
            "(libzstd.so.1 through ctypes is not used)"
        ) from e
    if not pa.Codec.is_available("zstd"):  # pragma: no cover
        raise ImportError("this pyarrow has no zstd codec; zarr stores need it "
                          "(libzstd.so.1 through ctypes is not used)")
    return pa.Codec("zstd", compression_level=_ZSTD_LEVEL)


def _zarr_array_meta(n: int, dtype: np.dtype) -> dict:
    dtype = np.dtype(dtype)
    return {
        "chunk_grid": {"configuration": {"chunk_shape": [min(_CHUNK, max(int(n), 1))]},
                       "name": "regular"},
        "chunk_key_encoding": {"name": "default"},
        "codecs": [
            {"configuration": {"endian": "little"}, "name": "bytes"},
            {"configuration": {"checksum": False, "level": _ZSTD_LEVEL}, "name": "zstd"},
        ],
        "data_type": dtype.name,
        "fill_value": 0.0 if dtype.kind == "f" else 0,
        "node_type": "array",
        "shape": [int(n)],
        "zarr_format": 3,
    }


def _chunk_path(adir: Path, meta: dict, i: int) -> Path:
    """Chunk `i`'s file under the default chunk key encoding."""
    sep = meta.get("chunk_key_encoding", {}).get("configuration", {}).get("separator", "/")
    return adir / "c" / str(i) if sep == "/" else adir / f"c{sep}{i}"


def _store_chunk(adir: Path, meta: dict, i: int, raw: bytes):
    """Compress and write chunk `i` (full chunk shape), unless every byte
    is the fill value."""
    if raw.count(0) == len(raw):
        return
    target = _chunk_path(adir, meta, i)
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_bytes(_zstd().compress(raw, asbytes=True))


def _bounded_submit(pending: deque, fn, *args):
    """Queue `fn(*args)` on the chunk pool, holding at most two chunks a
    thread in flight (each holds one chunk's bytes)."""
    pending.append(_chunk_pool().submit(fn, *args))
    while len(pending) > 2 * _THREADS:
        pending.popleft().result()


def _drain(pending: deque):
    while pending:
        pending.popleft().result()


def write_zarr_array(path: str, key: str, arr: np.ndarray, dtype: str):
    """Write a 1-d array at `path/key`, replacing whatever was there."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.dtype(dtype).newbyteorder("<")))
    adir = Path(path) / key.lstrip("/")
    if adir.exists():
        shutil.rmtree(adir)
    adir.mkdir(parents=True)
    meta = _zarr_array_meta(len(arr), arr.dtype)
    (adir / "zarr.json").write_text(json.dumps(meta, sort_keys=True, separators=(",", ":")))
    chunk = meta["chunk_grid"]["configuration"]["chunk_shape"][0]
    if len(arr) == 0:
        return
    _zstd()  # fail before any chunk if there is no codec
    pending: deque[Future] = deque()
    for i, c0 in enumerate(range(0, len(arr), chunk)):
        block = arr[c0 : c0 + chunk]
        if len(block) < chunk:  # the edge chunk is stored at full shape
            block = np.concatenate([block, np.zeros(chunk - len(block), arr.dtype)])
        _bounded_submit(pending, _store_chunk, adir, meta, i, block.tobytes())
    _drain(pending)


class _ZarrChunkWriter:
    """A 1-d zarr v3 array of `n` elements written front to back: `write`
    takes the next elements, each chunk is compressed and stored as it
    fills (an all-fill chunk is not stored, the edge chunk is padded), so
    at most one chunk is held. The result is byte-equal to
    `write_zarr_array` of the whole array."""

    def __init__(self, path: str, key: str, n: int, dtype: str):
        self.dtype = np.dtype(dtype).newbyteorder("<")
        self.adir = Path(path) / key.lstrip("/")
        if self.adir.exists():
            shutil.rmtree(self.adir)
        self.adir.mkdir(parents=True)
        self.meta = _zarr_array_meta(n, self.dtype)
        (self.adir / "zarr.json").write_text(
            json.dumps(self.meta, sort_keys=True, separators=(",", ":")))
        self.n = int(n)
        self.chunk = self.meta["chunk_grid"]["configuration"]["chunk_shape"][0]
        self.buf = np.zeros(self.chunk, self.dtype)
        self.fill = 0  # elements of the current chunk written
        self.index = 0  # current chunk
        self.written = 0
        self.pending: deque[Future] = deque()
        if self.n:
            _zstd()  # fail before any chunk if there is no codec

    def write(self, arr: np.ndarray):
        arr = np.asarray(arr).astype(self.dtype, copy=False)
        if self.written + len(arr) > self.n:
            raise ValueError(f"{self.adir}: {self.written + len(arr)} elements for {self.n}")
        o = 0
        while o < len(arr):
            take = min(self.chunk - self.fill, len(arr) - o)
            self.buf[self.fill : self.fill + take] = arr[o : o + take]
            self.fill += take
            o += take
            if self.fill == self.chunk:
                self._flush()
        self.written += len(arr)

    def _flush(self):
        self.buf[self.fill :] = 0  # the edge chunk is stored at full shape
        _bounded_submit(self.pending, _store_chunk, self.adir, self.meta, self.index,
                        self.buf.tobytes())
        self.index += 1
        self.fill = 0

    def close(self):
        if self.written != self.n:
            raise ValueError(f"{self.adir}: {self.written} of {self.n} elements written")
        if self.fill:
            self._flush()
        _drain(self.pending)


class _ZarrArray:
    """A 1-d zarr v3 array opened for ranged reads."""

    def __init__(self, path: str, key: str):
        self.dir = Path(path) / key.lstrip("/")
        meta = json.loads((self.dir / "zarr.json").read_text())
        if meta.get("node_type") != "array" or len(meta["shape"]) != 1:
            raise ValueError(f"{self.dir}: not a 1-d zarr v3 array")
        if meta["chunk_grid"].get("name") != "regular":
            raise ValueError(f"{self.dir}: chunk grid {meta['chunk_grid'].get('name')!r}")
        self.meta = meta
        self.n = int(meta["shape"][0])
        self.chunk = int(meta["chunk_grid"]["configuration"]["chunk_shape"][0])
        endian = "<"
        self.zstd = False
        for c in meta.get("codecs", []):
            name = c["name"] if isinstance(c, dict) else str(c)
            if name == "bytes":
                endian = ">" if c.get("configuration", {}).get("endian") == "big" else "<"
            elif name == "zstd":
                self.zstd = True
            else:
                raise ValueError(f"{self.dir}: codec {name!r} is not supported")
        self.dtype = np.dtype(meta["data_type"]).newbyteorder(endian)
        self.fill = np.asarray(meta.get("fill_value", 0) or 0).astype(self.dtype)

    def decode(self, i: int) -> np.ndarray:
        """Chunk `i` at full chunk shape."""
        p = _chunk_path(self.dir, self.meta, i)
        if not p.exists():
            return np.full(self.chunk, self.fill, self.dtype)
        raw = p.read_bytes()
        nbytes = self.chunk * self.dtype.itemsize
        if self.zstd:
            raw = _zstd().decompress(raw, decompressed_size=nbytes, asbytes=True)
        if len(raw) != nbytes:
            raise ValueError(f"{p}: {len(raw)} bytes, expected {nbytes}")
        return np.frombuffer(raw, self.dtype)


    def read(self, lb: int = 0, ub: int | None = None) -> np.ndarray:
        """Elements [lb, ub), decoding only the chunks that cover them, each
        into its place in the output (several at a time on the chunk pool)."""
        lo, hi = int(lb), self.n if ub is None else min(int(ub), self.n)
        out = np.empty(max(hi - lo, 0), self.dtype.newbyteorder("="))

        def put(i):
            c0 = i * self.chunk
            s0, s1 = max(lo, c0), min(hi, c0 + self.chunk)
            out[s0 - lo : s1 - lo] = self.decode(i)[s0 - c0 : s1 - c0]

        chunks = range(lo // self.chunk, -(-hi // self.chunk) if hi > lo else 0)
        if len(chunks) > 1:
            list(_chunk_pool().map(put, chunks))
        else:
            for i in chunks:
                put(i)
        return out


def write_zarr_group_metadata(path: str, attributes: dict | None = None, *, key: str = ""):
    """Zarr v3 group metadata (`zarr.json`) at `path/key`; the root group
    carries the shape attributes the reference engine reads."""
    doc: dict = {"zarr_format": 3, "node_type": "group"}
    if attributes:
        doc["attributes"] = attributes
    target = Path(path) / key.lstrip("/") / "zarr.json" if key else Path(path) / "zarr.json"
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(doc, indent=1))


def read_zarr_group_attributes(path: str, key: str = "") -> dict | None:
    target = Path(path) / key.lstrip("/") / "zarr.json" if key else Path(path) / "zarr.json"
    if not target.exists():
        return None
    try:
        doc = json.loads(target.read_text())
    except Exception:
        return None
    if doc.get("node_type") != "group":
        return None
    return doc.get("attributes", {})


def _names_path(path: str, key: str) -> Path:
    return Path(path) / f"{key}.names.txt"


# ----------------------------------------------------------------------------
# Backend interface
# ----------------------------------------------------------------------------


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

    def read_rows_csr(self, rows: Sequence[int] | np.ndarray) -> sp.csr_matrix:
        """[len(rows), N] CSR slab."""
        raise NotImplementedError(f"{type(self).__name__} has no row reads")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_columns)

    def read_columns_dense(self, columns) -> np.ndarray:
        return np.asarray(self.read_columns_csc(columns).todense())

    def read_column_range_csc(self, lb: int, ub: int) -> sp.csc_matrix:
        return self.read_columns_csc(np.arange(lb, ub))

    def column_block_sizes(self, block_size: int) -> list[tuple[int, int]]:
        """Half-open [lb, ub) column blocks of `block_size`."""
        n = self.num_columns
        return [(lb, min(lb + block_size, n)) for lb in range(0, n, block_size)]

    def column_nnz(self) -> np.ndarray | None:
        """Per-column nonzero counts where they are cheap, else None."""
        return None


def _take_columns(csc: sp.csc_matrix, columns) -> sp.csc_matrix:
    cols = np.asarray(columns, dtype=np.int64)
    if len(cols) and cols[-1] - cols[0] == len(cols) - 1 and np.all(np.diff(cols) == 1):
        # a contiguous range slices the CSC arrays without a gather
        return csc[:, int(cols[0]) : int(cols[-1]) + 1]
    return csc[:, cols]


class MemoryBackend(SparseBackend):
    """In-memory backend over a scipy CSC matrix."""

    def __init__(self, csc: sp.csc_matrix, row_names=None, column_names=None):
        self._csc = sp.csc_matrix(csc)
        self._csr: sp.csr_matrix | None = None
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
        return _take_columns(self._csc, columns)

    def read_rows_csr(self, rows):
        if self._csr is None:
            self._csr = self._csc.tocsr()
        return self._csr[np.asarray(rows, dtype=np.int64), :]

    def column_nnz(self):
        return np.diff(self._csc.indptr).astype(np.int64)

    def row_names(self):
        return self._row_names

    def column_names(self):
        return self._col_names

    def register_row_names(self, names):
        assert len(names) == self.num_rows
        self._row_names = list(names)

    def register_column_names(self, names):
        assert len(names) == self.num_columns
        self._col_names = list(names)


class _CompressedFileBackend(SparseBackend):
    """On-disk CSC + CSR copies: the column indptr is cached on first
    use; data and indices are read per contiguous run of columns."""

    def __init__(self, path: str):
        self.path = str(path)
        self._col_indptr: np.ndarray | None = None
        self._row_indptr: np.ndarray | None = None
        self._shape: tuple[int, int, int] | None = None

    @abc.abstractmethod
    def _read_array(self, key: str, lb: int = 0, ub: int | None = None) -> np.ndarray: ...

    @abc.abstractmethod
    def _write_array(self, key: str, arr: np.ndarray, dtype: str): ...

    @abc.abstractmethod
    def _read_name_list(self, key: str) -> list[str] | None: ...

    @abc.abstractmethod
    def _write_name_list(self, key: str, names: Sequence[str]): ...

    def _write_shape_metadata(self, d: int, n: int, nnz: int):
        """Format-specific shape records beyond the size arrays."""

    def _read_shape_metadata(self) -> tuple[int, int, int] | None:
        return None

    # -- writing ----------------------------------------------------------

    def record_csc(self, csc: sp.csc_matrix):
        """Write every array of the layout from one CSC matrix."""
        csc = csc.tocsc()
        csc.sum_duplicates()
        csr = csc.tocsr()
        d, n = csc.shape
        self._write_array("nrow", np.asarray([d], dtype=np.uint64), "uint64")
        self._write_array("ncol", np.asarray([n], dtype=np.uint64), "uint64")
        self._write_array("nnz", np.asarray([csc.nnz], dtype=np.uint64), "uint64")
        for axis, m in (("by_column", csc), ("by_row", csr)):
            self._write_array(f"{axis}/data", m.data.astype(np.float32), "float32")
            self._write_array(f"{axis}/indices", m.indices.astype(np.uint64), "uint64")
            self._write_array(f"{axis}/indptr", m.indptr.astype(np.uint64), "uint64")
        self._write_shape_metadata(d, n, int(csc.nnz))
        self._shape = (d, n, int(csc.nnz))
        self._col_indptr = csc.indptr.astype(np.int64)
        self._row_indptr = csr.indptr.astype(np.int64)

    def register_row_names(self, names):
        assert len(names) == self.num_rows, "row name length mismatch"
        self._write_name_list("row_names", names)

    def register_column_names(self, names):
        assert len(names) == self.num_columns, "column name length mismatch"
        self._write_name_list("column_names", names)

    # -- reading ----------------------------------------------------------

    def _load_shape(self):
        if self._shape is None:
            # the shape records first (the only place a store written by
            # the reference engine keeps its shape), then the size arrays
            shape = self._read_shape_metadata()
            if shape is None:
                shape = tuple(int(self._read_array(k)[0]) for k in ("nrow", "ncol", "nnz"))
            self._shape = shape
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

    def _row_indptr_vec(self) -> np.ndarray:
        if self._row_indptr is None:
            self._row_indptr = self._read_array("by_row/indptr").astype(np.int64)
        return self._row_indptr

    def column_nnz(self):
        return np.diff(self._column_indptr()).astype(np.int64)

    def _read_slabs(self, axis: str, indptr: np.ndarray, idx: np.ndarray):
        """(data, indices, out_indptr) of the slots `idx` of one
        orientation, one ranged read per contiguous run of slots."""
        starts, ends = indptr[idx], indptr[idx + 1]
        out_ptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(ends - starts, out=out_ptr[1:])
        data = np.empty(int(out_ptr[-1]), np.float32)
        indices = np.empty(int(out_ptr[-1]), np.int64)
        i = 0
        while i < len(idx):
            j = i
            while j + 1 < len(idx) and starts[j + 1] == ends[j]:
                j += 1
            lb, ub = int(starts[i]), int(ends[j])
            if ub > lb:
                o = int(out_ptr[i])
                data[o : o + ub - lb] = self._read_array(f"{axis}/data", lb, ub)
                indices[o : o + ub - lb] = self._read_array(f"{axis}/indices", lb, ub)
            i = j + 1
        return data, indices, out_ptr

    def read_columns_csc(self, columns):
        idx = np.asarray(columns, dtype=np.int64)
        data, indices, ptr = self._read_slabs("by_column", self._column_indptr(), idx)
        return sp.csc_matrix((data, indices, ptr), shape=(self.num_rows, len(idx)))

    def read_rows_csr(self, rows):
        idx = np.asarray(rows, dtype=np.int64)
        data, indices, ptr = self._read_slabs("by_row", self._row_indptr_vec(), idx)
        return sp.csr_matrix((data, indices, ptr), shape=(len(idx), self.num_columns))

    def _names(self, key: str, n: int, prefix: str) -> list[str]:
        names = self._read_name_list(key)
        if names is None:
            _log.warning("%s: no %s registered; using placeholders", self.path, key)
            return [f"{prefix}{i}" for i in range(n)]
        return names

    def row_names(self):
        return self._names("row_names", self.num_rows, "r")

    def column_names(self):
        return self._names("column_names", self.num_columns, "c")


class ZarrBackend(_CompressedFileBackend):
    """Zarr v3 directory store (this module's reader and writer; numpy
    and pyarrow only). Names are zarr v3 string arrays at `row_names` /
    `column_names` with a `{key}.names.txt` mirror beside each; reading
    takes the string array first, then the mirror."""

    WHOLE_BYTES = 1 << 30  # a column array up to this size is decoded whole, once

    def __init__(self, path: str):
        import threading

        super().__init__(path)
        self._arrays: dict[str, _ZarrArray] = {}
        self._mats: dict[str, sp.spmatrix] = {}  # "by_column" CSC / "by_row" CSR
        self._csc_lock = threading.Lock()

    def _array(self, key: str) -> _ZarrArray:
        arr = self._arrays.get(key)
        if arr is None:
            arr = self._arrays[key] = _ZarrArray(self.path, key)
        return arr

    def _read_array(self, key, lb=0, ub=None):
        return self._array(key).read(lb, ub)

    def _whole(self, axis: str):
        """One orientation's arrays decoded whole (once), where each fits in
        WHOLE_BYTES: reads are then slices and gathers in memory."""
        if axis not in self._mats:
            arrays = [self._array(f"{axis}/{k}") for k in ("data", "indices")]
            if max(a.n * a.dtype.itemsize for a in arrays) > self.WHOLE_BYTES:
                return None
            with self._csc_lock:
                if axis not in self._mats:
                    data, indices = (a.read() for a in arrays)
                    # uint64 indices below 2^63: reinterpreted, not copied
                    args = (data.astype(np.float32, copy=False),
                            indices.view(np.int64) if indices.dtype == np.uint64
                            else indices.astype(np.int64, copy=False))
                    self._mats[axis] = (
                        sp.csc_matrix((*args, self._column_indptr()), shape=self.shape)
                        if axis == "by_column" else
                        sp.csr_matrix((*args, self._row_indptr_vec()), shape=self.shape))
        return self._mats[axis]

    def read_columns_csc(self, columns):
        """Columns from the arrays decoded whole where they fit in
        WHOLE_BYTES (scattered reads, such as the matched-neighbour
        statistics', are then in-memory gathers); else one ranged read per
        run of columns."""
        whole = self._whole("by_column")
        if whole is not None:
            return _take_columns(whole, columns)
        return super().read_columns_csc(columns)

    def read_rows_csr(self, rows):
        """Rows from the row arrays decoded whole where they fit in
        WHOLE_BYTES, else one ranged read per run of rows."""
        whole = self._whole("by_row")
        if whole is not None:
            return whole[np.asarray(rows, dtype=np.int64), :]
        return super().read_rows_csr(rows)

    def _write_array(self, key, arr, dtype):
        write_zarr_array(self.path, key, arr, dtype)
        self._arrays.pop(key, None)
        self._mats.clear()

    def _read_name_list(self, key):
        from .zarr_strings import read_string_array

        names = read_string_array(self.path, key)
        if names is not None:
            return names
        p = _names_path(self.path, key)
        return p.read_text().rstrip("\n").split("\n") if p.exists() else None

    def _write_name_list(self, key, names):
        from .zarr_strings import write_string_array

        write_string_array(self.path, key, [str(n) for n in names])
        _names_path(self.path, key).write_text("\n".join(str(n) for n in names) + "\n")

    def _write_shape_metadata(self, d, n, nnz):
        write_zarr_group_metadata(self.path, {"nrow": int(d), "ncol": int(n), "nnz": int(nnz)})
        write_zarr_group_metadata(self.path, key="by_column")
        write_zarr_group_metadata(self.path, key="by_row")

    def _read_shape_metadata(self):
        attrs = read_zarr_group_attributes(self.path)
        if attrs and all(k in attrs for k in ("nrow", "ncol", "nnz")):
            return (int(attrs["nrow"]), int(attrs["ncol"]), int(attrs["nnz"]))
        return None


class H5Backend(_CompressedFileBackend):
    """HDF5 through h5py, as the reference engine writes it: datasets
    chunked ~1 MiB (at least 8,192 elements, at most the dataset) and
    compressed with the standard blosc filter (id 32001; blosclz, clevel
    5, byte shuffle). libhdf5 here has no blosc plugin, so the chunks go
    through the system libblosc (`data/blosc_codec.py`) and
    `write_direct_chunk` / `read_direct_chunk`. Without libblosc the
    writer falls back to gzip. The shape lives in root attributes."""

    def _file(self, mode="r"):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{self.path}: .h5 stores need h5py, which is not installed "
                              "(.zarr and .zarr.zip stores need only pyarrow)") from e
        return h5py.File(self.path, mode)

    @staticmethod
    def _chunk_elems(nelem: int, elem_bytes: int) -> int:
        return min(max((1024 * 1024) // max(elem_bytes, 1), 8192), max(nelem, 1))

    @staticmethod
    def _blosc_filter_index(ds) -> int | None:
        from . import blosc_codec

        plist = ds.id.get_create_plist()
        for i in range(plist.get_nfilters()):
            if plist.get_filter(i)[0] == blosc_codec.BLOSC_H5_FILTER_ID:
                return i
        return None

    def _read_array(self, key, lb=0, ub=None):
        from . import blosc_codec

        with self._file("r") as f:
            ds = f[key]
            fi = self._blosc_filter_index(ds)
            if fi is None or ds.chunks is None:
                return np.asarray(ds[...] if ub is None else ds[lb:ub])
            n = ds.shape[0]
            lo, hi = int(lb), n if ub is None else min(int(ub), n)
            if hi <= lo:
                return np.empty(0, dtype=ds.dtype)
            chunk = int(ds.chunks[0])
            out = np.empty(hi - lo, dtype=ds.dtype)
            for c0 in range((lo // chunk) * chunk, hi, chunk):
                mask, raw = ds.id.read_direct_chunk((c0,))
                if mask & (1 << fi):  # the filter was skipped for this chunk
                    buf = np.frombuffer(raw, dtype=ds.dtype)
                else:
                    buf = np.frombuffer(blosc_codec.decompress(raw), dtype=ds.dtype)
                # an edge chunk decodes to the full chunk (HDF5 pads it
                # before filtering); keep its valid part
                s0, s1 = max(lo, c0), min(hi, c0 + min(chunk, n - c0))
                out[s0 - lo : s1 - lo] = buf[s0 - c0 : s1 - c0]
            return out

    def _write_array(self, key, arr, dtype):
        import h5py

        from . import blosc_codec

        arr = np.asarray(arr)
        with self._file("a") as f:
            if key in f:
                del f[key]
            if not blosc_codec.available():
                f.create_dataset(key, data=arr, compression="gzip", compression_opts=4,
                                 chunks=(min(_CHUNK, max(len(arr), 1)),))
                return
            grp_path, _, name = key.rpartition("/")
            grp = f.require_group(grp_path) if grp_path else f["/"]
            n, itemsize = len(arr), arr.dtype.itemsize
            chunk = self._chunk_elems(n, itemsize)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((chunk,))
            cd = (blosc_codec.FILTER_BLOSC_VERSION, blosc_codec.BLOSC_VERSION_FORMAT, itemsize,
                  chunk * itemsize, blosc_codec.CLEVEL, blosc_codec.SHUFFLE_BYTE,
                  blosc_codec.COMPCODE_BLOSCLZ)
            dcpl.set_filter(blosc_codec.BLOSC_H5_FILTER_ID, h5py.h5z.FLAG_OPTIONAL, cd)
            space = h5py.h5s.create_simple((n,))
            tid = h5py.h5t.py_create(arr.dtype, logical=True)
            ds = h5py.Dataset(h5py.h5d.create(grp.id, name.encode(), tid, space, dcpl=dcpl))
            for c0 in range(0, n, chunk):
                block = arr[c0 : c0 + chunk]
                if len(block) < chunk:  # HDF5 filters run on full chunks
                    block = np.concatenate([block, np.zeros(chunk - len(block), arr.dtype)])
                ds.id.write_direct_chunk(
                    (c0,), blosc_codec.compress(np.ascontiguousarray(block).tobytes(), itemsize),
                    filter_mask=0,
                )

    def _write_shape_metadata(self, d, n, nnz):
        with self._file("a") as f:
            for k, v in (("nrow", d), ("ncol", n), ("nnz", nnz)):
                if k in f.attrs:
                    del f.attrs[k]
                f.attrs.create(k, np.uint64(v), dtype=np.uint64)

    def _read_shape_metadata(self):
        with self._file("r") as f:
            a = f.attrs
            if all(k in a for k in ("nrow", "ncol", "nnz")):
                return (int(a["nrow"]), int(a["ncol"]), int(a["nnz"]))
        return None

    def _read_name_list(self, key):
        with self._file("r") as f:
            if key not in f:
                return None
            return [s.decode() if isinstance(s, bytes) else str(s) for s in f[key][...]]

    def _write_name_list(self, key, names):
        import h5py

        with self._file("a") as f:
            if key in f:
                del f[key]
            f.create_dataset(key, data=np.asarray(names, dtype=h5py.string_dtype()))


# ----------------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------------


def _backend_kind(path: str) -> str:
    return "h5" if str(path).endswith((".h5", ".hdf5")) else "zarr"


def create_sparse_from_triplets(rows, cols, vals, shape, path, row_names=None,
                                column_names=None) -> SparseBackend:
    """Write a backend from COO triplets (duplicates summed)."""
    csc = sp.coo_matrix(
        (np.asarray(vals, np.float32), (np.asarray(rows, np.int64), np.asarray(cols, np.int64))),
        shape=shape,
    ).tocsc()
    csc.sum_duplicates()
    return create_sparse_from_csc(csc, path, row_names, column_names)


def create_sparse_from_csc(
    csc: sp.spmatrix,
    path: str | os.PathLike,
    row_names: Sequence[str] | None = None,
    column_names: Sequence[str] | None = None,
) -> SparseBackend:
    """Write a `.zarr` directory, a `.zarr.zip` archive or an `.h5` /
    `.hdf5` file, by the path's suffix."""
    path = str(path)
    if path.endswith(".zarr.zip"):
        # a sibling working directory, archived when complete
        work = path + ".working"
        create_sparse_from_csc(csc, work, row_names, column_names)
        finalize_zarr_zip(work, path)
        return open_sparse_matrix(path)
    backend: _CompressedFileBackend
    if _backend_kind(path) == "h5":
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if Path(path).exists():
            Path(path).unlink()
        backend = H5Backend(path)
    else:
        Path(path).mkdir(parents=True, exist_ok=True)
        backend = ZarrBackend(path)
    backend.record_csc(csc.tocsc())
    if row_names is not None:
        backend.register_row_names(row_names)
    if column_names is not None:
        backend.register_column_names(column_names)
    return backend


class StreamingCscWriter:
    """Bounded-memory `.zarr` construction from column slabs (the JAX
    package's `StreamingCscWriter`, writing through this module's chunk
    encoder instead of tensorstore).

    `append(csc_slab)` spills each slab's COO arrays to disk; nothing is
    held across slabs. `finalize()` writes `by_column/*` in one sequential
    pass over the spilled slabs, then `by_row/*` in gene-chunk passes over
    them, each holding one gene chunk's entries (at most `MAX_CHUNK_NNZ`
    where a single gene allows). Every array goes out chunk by chunk as it
    fills (`_ZarrChunkWriter`), so the store equals what
    `create_sparse_from_csc` writes for the same matrix.

    Usage:
        w = StreamingCscWriter(path, n_rows, row_names=...)
        for slab in blocks: w.append(slab)
        backend = w.finalize(column_names=...)
    """

    MAX_CHUNK_NNZ = 1 << 22  # entries one by_row pass may hold

    def __init__(self, path: str | os.PathLike, n_rows: int, *,
                 row_names: Sequence[str] | None = None, gene_chunk: int = 8192):
        self.path = str(path)
        self.n_rows = int(n_rows)
        self.row_names = row_names
        self.gene_chunk = int(gene_chunk)
        self._spill = Path(self.path + ".spill")
        self._spill.mkdir(parents=True, exist_ok=True)
        self._n_slabs = 0
        self._n_cols = 0
        self._nnz = 0
        self._row_counts = np.zeros(self.n_rows, np.int64)
        self._col_indptr_parts: list[np.ndarray] = [np.zeros(1, np.int64)]
        self._slab_starts: list[int] = []  # nonzeros before each slab

    def append(self, csc_slab: sp.spmatrix):
        slab = sp.csc_matrix(csc_slab)
        if slab.shape[0] != self.n_rows:
            raise ValueError(f"slab rows {slab.shape[0]} != {self.n_rows}")
        i = self._n_slabs
        np.save(self._spill / f"data{i}.npy", slab.data.astype(np.float32))
        np.save(self._spill / f"indices{i}.npy", slab.indices.astype(np.int64))
        self._col_indptr_parts.append(slab.indptr[1:].astype(np.int64) + self._nnz)
        self._slab_starts.append(self._nnz)
        self._row_counts += np.bincount(slab.indices, minlength=self.n_rows).astype(np.int64)
        self._n_slabs += 1
        self._n_cols += slab.shape[1]
        self._nnz += slab.nnz

    def _gene_bounds(self, row_indptr: np.ndarray) -> list[int]:
        """Gene-chunk boundaries, each chunk's nonzeros within MAX_CHUNK_NNZ
        where a single gene allows (a short, wide matrix must not become
        one chunk of every nonzero)."""
        bounds = [0]
        while bounds[-1] < self.n_rows:
            glb = bounds[-1]
            gub = min(glb + self.gene_chunk, self.n_rows)
            while gub > glb + 1 and row_indptr[gub] - row_indptr[glb] > self.MAX_CHUNK_NNZ:
                gub = glb + max(1, (gub - glb) // 2)
            bounds.append(gub)
        return bounds

    def finalize(self, column_names: Sequence[str] | None = None) -> SparseBackend:
        Path(self.path).mkdir(parents=True, exist_ok=True)
        for key, v in (("nrow", self.n_rows), ("ncol", self._n_cols), ("nnz", self._nnz)):
            write_zarr_array(self.path, key, np.asarray([v], np.uint64), "uint64")
        write_zarr_group_metadata(self.path, {"nrow": self.n_rows, "ncol": self._n_cols,
                                              "nnz": self._nnz})
        write_zarr_group_metadata(self.path, key="by_column")
        write_zarr_group_metadata(self.path, key="by_row")

        # by_column: one sequential pass over the slabs
        data_w = _ZarrChunkWriter(self.path, "by_column/data", self._nnz, "float32")
        idx_w = _ZarrChunkWriter(self.path, "by_column/indices", self._nnz, "uint64")
        for i in range(self._n_slabs):
            data_w.write(np.load(self._spill / f"data{i}.npy"))
            idx_w.write(np.load(self._spill / f"indices{i}.npy").astype(np.uint64))
        data_w.close()
        idx_w.close()
        write_zarr_array(self.path, "by_column/indptr",
                         np.concatenate(self._col_indptr_parts).astype(np.uint64), "uint64")

        # by_row: gene-chunk passes over the slabs; each pass keeps one gene
        # chunk's entries
        row_indptr = np.zeros(self.n_rows + 1, np.int64)
        np.cumsum(self._row_counts, out=row_indptr[1:])
        rdata_w = _ZarrChunkWriter(self.path, "by_row/data", self._nnz, "float32")
        ridx_w = _ZarrChunkWriter(self.path, "by_row/indices", self._nnz, "uint64")
        bounds = self._gene_bounds(row_indptr)
        for glb, gub in zip(bounds[:-1], bounds[1:]):
            base = row_indptr[glb]
            chunk_nnz = int(row_indptr[gub] - base)
            if chunk_nnz == 0:
                continue
            cd = np.empty(chunk_nnz, np.float32)
            cc = np.empty(chunk_nnz, np.int64)
            fill = row_indptr[glb:gub] - base  # next free slot of each row
            col_off = 0
            for i in range(self._n_slabs):
                d = np.load(self._spill / f"data{i}.npy")
                r = np.load(self._spill / f"indices{i}.npy")
                ptr = self._col_indptr_parts[i + 1] - self._slab_starts[i]  # column ends
                sel = np.flatnonzero((r >= glb) & (r < gub))
                if len(sel):
                    # slabs arrive in column order, so a stable sort by row
                    # keeps each row's columns sorted
                    cols = np.searchsorted(ptr, sel, side="right")
                    rs = r[sel] - glb
                    order = np.argsort(rs, kind="stable")
                    rs = rs[order]
                    counts = np.bincount(rs, minlength=gub - glb)
                    starts = np.cumsum(counts) - counts
                    pos = fill[rs] + np.arange(len(rs)) - np.repeat(starts, counts)
                    cd[pos] = d[sel][order]
                    cc[pos] = cols[order] + col_off
                    fill = fill + counts
                col_off += len(ptr)
            rdata_w.write(cd)
            ridx_w.write(cc.astype(np.uint64))
        rdata_w.close()
        ridx_w.close()
        write_zarr_array(self.path, "by_row/indptr", row_indptr.astype(np.uint64), "uint64")

        shutil.rmtree(self._spill, ignore_errors=True)
        backend = ZarrBackend(self.path)
        if self.row_names is not None:
            backend.register_row_names(self.row_names)
        if column_names is not None:
            backend.register_column_names(column_names)
        return backend


def open_sparse_matrix(path: str | os.PathLike) -> SparseBackend:
    """Open an existing `.zarr` directory, `.zarr.zip` archive (extracted
    once into `{path}.extracted/`) or `.h5` / `.hdf5` file."""
    path = str(path)
    if not Path(path).exists():
        raise FileNotFoundError(path)
    if path.endswith(".zarr.zip"):
        return ZarrBackend(_extract_zarr_zip(path))
    if _backend_kind(path) == "h5":
        return H5Backend(path)
    return ZarrBackend(path)


def finalize_zarr_zip(working_dir: str, zip_path: str) -> str:
    """Archive a working `.zarr` directory as `.zarr.zip`, its entries
    under a `<stem>/` prefix (`foo.zarr.zip` holds `foo.zarr/...`), stored
    without deflate (the chunks are compressed already), and remove the
    working directory."""
    import zipfile

    working = Path(working_dir)
    stem = Path(zip_path).name[: -len(".zip")]
    if Path(zip_path).exists():
        Path(zip_path).unlink()
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for p in sorted(working.rglob("*")):
            if p.is_file():
                zf.write(p, f"{stem}/{p.relative_to(working)}")
    shutil.rmtree(working)
    return zip_path


def _extract_zarr_zip(path: str) -> str:
    """Unpack a `.zarr.zip` into `{path}.extracted/` (reused while newer
    than the archive); returns the store root inside it."""
    import zipfile

    dest = Path(path + ".extracted")
    marker = dest / ".extract_ok"
    if not (marker.exists() and marker.stat().st_mtime >= Path(path).stat().st_mtime):
        if dest.exists():
            shutil.rmtree(dest)
        dest.mkdir(parents=True)
        with zipfile.ZipFile(path) as zf:
            zf.extractall(dest)
        marker.touch()

    def _is_root(p: Path) -> bool:
        if (p / "nrow").exists():
            return True
        attrs = read_zarr_group_attributes(str(p))
        return bool(attrs) and "nrow" in attrs

    if not _is_root(dest):
        for d in dest.iterdir():
            if d.is_dir() and _is_root(d):
                return str(d)
    return str(dest)
