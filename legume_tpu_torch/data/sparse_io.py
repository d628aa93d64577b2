"""Sparse count-matrix backends (the port's own copy of the JAX package's
storage engine, `data/sparse_io.py`, without the streaming writer).

On-disk layout, the same in both packages and both formats:

    (root)
        nrow, ncol, nnz                                 [1] uint64
        by_column/{data f32, indices u64, indptr u64}   # CSC
        by_row/{data f32, indices u64, indptr u64}      # CSR
        row_names, column_names                         string arrays

Matrix orientation: rows = features/genes (D), columns = cells (N).
`read_columns_csc(cols)` returns a scipy `csc_matrix` of shape
[D, len(cols)].

- ``MemoryBackend``: scipy CSC in RAM (simulations, tests, small runs).
- ``ZarrBackend``: zarr v3 directory through tensorstore (zstd level 5);
  a `.zarr.zip` archive is extracted once beside itself and read as a
  directory.
- ``H5Backend``: HDF5 through h5py, chunks blosc-compressed by the
  system libblosc and moved with direct chunk reads and writes.

The optional libraries (tensorstore, h5py, libblosc, pyarrow for the
zstd of zarr string arrays) are imported only on the paths that need
them, so the compute path needs numpy, scipy and torch alone. A store
written here is what the JAX package writes for the same matrix, and
each package reads the other's.
"""

from __future__ import annotations

import abc
import importlib.util
import json
import logging
import os
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np
import scipy.sparse as sp

_log = logging.getLogger(__name__)

_CHUNK = 1 << 20  # elements per zarr chunk (the reference's MTX_STREAM_BLOCK)
_ZSTD_LEVEL = 5


# ----------------------------------------------------------------------------
# zarr v3 helpers (tensorstore)
# ----------------------------------------------------------------------------


def _zarr3_spec(path: str, key: str, *, shape=None, dtype=None, create=False):
    spec = {
        "driver": "zarr3",
        "kvstore": {"driver": "file", "path": os.path.join(path, key.lstrip("/"))},
    }
    if create:
        spec["metadata"] = {
            "shape": list(shape),
            "data_type": dtype,
            "chunk_grid": {
                "name": "regular",
                "configuration": {"chunk_shape": [min(_CHUNK, max(int(shape[0]), 1))]},
            },
            "codecs": [
                {"name": "bytes", "configuration": {"endian": "little"}},
                {"name": "zstd", "configuration": {"level": _ZSTD_LEVEL}},
            ],
        }
        spec["create"] = True
        spec["delete_existing"] = True
    return spec


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


class _CompressedFileBackend(SparseBackend):
    """On-disk CSC + CSR copies: the column indptr is cached on first
    use; data and indices are read per contiguous run of columns."""

    def __init__(self, path: str):
        self.path = str(path)
        self._col_indptr: np.ndarray | None = None
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
    """Zarr v3 directory store through tensorstore. Names are zarr v3
    string arrays at `row_names` / `column_names` (written where pyarrow
    provides zstd) with a `{key}.names.txt` mirror beside each; reading
    takes the string array first, then the mirror."""

    def _open(self, key: str, **create):
        import tensorstore as ts

        return ts.open(_zarr3_spec(self.path, key, **create)).result()

    def _read_array(self, key, lb=0, ub=None):
        store = self._open(key)
        if ub is None:
            return np.asarray(store[...].read().result())
        return np.asarray(store[lb:ub].read().result())

    def _write_array(self, key, arr, dtype):
        arr = np.ascontiguousarray(arr)
        self._open(key, shape=arr.shape, dtype=dtype, create=True)[...].write(arr).result()

    def _read_name_list(self, key):
        from .zarr_strings import read_string_array

        names = read_string_array(self.path, key)
        if names is not None:
            return names
        p = _names_path(self.path, key)
        return p.read_text().rstrip("\n").split("\n") if p.exists() else None

    def _write_name_list(self, key, names):
        if importlib.util.find_spec("pyarrow") is not None:
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
        import h5py

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
