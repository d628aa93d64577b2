"""Raw zarr store reading for `data-beans from-zarr` (the port's copy of
the JAX package's `data/zarr_raw.py`, without tensorstore): numeric and
string fields at arbitrary paths inside a v2 or v3 store, directory or
``.zarr.zip`` archive (the 10x Xenium ``cell_feature_matrix.zarr.zip``
layout).

Numeric chunks are decoded here:

- v2 (``.zarray``): C order, ``"."`` or ``"/"`` dimension separators,
  the compressors ``null``, ``zlib``, ``gzip``, ``zstd`` (pyarrow's
  codec) and ``blosc`` (the system libblosc through
  `data/blosc_codec.py`; without it an ImportError names the library);
  a missing chunk reads as the fill value;
- v3 (``zarr.json``): the storage engine's own reader
  (`sparse_io._ZarrArray`: 1-d, ``bytes`` then ``zstd``), a ``.zip``
  extracted once beside itself as the engine's stores are.

Metadata documents (``.zattrs`` / ``zarr.json``) are read directly for
attribute-stored name lists, with the v3 vlen-utf8 string reader as a
further fallback.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import zipfile
import zlib

import numpy as np

log = logging.getLogger(__name__)


class _Store:
    """Bytes at keys relative to a store root: a directory or a zip archive
    (entries at the archive's root)."""

    def __init__(self, store_path: str):
        self.path = store_path
        self.is_dir = os.path.isdir(store_path)
        self._zip = None
        if not self.is_dir:
            if not zipfile.is_zipfile(store_path):
                raise FileNotFoundError(f"not a zarr dir or zip: {store_path}")
            self._zip = zipfile.ZipFile(store_path)
            self._names = set(self._zip.namelist())

    def get(self, rel: str) -> bytes | None:
        rel = rel.lstrip("/")
        if self.is_dir:
            p = os.path.join(self.path, rel)
            if not os.path.isfile(p):
                return None
            with open(p, "rb") as f:
                return f.read()
        return self._zip.read(rel) if rel in self._names else None

    def close(self):
        if self._zip is not None:
            self._zip.close()


def _read_meta_doc(store_path: str, rel: str) -> "dict | list | None":
    """A JSON metadata document at `rel` inside the store, or None."""
    if os.path.isdir(store_path):
        p = os.path.join(store_path, rel)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None
    if zipfile.is_zipfile(store_path):
        with zipfile.ZipFile(store_path) as zf:
            names = set(zf.namelist())
            for cand in (rel, rel.lstrip("/")):
                if cand in names:
                    return json.loads(zf.read(cand))
    return None


def _blosc_decompress(raw: bytes) -> bytes:
    from . import blosc_codec

    if not blosc_codec.available():
        raise ImportError("this zarr array is blosc-compressed, which needs the system "
                          "c-blosc library (libblosc.so.1), not found")
    return blosc_codec.decompress(raw)


def _decompress(raw: bytes, codec_id: str | None, nbytes: int) -> bytes:
    if codec_id is None:
        return raw
    if codec_id == "zlib":
        return zlib.decompress(raw)
    if codec_id == "gzip":
        return gzip.decompress(raw)
    if codec_id == "zstd":
        from .sparse_io import _zstd

        return _zstd().decompress(raw, decompressed_size=nbytes, asbytes=True)
    if codec_id == "blosc":
        return _blosc_decompress(raw)
    raise ValueError(f"zarr compressor {codec_id!r} is not supported")


def _v2_array(store: _Store, field: str, meta: dict) -> np.ndarray:
    if meta.get("order", "C") != "C":
        raise ValueError(f"{field}: only C-order zarr v2 arrays are supported")
    if meta.get("filters"):
        raise ValueError(f"{field}: zarr v2 filters are not supported")
    dtype = np.dtype(meta["dtype"])
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    comp = meta.get("compressor")
    codec = None if comp is None else comp["id"]
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        raw = store.get(f"{field}/{key}")
        if raw is None:
            continue
        buf = np.frombuffer(_decompress(raw, codec, nbytes), dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = buf[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out


def read_zarr_array(store_path: str, field: str) -> np.ndarray:
    """The array at `field` (v3 first, then v2)."""
    field = field.strip("/")
    store = _Store(store_path)
    try:
        doc = store.get(f"{field}/zarr.json")
        if doc is not None and json.loads(doc).get("node_type") == "array":
            from .sparse_io import _ZarrArray, _extract_zarr_zip

            if not store.is_dir:  # fields name paths from the archive's root
                _extract_zarr_zip(store_path)
            root = store_path if store.is_dir else store_path + ".extracted"
            return _ZarrArray(root, field).read()
        doc = store.get(f"{field}/.zarray")
        if doc is not None:
            return _v2_array(store, field, json.loads(doc))
    finally:
        store.close()
    raise FileNotFoundError(f"no zarr array at {store_path}:{field}")


def read_zarr_numeric(store_path: str, field: str) -> np.ndarray:
    """Numeric array at `field` (v3 first, then v2)."""
    arr = read_zarr_array(store_path, field)
    if arr.dtype.kind not in "biuf":
        raise FileNotFoundError(f"no numeric zarr array at {store_path}:{field} "
                                f"(dtype {arr.dtype})")
    return arr


def _strings_from_attr(doc) -> "list[str] | None":
    """A list of strings inside an attribute document, if there is one."""
    if isinstance(doc, list) and doc and all(isinstance(x, str) for x in doc):
        return [str(x) for x in doc]
    if isinstance(doc, dict):
        for v in doc.values():
            got = _strings_from_attr(v)
            if got is not None:
                return got
    return None


def read_zarr_strings(store_path: str, field: str) -> "list[str] | None":
    """String list at `field`: group/array attributes first
    (from_zarr.rs `read_zarr_group_attr` precedence), then a v3
    vlen-utf8 string array, then a v2 bytes/unicode array."""
    field = field.strip("/")
    # 1) attribute documents (Xenium keeps feature ids/names here)
    for rel, picker in (
        (f"{field}/.zattrs", lambda d: d),
        (f"{field}/zarr.json", lambda d: d.get("attributes", {})),
    ):
        doc = _read_meta_doc(store_path, rel)
        if doc is not None:
            got = _strings_from_attr(picker(doc))
            if got is not None:
                return got
    # parent group attrs keyed by the leaf name
    parent, _, leaf = field.rpartition("/")
    for rel, picker in (
        (f"{parent}/.zattrs", lambda d: d.get(leaf)),
        (f"{parent}/zarr.json", lambda d: d.get("attributes", {}).get(leaf)),
    ):
        doc = _read_meta_doc(store_path, rel)
        if doc is not None:
            got = _strings_from_attr(picker(doc))
            if got is not None:
                return got
    # 2) v3 string array (our own store format)
    try:
        from .zarr_strings import read_string_array

        return list(read_string_array(store_path, field))
    except Exception:  # noqa: BLE001
        pass
    # 3) v2 fixed-width bytes / unicode array
    try:
        arr = read_zarr_array(store_path, field)
        if arr.dtype.kind in "SU":
            return [x.decode() if isinstance(x, bytes) else str(x) for x in arr.ravel()]
        if arr.dtype.kind == "u" and arr.ndim == 2 and arr.shape[1] == 2:
            return xenium_cell_ids(arr)
    except ImportError:
        raise
    except Exception:  # noqa: BLE001
        pass
    return None


def xenium_cell_ids(arr: np.ndarray) -> list[str]:
    """Xenium cell-id mapping (from_zarr.rs column_name_field note):
    [N, 2] uint32 of (id, dataset suffix) -> 8 chars over 'a'..'p'
    (one per nibble, high first) + '-{suffix}'."""
    alphabet = "abcdefghijklmnop"
    out = []
    for cid, suf in np.asarray(arr, np.uint64):
        s = "".join(alphabet[(int(cid) >> (4 * (7 - j))) & 0xF] for j in range(8))
        out.append(f"{s}-{int(suf)}")
    return out
