"""ctypes bindings for the native IO accelerators (the port's copy of the
JAX package's `data/ioaccel.py`, over its own `native/ioaccel.cpp`):
MatrixMarket body parsing and ATAC-fragments tokenization as compiled C
loops.

The library is built at first use with `g++ -O2 -shared -fPIC
-std=c++17 ... -lz` into the git-ignored `legume_tpu_torch/_build/`,
named by the source's hash, and loaded from there. Builders call
`mtx_triplet_chunks` / `fragment_chunks` when it builds, and fall back
to the pure-Python parsers otherwise (logged at warning level);
`parser()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parents[1] / "native" / "ioaccel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lib = None
_tried = False


def _build() -> Path:
    """The shared object for the current source, compiled if missing."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libioaccel_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
                        str(tmp), "-lz"], check=True, capture_output=True)
        tmp.replace(so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except Exception as e:  # no compiler / build failure -> python fallback
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native ioaccel unavailable (%s%s); using the python parsers", e,
                    f": {detail.decode(errors='replace')[:200]}" if detail else "")
        return None
    lib.mtx_open.restype = ctypes.c_void_p
    lib.mtx_open.argtypes = [ctypes.c_char_p]
    lib.mtx_dims.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 3
    lib.mtx_next_chunk.restype = ctypes.c_long
    lib.mtx_next_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.mtx_close.argtypes = [ctypes.c_void_p]
    lib.frag_open.restype = ctypes.c_void_p
    lib.frag_open.argtypes = [ctypes.c_char_p]
    lib.frag_next_chunk.restype = ctypes.c_long
    lib.frag_next_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    for fn in ("frag_num_chroms", "frag_num_barcodes"):
        getattr(lib, fn).restype = ctypes.c_long
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("frag_chrom", "frag_barcode"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.frag_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parser() -> str:
    """`"native"` where the C library loads, else `"python"`."""
    return "native" if available() else "python"


def mtx_triplet_chunks(path: str, chunk: int = 1 << 22):
    """Yields (dims, None) first, then (rows, cols, vals) 0-based
    triplet chunks from a (possibly gzipped) MatrixMarket file."""
    lib = _load()
    if lib is None:
        raise RuntimeError("ioaccel unavailable")
    h = lib.mtx_open(str(path).encode())
    if not h:
        raise IOError(f"cannot parse MTX header: {path}")
    try:
        nr = ctypes.c_int64()
        nc = ctypes.c_int64()
        nz = ctypes.c_int64()
        lib.mtx_dims(h, ctypes.byref(nr), ctypes.byref(nc), ctypes.byref(nz))
        yield (int(nr.value), int(nc.value), int(nz.value)), None
        rows = np.empty(chunk, np.int64)
        cols = np.empty(chunk, np.int64)
        vals = np.empty(chunk, np.float32)
        while True:
            n = lib.mtx_next_chunk(
                h, chunk,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if n < 0:
                raise IOError(f"MTX parse error in {path}")
            if n == 0:
                break
            yield rows[:n].copy(), cols[:n].copy(), vals[:n].copy()
    finally:
        lib.mtx_close(h)


def fragment_chunks(path: str, chunk: int = 1 << 20):
    """Yields (chrom_id, start, end, barcode_id, count, chroms_so_far)
    tuples, then a final dict {"chroms": [...], "barcodes": [...]}
    after EOF. `chroms_so_far` covers every id in the chunk (the
    interner grows monotonically), so peak lookup works mid-stream."""
    lib = _load()
    if lib is None:
        raise RuntimeError("ioaccel unavailable")
    h = lib.frag_open(str(path).encode())
    if not h:
        raise IOError(f"cannot open fragments: {path}")
    try:
        cid = np.empty(chunk, np.int64)
        start = np.empty(chunk, np.int64)
        end = np.empty(chunk, np.int64)
        bid = np.empty(chunk, np.int64)
        cnt = np.empty(chunk, np.int32)
        while True:
            n = lib.frag_next_chunk(
                h, chunk,
                cid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                bid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if n <= 0:
                break
            chroms_now = [lib.frag_chrom(h, i).decode() for i in range(lib.frag_num_chroms(h))]
            yield (cid[:n].copy(), start[:n].copy(), end[:n].copy(), bid[:n].copy(),
                   cnt[:n].copy(), chroms_now)
        chroms = [lib.frag_chrom(h, i).decode() for i in range(lib.frag_num_chroms(h))]
        barcodes = [lib.frag_barcode(h, i).decode() for i in range(lib.frag_num_barcodes(h))]
        yield {"chroms": chroms, "barcodes": barcodes}
    finally:
        lib.frag_close(h)
