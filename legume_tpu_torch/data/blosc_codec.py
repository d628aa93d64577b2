"""ctypes binding to the system c-blosc1 (`libblosc.so.1`) (the port's
copy of the JAX package's `data/blosc_codec.py`).

The reference's HDF5 backend writes every data/indices/indptr dataset
with the standard HDF5 blosc filter (id 32001) using the blosclz
compressor at clevel 5 with byte shuffle
(`data-beans/src/sparse_backend/hdf5.rs:15,779-801`
`.blosc_blosclz(COMPRESSION_LEVEL=5, shuffle=true)`). This image has no
`hdf5plugin`, so the filter cannot run inside libhdf5 — instead the
H5Backend compresses/decompresses chunks itself through the real
c-blosc library (present as a system package) and moves the raw chunk
bytes with h5py's `write_direct_chunk`/`read_direct_chunk`, which
bypass the in-process filter pipeline. Byte streams are therefore
EXACTLY what the reference's libblosc produces/consumes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from ctypes import (
    POINTER,
    byref,
    c_char_p,
    c_int,
    c_size_t,
    c_void_p,
    create_string_buffer,
)

# HDF5 filter id registered for blosc (hdf5plugin / hdf5-metno use the
# same public id)
BLOSC_H5_FILTER_ID = 32001
# blosc frame overhead: 16-byte header (+ block index, covered by the
# library's own bound; 16 extra bytes is the documented BLOSC_MAX_OVERHEAD)
BLOSC_MAX_OVERHEAD = 16

# cd_values convention of the standard blosc HDF5 filter
# (c-blosc/hdf5/blosc_filter.c): [filter_version, blosc_version_format,
# typesize, chunk_bytes, clevel, shuffle, compcode]
FILTER_BLOSC_VERSION = 2
BLOSC_VERSION_FORMAT = 2
COMPCODE_BLOSCLZ = 0
SHUFFLE_BYTE = 1
CLEVEL = 5  # hdf5.rs:15 COMPRESSION_LEVEL


@functools.lru_cache(maxsize=1)
def _lib():
    names = ["libblosc.so.1", "libblosc.so"]
    found = ctypes.util.find_library("blosc")
    if found:
        names.append(found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.blosc_compress_ctx.restype = c_int
    lib.blosc_compress_ctx.argtypes = [
        c_int, c_int, c_size_t, c_size_t, c_void_p, c_void_p, c_size_t,
        c_char_p, c_size_t, c_int,
    ]
    lib.blosc_decompress_ctx.restype = c_int
    lib.blosc_decompress_ctx.argtypes = [c_void_p, c_void_p, c_size_t, c_int]
    lib.blosc_cbuffer_sizes.restype = None
    lib.blosc_cbuffer_sizes.argtypes = [
        c_void_p, POINTER(c_size_t), POINTER(c_size_t), POINTER(c_size_t)
    ]
    return lib


def available() -> bool:
    return _lib() is not None


def compress(data: bytes, typesize: int, *, clevel: int = CLEVEL,
             shuffle: int = SHUFFLE_BYTE) -> bytes:
    """blosclz-compress one buffer (one HDF5 chunk)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libblosc.so.1 not available")
    dst = create_string_buffer(len(data) + BLOSC_MAX_OVERHEAD)
    n = lib.blosc_compress_ctx(
        clevel, shuffle, typesize, len(data), data, dst, len(dst),
        b"blosclz", 0, 1,
    )
    if n <= 0:
        raise RuntimeError(f"blosc_compress_ctx failed (rc={n})")
    return dst.raw[:n]


def decompress(src: bytes) -> bytes:
    """Decompress one blosc frame (any compressor the library knows)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libblosc.so.1 not available")
    nbytes, cbytes, blocksize = c_size_t(), c_size_t(), c_size_t()
    lib.blosc_cbuffer_sizes(src, byref(nbytes), byref(cbytes), byref(blocksize))
    if cbytes.value > len(src):
        raise ValueError("truncated blosc frame")
    out = create_string_buffer(max(nbytes.value, 1))
    m = lib.blosc_decompress_ctx(src, out, nbytes.value, 1)
    if m < 0 or m != nbytes.value:
        raise RuntimeError(f"blosc_decompress_ctx failed (rc={m})")
    return out.raw[: nbytes.value]
