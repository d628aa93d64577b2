"""Zarr v3 variable-length string arrays, pure Python (the port's copy of
the JAX package's `data/zarr_strings.py`).

The reference stores row/column names as zarr v3 ``string``-dtype
arrays at ``/row_names`` / ``/column_names`` with a Zstd
bytes-to-bytes codec (`data-beans/src/sparse_backend/zarr.rs:281-319,
799-801`). tensorstore's zarr3 driver has no string dtype, so this
module speaks the format directly:

- array metadata: ``{key}/zarr.json`` (zarr v3 core spec);
- chunk payload: numcodecs VLenUTF8 layout — uint32-LE item count,
  then per item uint32-LE byte length + UTF-8 bytes (the ``vlen-utf8``
  codec both zarr-python and zarrs register for string arrays);
- bytes-to-bytes: zstd (via pyarrow's codec, no zstandard module in
  the image) or gzip/zlib.

Reading tolerates the chains the reference and zarr-python emit;
writing emits vlen-utf8 + zstd level 5, matching the reference's
compression level so its reader opens our stores unchanged.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Sequence

_ZSTD_LEVEL = 5


def _zstd_compress(data: bytes, level: int = _ZSTD_LEVEL) -> bytes:
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.CompressedOutputStream(sink, "zstd") as f:
        f.write(data)
    return sink.getvalue().to_pybytes()


def _zstd_decompress(data: bytes) -> bytes:
    import pyarrow as pa

    with pa.CompressedInputStream(pa.BufferReader(data), "zstd") as f:
        return f.read()


def _encode_vlen_utf8(names: Sequence[str]) -> bytes:
    parts = [struct.pack("<I", len(names))]
    for n in names:
        b = str(n).encode("utf-8")
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def _decode_vlen_utf8(payload: bytes) -> list[str]:
    (count,) = struct.unpack_from("<I", payload, 0)
    out = []
    off = 4
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        out.append(payload[off : off + ln].decode("utf-8"))
        off += ln
    return out


def _chunk_separator(meta: dict) -> str:
    cke = meta.get("chunk_key_encoding", {})
    name = cke.get("name", "default")
    sep = cke.get("configuration", {}).get("separator")
    if sep is None:
        sep = "/" if name == "default" else "."
    return sep


def read_string_array(store_path: str, key: str) -> list[str] | None:
    """Read a zarr v3 string array at ``{store_path}/{key}``; None when
    absent or in an unsupported encoding (caller falls back)."""
    adir = Path(store_path) / key.lstrip("/")
    meta_path = adir / "zarr.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if meta.get("node_type") != "array" or meta.get("data_type") != "string":
            return None
        (n,) = meta["shape"]
        (chunk,) = meta["chunk_grid"]["configuration"]["chunk_shape"]
        sep = _chunk_separator(meta)
        codecs = [c["name"] if isinstance(c, dict) else str(c) for c in meta.get("codecs", [])]
        out: list[str] = []
        n_chunks = (n + chunk - 1) // chunk if n else 0
        for ci in range(n_chunks):
            cpath = adir / ("c" + sep + str(ci)) if sep == "." else adir / "c" / str(ci)
            if not cpath.exists():
                # missing chunk = fill values
                out.extend([""] * min(chunk, n - len(out)))
                continue
            raw = cpath.read_bytes()
            for name in reversed(codecs):
                if name in ("vlen-utf8", "vlen_v2", "vlen-bytes"):
                    continue  # array->bytes codec handled below
                if name == "zstd":
                    raw = _zstd_decompress(raw)
                elif name in ("gzip", "zlib"):
                    import zlib

                    raw = zlib.decompress(raw, 47)  # auto-detect zlib/gzip
                elif name == "crc32c":
                    raw = raw[:-4]
                else:
                    return None  # blosc etc: unsupported here
            out.extend(_decode_vlen_utf8(raw))
        return out[:n]
    except Exception:
        return None


def write_string_array(store_path: str, key: str, names: Sequence[str]):
    """Write a zarr v3 string array (vlen-utf8 + zstd-5, single chunk)
    readable by zarrs/zarr-python at the reference's key layout."""
    adir = Path(store_path) / key.lstrip("/")
    (adir / "c").mkdir(parents=True, exist_ok=True)
    n = len(names)
    meta = {
        "zarr_format": 3,
        "node_type": "array",
        "shape": [n],
        "data_type": "string",
        "chunk_grid": {
            "name": "regular",
            "configuration": {"chunk_shape": [max(n, 1)]},
        },
        "chunk_key_encoding": {
            "name": "default",
            "configuration": {"separator": "/"},
        },
        "fill_value": "",
        "codecs": [
            {"name": "vlen-utf8"},
            {"name": "zstd", "configuration": {"level": _ZSTD_LEVEL, "checksum": False}},
        ],
    }
    (adir / "zarr.json").write_text(json.dumps(meta))
    payload = _zstd_compress(_encode_vlen_utf8(names))
    (adir / "c" / "0").write_bytes(payload)
