"""Container-file structure listing (`data-beans list-h5` / `list-zarr`;
the port's copy of the JAX package's `data/listing.py`).

Reference role: `data-beans/src/handlers/listing.rs` (`list_h5`, `list_zarr`)
— print what groups and arrays a container holds so a user can see whether a
file is one of ours, an AnnData export, or something else, before pointing a
builder at it.  Works on ANY h5/zarr file, not only our backends.
"""

from __future__ import annotations

import json
import os
import zipfile


def _fmt(path: str, kind: str, shape=None, dtype=None) -> str:
    if kind == "group":
        return f"{path}/"
    dims = "x".join(str(s) for s in shape) if shape is not None else "?"
    return f"{path}  [{kind} {dims} {dtype}]"


def list_h5(path: str) -> list[str]:
    """Walk an HDF5 file; one line per group/dataset with shape + dtype."""
    from .builders import _h5py

    h5py = _h5py()

    lines: list[str] = []
    with h5py.File(path, "r") as f:

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                lines.append(_fmt("/" + name, "dataset", obj.shape, obj.dtype))
            else:
                lines.append(_fmt("/" + name, "group"))

        f.visititems(visit)
    return lines


def _zarr_meta_lines(metas: list[tuple[str, dict]]) -> list[str]:
    lines = []
    for key, meta in sorted(metas):
        node = meta.get("node_type")
        if node == "group" or ("shape" not in meta and "zarr_format" in meta):
            if key:
                lines.append(_fmt("/" + key, "group"))
            continue
        shape = meta.get("shape")
        dtype = meta.get("data_type", meta.get("dtype", "?"))
        if isinstance(dtype, dict):  # zarr v3 extension dtypes
            dtype = dtype.get("name", "?")
        lines.append(_fmt("/" + key, "array", shape, dtype))
    return lines


def list_zarr(path: str) -> list[str]:
    """List arrays in a zarr v2/v3 store: a ``.zarr`` directory or ``.zarr.zip``.

    Reads only the metadata documents (``zarr.json`` for v3, ``.zarray`` /
    ``.zgroup`` for v2), never the chunk payloads.
    """
    metas: list[tuple[str, dict]] = []
    if os.path.isdir(path):
        for root, _dirs, files in os.walk(path):
            rel = os.path.relpath(root, path)
            rel = "" if rel == "." else rel.replace(os.sep, "/")
            for fn in files:
                if fn in ("zarr.json", ".zarray", ".zgroup"):
                    with open(os.path.join(root, fn)) as f:
                        try:
                            metas.append((rel, json.load(f)))
                        except json.JSONDecodeError:
                            pass
    elif zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            for name in zf.namelist():
                base = name.rsplit("/", 1)[-1]
                if base in ("zarr.json", ".zarray", ".zgroup"):
                    key = name[: -len(base)].rstrip("/")
                    try:
                        metas.append((key, json.loads(zf.read(name))))
                    except json.JSONDecodeError:
                        pass
    else:
        raise FileNotFoundError(f"not a zarr dir or zip: {path}")
    return _zarr_meta_lines(metas)
