"""Table outputs: parquet when pandas and pyarrow are installed, else an
`.npz` of the same columns. Nothing upstream of the writer depends on
which one it picks."""

from __future__ import annotations

import importlib.util

import numpy as np


def have_parquet() -> bool:
    return all(importlib.util.find_spec(m) is not None for m in ("pandas", "pyarrow"))


def write_table(stem: str, columns: dict[str, np.ndarray]) -> str:
    """Write `columns` (equal-length 1-d arrays, in order) to
    `{stem}.parquet` or `{stem}.npz`; returns the path written."""
    if have_parquet():
        import pandas as pd

        path = f"{stem}.parquet"
        pd.DataFrame({k: np.asarray(v) for k, v in columns.items()}).to_parquet(path)
        return path
    path = f"{stem}.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in columns.items()})
    return path


def matrix_columns(mat: np.ndarray, prefix: str, index_name: str | None = None,
                   index=None) -> dict[str, np.ndarray]:
    """Columns `{index_name: index, prefix0: mat[:, 0], ...}`."""
    cols: dict[str, np.ndarray] = {}
    if index_name is not None:
        cols[index_name] = np.asarray(index)
    for j in range(mat.shape[1]):
        cols[f"{prefix}{j}"] = mat[:, j]
    return cols
