"""The port's storage engine against the JAX package's on the same
matrix: each package opens the `.zarr`, `.zarr.zip` and `.h5` stores the
other wrote with equal columns, names and shape, and the two writers
produce the same bytes (zarr files, h5 chunks)."""

import numpy as np
import pytest
import scipy.sparse as sp

from legume_tpu.data import sparse_io as jio
from legume_tpu_torch.data import blosc_codec
from legume_tpu_torch.data import sparse_io as tio

FORMATS = [".zarr", ".zarr.zip", ".h5"]


def _matrix():
    m = sp.random(120, 700, density=0.06, format="csc", random_state=3, dtype=np.float32)
    m.data = np.ceil(m.data * 7)
    rows = [f"gene{i}" for i in range(120)]
    cols = [f"AAAC-{j}" for j in range(700)]
    return m, rows, cols


def _needs(ext):
    if ext == ".h5":
        pytest.importorskip("h5py")
        if not blosc_codec.available():
            pytest.skip("libblosc.so.1 is not installed")
    else:
        pytest.importorskip("tensorstore")


@pytest.mark.parametrize("ext", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(tmp_path, ext, writer):
    _needs(ext)
    m, rows, cols = _matrix()
    w, r = (jio, tio) if writer == "jax" else (tio, jio)
    path = str(tmp_path / f"m{ext}")
    w.create_sparse_from_csc(m, path, rows, cols)
    for reader in (r, w):
        b = reader.open_sparse_matrix(path)
        assert b.shape == m.shape and b.num_nonzeros == m.nnz
        assert b.row_names() == rows and b.column_names() == cols
        pick = np.r_[0:5, 17, 300:420, 699]
        got = b.read_columns_csc(pick)
        assert (got != m[:, pick]).nnz == 0


@pytest.mark.parametrize("ext", FORMATS)
def test_writers_produce_the_same_bytes(tmp_path, ext):
    _needs(ext)
    m, rows, cols = _matrix()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj, pt = str(tmp_path / "j" / f"m{ext}"), str(tmp_path / "t" / f"m{ext}")
    jio.create_sparse_from_csc(m, pj, rows, cols)
    tio.create_sparse_from_csc(m, pt, rows, cols)
    if ext == ".h5":
        import h5py

        with h5py.File(pj) as fj, h5py.File(pt) as ft:
            assert dict(fj.attrs) == dict(ft.attrs)
            for key in ("by_column/data", "by_column/indices", "by_column/indptr",
                        "by_row/data", "by_row/indices", "by_row/indptr", "nrow"):
                dj, dt = fj[key], ft[key]
                assert dj.chunks == dt.chunks and dj.shape == dt.shape
                for c0 in range(0, dj.shape[0], dj.chunks[0]):
                    assert dj.id.read_direct_chunk((c0,)) == dt.id.read_direct_chunk((c0,))
            assert list(fj["row_names"][...]) == list(ft["row_names"][...])
        return
    if ext == ".zarr.zip":
        import zipfile

        with zipfile.ZipFile(pj) as zj, zipfile.ZipFile(pt) as zt:
            assert zj.namelist() == zt.namelist()
            for name in zj.namelist():
                assert zj.read(name) == zt.read(name), name
        return
    from pathlib import Path

    fj = sorted(p.relative_to(pj) for p in Path(pj).rglob("*") if p.is_file())
    ft = sorted(p.relative_to(pt) for p in Path(pt).rglob("*") if p.is_file())
    assert fj == ft
    for rel in fj:
        assert (Path(pj) / rel).read_bytes() == (Path(pt) / rel).read_bytes(), rel


def test_triplets_writer_sums_duplicates(tmp_path):
    pytest.importorskip("tensorstore")
    rows, cols, vals = [0, 2, 2, 1], [1, 0, 0, 3], [1.0, 2.0, 5.0, 4.0]
    path = str(tmp_path / "t.zarr")
    tio.create_sparse_from_triplets(rows, cols, vals, (3, 4), path)
    want = jio.create_sparse_from_triplets(rows, cols, vals, (3, 4), str(tmp_path / "j.zarr"))
    got = jio.open_sparse_matrix(path).read_columns_csc(np.arange(4))
    assert (got != want.read_columns_csc(np.arange(4))).nnz == 0
    assert got[2, 0] == 7.0


def test_missing_store_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tio.open_sparse_matrix(str(tmp_path / "nothing.h5"))
