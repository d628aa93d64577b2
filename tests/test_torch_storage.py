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


# ---------------------------------------------------------------------------
# the port's own zarr v3 reader and writer against tensorstore's
# ---------------------------------------------------------------------------


def _ts_write(path, arr, chunk):
    ts = pytest.importorskip("tensorstore")
    spec = {
        "driver": "zarr3",
        "kvstore": {"driver": "file", "path": str(path)},
        "metadata": {
            "shape": list(arr.shape), "data_type": str(arr.dtype),
            "chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": [min(chunk, max(len(arr), 1))]}},
            "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                       {"name": "zstd", "configuration": {"level": 5}}],
        },
        "create": True, "delete_existing": True,
    }
    ts.open(spec).result()[...].write(arr).result()


def _ts_read(path, lb=0, ub=None):
    import tensorstore as ts

    store = ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": str(path)}}).result()
    return np.asarray((store[...] if ub is None else store[lb:ub]).read().result())


def _arrays():
    rng = np.random.default_rng(0)
    data = rng.random(1000).astype(np.float32)
    data[128:192] = 0.0  # a whole chunk of fill values: not stored
    ids = rng.integers(0, 1 << 40, 777).astype(np.uint64)
    return {"float32_multi_chunk": data, "uint64_edge_chunk": ids,
            "empty": np.zeros(0, np.uint64), "one": np.asarray([5], np.uint64)}


@pytest.mark.parametrize("name", list(_arrays()))
def test_zarr_arrays_equal_tensorstores(tmp_path, monkeypatch, name):
    """`zarr.json` JSON-equal, the same chunk files, each chunk
    decompressing to the same bytes; each side reads the other's array,
    whole and by range."""
    import json

    import pyarrow as pa

    arr = _arrays()[name]
    monkeypatch.setattr(tio, "_CHUNK", 64)
    tio.write_zarr_array(str(tmp_path / "port"), "a", arr, arr.dtype.name)
    _ts_write(tmp_path / "ts" / "a", arr, 64)
    dp, dt = tmp_path / "port" / "a", tmp_path / "ts" / "a"
    assert json.loads((dp / "zarr.json").read_text()) == json.loads((dt / "zarr.json").read_text())
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())  # noqa: E731
    assert files(dp) == files(dt)
    nbytes = min(64, max(len(arr), 1)) * arr.dtype.itemsize
    codec = pa.Codec("zstd")
    for rel in files(dp):
        if rel.startswith("c/"):
            raw = [codec.decompress((d / rel).read_bytes(), decompressed_size=nbytes,
                                    asbytes=True) for d in (dp, dt)]
            assert raw[0] == raw[1], rel
    for owner in ("port", "ts"):
        backend = tio.ZarrBackend(str(tmp_path / owner))
        np.testing.assert_array_equal(backend._read_array("a"), arr)
        np.testing.assert_array_equal(_ts_read(tmp_path / owner / "a"), arr)
        for lb, ub in ((0, 1), (60, 70), (100, 200), (len(arr) - 3, len(arr)), (5, 5)):
            lb, ub = max(0, min(lb, len(arr))), min(ub, len(arr))
            np.testing.assert_array_equal(backend._read_array("a", lb, ub), arr[lb:ub])


def test_ranged_read_decodes_only_its_chunks(tmp_path, monkeypatch):
    arr = np.arange(1000, dtype=np.uint64) + 1
    monkeypatch.setattr(tio, "_CHUNK", 100)
    tio.write_zarr_array(str(tmp_path), "a", arr, "uint64")
    seen = []
    decode = tio._ZarrArray.decode
    monkeypatch.setattr(tio._ZarrArray, "decode", lambda self, i: seen.append(i) or decode(self, i))
    backend = tio.ZarrBackend(str(tmp_path))
    np.testing.assert_array_equal(backend._read_array("a", 250, 420), arr[250:420])
    assert seen == [2, 3, 4]
    np.testing.assert_array_equal(backend._read_array("a", 310, 330), arr[310:330])
    assert seen == [2, 3, 4, 3]


@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("ext", [".zarr", ".zarr.zip"])
def test_multi_chunk_stores_cross_read(tmp_path, monkeypatch, ext, whole):
    """A store of many chunks written by the port opens in the JAX package
    (through tensorstore) with equal columns, and the JAX package's store
    opens in the port, its columns read from the arrays decoded whole or
    (`whole=False`) by ranged reads of the chunks."""
    pytest.importorskip("tensorstore")
    m, rows, cols = _matrix()
    monkeypatch.setattr(tio, "_CHUNK", 256)
    if not whole:
        monkeypatch.setattr(tio.ZarrBackend, "WHOLE_BYTES", 0)
    pt, pj = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tio.create_sparse_from_csc(m, pt, rows, cols)
    jio.create_sparse_from_csc(m, pj, rows, cols)
    pick = np.r_[0:5, 17, 300:420, 650:700, 3, 3, 699, 0]
    for path in (pt, pj):
        for reader in (tio, jio):
            b = reader.open_sparse_matrix(path)
            assert b.shape == m.shape and b.row_names() == rows and b.column_names() == cols
            assert (b.read_columns_csc(pick) != m[:, pick]).nnz == 0
    meta = (tmp_path / "t.zarr" / "by_column" / "data" / "zarr.json") if ext == ".zarr" else None
    if meta is not None:
        assert '"chunk_shape":[256]' in meta.read_text()


def test_h5_without_h5py_raises_import_error(tmp_path, monkeypatch):
    import sys

    path = tmp_path / "m.h5"
    path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tio.open_sparse_matrix(str(path)).num_rows
