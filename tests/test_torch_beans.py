"""`data-beans` through both packages' CLIs on the same small inputs, the
port on the CPU: every store a builder, subset or converter writes
decodes to the same arrays and names, and its `zarr.json` documents are
JSON-equal to the JAX package's; printed outputs, TSV and parquet
outputs are equal; `qc` gives JAX's statistics and masks; the
streaming writer equals the in-memory one; the h5 commands run where
h5py imports and name it where it does not; both parsers carry the
same flags and defaults (the port adds `--device` to `qc` and
`histogram`)."""

import argparse
import gzip
import json
import os
import shutil
import sys
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import scipy.io as sio
import scipy.sparse as sp

from legume_tpu.cli.beans_cli import run_beans as j_beans
from legume_tpu.data import sparse_io as jsio
from legume_tpu_torch.cli.beans_cli import run_beans as t_beans
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data import builders as tb
from legume_tpu_torch.data import ioaccel as tio
from legume_tpu_torch.data import sparse_io as tsio
from legume_tpu_torch.data.spill import build_streaming_from_triplet_chunks

D, N = 40, 60


def _dense(seed, d=D, n=N):
    rng = np.random.default_rng(seed)
    return (rng.poisson(1.2, (d, n)) * (rng.random((d, n)) < 0.5)).astype(np.float32)


def _genes(d=D, offset=0):
    return [f"MT-{i}" if i < 3 else f"g{i + offset}" for i in range(d)]


def _write_zarray(root, field, arr, chunk, *, sep=".", compressor="zlib"):
    """A zarr v2 array written with numpy and zlib (C order), as the
    Xenium cell_feature_matrix store holds its fields."""
    adir = Path(root) / field
    adir.mkdir(parents=True, exist_ok=True)
    arr = np.ascontiguousarray(arr)
    chunks = [chunk] + list(arr.shape[1:])
    comp = None if compressor is None else {"id": compressor, "level": 5}
    meta = {"zarr_format": 2, "shape": list(arr.shape), "chunks": chunks,
            "dtype": arr.dtype.str, "compressor": comp, "fill_value": 0, "order": "C",
            "filters": None, "dimension_separator": sep}
    (adir / ".zarray").write_text(json.dumps(meta))
    for i, c0 in enumerate(range(0, arr.shape[0], chunk)):
        block = np.zeros([chunk] + list(arr.shape[1:]), arr.dtype)
        part = arr[c0 : c0 + chunk]
        block[: len(part)] = part
        raw = block.tobytes()
        key = sep.join([str(i)] + ["0"] * (arr.ndim - 1))
        target = adir / key
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(raw if compressor is None else zlib.compress(raw, 5))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Inputs shared by both CLIs, written by the JAX package."""
    root = tmp_path_factory.mktemp("beans")
    w = {"root": root}
    a, b = _dense(0), _dense(1)
    w["a"], w["dense_a"] = str(root / "a.zarr"), a
    jsio.create_sparse_from_csc(sp.csc_matrix(a), w["a"], _genes(), [f"c{j}" for j in range(N)])
    w["b"] = str(root / "b.zarr")  # same genes, other cells
    jsio.create_sparse_from_csc(sp.csc_matrix(b), w["b"], _genes(), [f"d{j}" for j in range(N)])
    w["c"] = str(root / "c.zarr")  # an overlapping gene set
    jsio.create_sparse_from_csc(sp.csc_matrix(_dense(2, 30)), w["c"], _genes(30, offset=20),
                                [f"e{j}" for j in range(N)])
    for key, m, cells in (("mtx", a, "c"), ("mtx2", b, "d")):
        path = root / f"{key}.mtx"
        sio.mmwrite(str(path), sp.coo_matrix(m))
        w[key] = str(path)
        (root / f"{key}.cols.tsv").write_text("".join(f"{cells}{j}\n" for j in range(N)))
    gz = root / "mtx.mtx.gz"
    gz.write_bytes(gzip.compress(Path(w["mtx"]).read_bytes()))
    w["mtx_gz"] = str(gz)
    (root / "rows.tsv").write_text("".join(f"{g}\t{g}\tGene Expression\n" for g in _genes()))
    w["rows"] = str(root / "rows.tsv")
    (root / "cols5.txt").write_text("".join(f"c{j}\n" for j in (7, 3, 11, 40, 59)))
    (root / "rows5.txt").write_text("".join(f"{g}\n" for g in ("g9", "MT-1", "g30", "nope")))
    (root / "order.txt").write_text("".join(f"c{j}\n" for j in range(N)[::-1]))
    rng = np.random.default_rng(3)
    n_tx = 3000
    pd.DataFrame({"feature_name": rng.choice(_genes()[:25], n_tx),
                  "cell_id": [f"cell{i}" for i in rng.integers(0, 70, n_tx)],
                  "qv": rng.random(n_tx)}).to_parquet(root / "tx.parquet")
    w["tx"] = str(root / "tx.parquet")
    # a Xenium-style raw CSR store: zarr v2, zlib, several chunks; the
    # second-to-last feature is an "Aggregate" row the default filter drops
    csr = sp.csr_matrix(a)  # indptr over the features, indices the cells
    xen = root / "cfm.zarr"
    _write_zarray(xen, "cell_features/data", csr.data.astype(np.float32), 97)
    _write_zarray(xen, "cell_features/indices", csr.indices.astype(np.uint32), 97)
    _write_zarray(xen, "cell_features/indptr", csr.indptr.astype(np.uint32), 16, sep="/")
    _write_zarray(xen, "cell_features/cell_id",
                  np.stack([np.arange(N, dtype=np.uint32) * 7, np.ones(N, np.uint32)], 1), 16)
    types = ["Gene Expression"] * (D - 2) + ["Aggregate counts", "Gene Expression"]
    (xen / "cell_features" / ".zattrs").write_text(json.dumps(
        {"feature_keys": _genes(), "feature_ids": [f"ENS{i}" for i in range(D)],
         "feature_types": types}))
    (xen / ".zgroup").write_text('{"zarr_format": 2}')
    w["xenium"] = str(xen)
    shutil.make_archive(str(root / "cfm_zip"), "zip", str(xen))
    os.replace(root / "cfm_zip.zip", root / "cfm.zarr.zip")
    w["xenium_zip"] = str(root / "cfm.zarr.zip")
    # ATAC fragments over 2 chromosomes, with a peak BED
    lines = []
    for _ in range(4000):
        s = int(rng.integers(0, 60_000))
        lines.append(f"chr{rng.integers(1, 3)}\t{s}\t{s + 150}\tBC{rng.integers(0, 30):02d}"
                     f"\t{rng.integers(1, 4)}")
    frag = root / "frags.tsv.gz"
    frag.write_bytes(gzip.compress(("\n".join(lines) + "\n").encode()))
    w["frags"] = str(frag)
    (root / "peaks.bed").write_text("chr1\t100\t9000\nchr1\t20000\t31000\nchr2\t5000\t40000\n")
    w["peaks"] = str(root / "peaks.bed")
    return w


# ---- comparing stores -----------------------------------------------------------


def _root(path):
    """A store's directory (a `.zarr.zip` extracted by the port's reader)."""
    be = tsio.open_sparse_matrix(path)
    return be.path


def _docs(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f == "zarr.json":
                rel = os.path.relpath(dirpath, root)
                out[rel] = json.loads(Path(dirpath, f).read_text())
    return out


def assert_same_store(got, want):
    """Decoded arrays (both orientations) and names equal; for zarr, every
    `zarr.json` JSON-equal."""
    g, w = tsio.open_sparse_matrix(got), tsio.open_sparse_matrix(want)
    assert (g.num_rows, g.num_columns, g.num_nonzeros) == (w.num_rows, w.num_columns,
                                                           w.num_nonzeros)
    assert g.row_names() == w.row_names() and g.column_names() == w.column_names()
    cols = np.arange(w.num_columns)
    a, b = g.read_columns_csc(cols), w.read_columns_csc(cols)
    for attr in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=attr)
    rows = np.arange(w.num_rows)
    a, b = g.read_rows_csr(rows), w.read_rows_csr(rows)
    for attr in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=attr)
    if isinstance(w, tsio.ZarrBackend):
        assert _docs(_root(got)) == _docs(_root(want))


def _both(argv_of, tmp_path, suffix=".zarr"):
    """Run `argv_of(out)` through both CLIs; returns (port out, JAX out)."""
    outs = []
    for name, run in (("t", t_beans), ("j", j_beans)):
        out = str(tmp_path / f"{name}{suffix}")
        run(argv_of(out))
        outs.append(out)
    return outs


BUILDS = {
    "from-mtx": lambda w, o: ["from-mtx", "--mtx", w["mtx"], "--rows", w["rows"], "--cols",
                              str(w["root"] / "mtx.cols.tsv"), "--output", o],
    "from-mtx-gz-streaming": lambda w, o: ["from-mtx", "--mtx", w["mtx_gz"], "--rows", w["rows"],
                                           "--output", o, "--streaming"],
    "from-mtx-squeeze": lambda w, o: ["from-mtx", "--mtx", w["mtx"], "--output", o,
                                      "--do-squeeze", "--row-nnz-cutoff", "25",
                                      "--column-nnz-cutoff", "18"],
    "merge-mtx": lambda w, o: ["merge-mtx", w["mtx"], w["mtx2"], "--rows", w["rows"], "--cols",
                               str(w["root"] / "mtx.cols.tsv"), str(w["root"] / "mtx.cols.tsv"),
                               "--output", o],
    "from-triplets": lambda w, o: ["from-triplets", "--table", w["tx"], "--output", o],
    "from-zarr": lambda w, o: ["from-zarr", w["xenium"], "--output", o],
    "from-zarr-zip-squeeze": lambda w, o: ["from-zarr", w["xenium_zip"], "-o", o, "--do-squeeze",
                                           "--row-nnz-cutoff", "20"],
    "from-fragments": lambda w, o: ["from-fragments", "--fragments", w["frags"], "--output", o,
                                    "--tile-size", "4000"],
    "from-fragments-peaks": lambda w, o: ["from-fragments", "--fragments", w["frags"],
                                          "--output", o, "--peaks", w["peaks"]],
    "subset": lambda w, o: ["subset", w["a"], "--output", o, "--columns",
                            str(w["root"] / "cols5.txt"), "--rows", str(w["root"] / "rows5.txt")],
    "subsample": lambda w, o: ["subsample", w["a"], "--output", o, "--cells", "25", "--gene-frac",
                               "0.5", "--seed", "7"],
    "take-order": lambda w, o: ["reorder", w["a"], "--columns", str(w["root"] / "order.txt"),
                                "--output", o],
    "squeeze": lambda w, o: ["squeeze", w["a"], "--output", o, "--min-row-total", "40"],
    "sort-rows": lambda w, o: ["sort-rows", w["a"], "--rows", str(w["root"] / "rows5.txt"),
                               "--output", o],
    "merge-backend": lambda w, o: ["merge-backend", w["a"], w["b"], "--output", o],
    "convert": lambda w, o: ["convert", w["a"], "--output", o],
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_builders_write_jax_stores(ws, tmp_path, name):
    got, want = _both(lambda o: BUILDS[name](ws, o), tmp_path)
    assert_same_store(got, want)


def test_convert_to_zip_and_h5_and_back(ws, tmp_path):
    got, want = (o + ".zip" for o in _both(lambda o: ["convert", ws["a"], "--output", o, "--zip"],
                                           tmp_path))
    assert os.path.exists(got) and os.path.exists(want)
    assert_same_store(got, want)
    back, back_j = _both(lambda o: ["convert", got, "--output", o], tmp_path / "z")
    assert_same_store(back, back_j)
    assert_same_store(back, ws["a"])
    h5, h5_j = _both(lambda o: ["convert", ws["a"], "--output", o], tmp_path, suffix=".h5")
    assert_same_store(h5, h5_j)


def test_align_writes_jax_stores(ws, tmp_path):
    outs = {}
    for name, run in (("t", t_beans), ("j", j_beans)):
        d = tmp_path / name
        d.mkdir()
        ins = [shutil.copytree(ws[k], d / f"{k}.zarr") for k in ("a", "c")]
        run(["align", *map(str, ins)])
        outs[name] = [str(d / f"{k}.aligned") for k in ("a", "c")]
    for got, want in zip(outs["t"], outs["j"]):
        assert_same_store(got, want)


def test_streaming_writer_equals_the_in_memory_writer(tmp_path, monkeypatch):
    """Several slabs, a forced small chunk (many chunks, a padded edge
    chunk, all-zero chunks, which are not stored) and small
    gene-chunk passes: every file byte-equal to `create_sparse_from_csc`;
    at the default chunk, JSON- and decode-equal to JAX's writer."""
    rng = np.random.default_rng(5)
    m = _dense(6, 70, 400)
    m[:, :150] = 0
    m[0, :150] = 2  # cells holding gene 0 alone: all-zero index chunks
    m[3, 150:] = rng.integers(1, 5, 250)  # a dense row
    csc = sp.csc_matrix(m)
    names = ([f"r{i}" for i in range(70)], [f"c{j}" for j in range(400)])
    monkeypatch.setattr(tsio, "_CHUNK", 64)
    monkeypatch.setattr(tsio.StreamingCscWriter, "MAX_CHUNK_NNZ", 300)
    tsio.create_sparse_from_csc(csc, str(tmp_path / "mem.zarr"), *names)
    w = tsio.StreamingCscWriter(str(tmp_path / "st.zarr"), 70, row_names=names[0], gene_chunk=9)
    for lb in range(0, 400, 37):
        w.append(csc[:, lb : lb + 37])
    w.finalize(column_names=names[1])
    files = sorted(str(p.relative_to(tmp_path / "mem.zarr"))
                   for p in (tmp_path / "mem.zarr").rglob("*") if p.is_file())
    got = sorted(str(p.relative_to(tmp_path / "st.zarr"))
                 for p in (tmp_path / "st.zarr").rglob("*") if p.is_file())
    assert files == got and any("/c/" in f for f in files)
    assert len([f for f in files if f.startswith("by_column/indices/c/")]) < -(-csc.nnz // 64)
    for f in files:
        assert (tmp_path / "mem.zarr" / f).read_bytes() == (tmp_path / "st.zarr" / f).read_bytes(), f
    monkeypatch.setattr(tsio, "_CHUNK", 1 << 20)
    paths = []
    for mod in (tsio, jsio):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.zarr")
        w = mod.StreamingCscWriter(path, 70, row_names=names[0])
        for lb in range(0, 400, 150):
            w.append(csc[:, lb : lb + 150])
        w.finalize(column_names=names[1])
        paths.append(path)
    assert_same_store(*paths)


def test_streaming_ingest_bounds_resident_nonzeros(tmp_path):
    rng = np.random.default_rng(1)
    d, n, total, chunk = 50, 4000, 100_000, 10_000

    def chunks():
        for _ in range(total // chunk):
            yield rng.integers(0, d, chunk), rng.integers(0, n, chunk), np.ones(chunk, np.float32)

    backend, sorter = build_streaming_from_triplet_chunks(
        chunks(), str(tmp_path / "big.zarr"), n_rows=d, n_cols=n, chunk_nnz=chunk, slab_cols=256)
    assert sorter.total_nnz == total
    assert backend.read_columns_csc(np.arange(n)).sum() == total
    # one pending chunk, or one merged slab: never more than two chunk budgets
    assert sorter.peak_resident_nnz <= 2 * chunk, sorter.peak_resident_nnz
    assert not (tmp_path / "big.zarr.sortspill").exists()
    assert not (tmp_path / "big.zarr.spill").exists()


def test_mtx_python_parser_equals_native(ws, tmp_path, monkeypatch, caplog):
    assert tio.parser() == "native"
    native = tb.from_mtx(ws["mtx_gz"], str(tmp_path / "n.zarr"), streaming=True)
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_tried", False)
    monkeypatch.setattr(tio, "_build", lambda: (_ for _ in ()).throw(OSError("no g++")))
    with caplog.at_level("WARNING"):
        assert tio.parser() == "python"
    assert "python parsers" in caplog.text
    py = tb.from_mtx(ws["mtx_gz"], str(tmp_path / "p.zarr"), streaming=True)
    assert_same_store(py.path, native.path)
    py2 = tb.from_mtx(ws["mtx"], str(tmp_path / "p2.zarr"), streaming=False)
    assert_same_store(py2.path, native.path)


# ---- printed, TSV and parquet outputs -------------------------------------------


def _printed(capsys, run, argv):
    capsys.readouterr()
    run(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["info", "{a}"], ["stat", "{a}"], ["list-rows", "{a}"], ["list-columns", "{a}"],
    ["list-zarr", "{a}"], ["list-zarr", "{xenium_zip}"], ["histogram", "{a}", "--bins", "7"],
], ids=lambda a: "-".join(a[:2]).replace("{", "").replace("}", ""))
def test_printed_outputs_equal_jax(ws, capsys, argv):
    argv = [x.format(**ws) for x in argv]
    extra = ["--device", "cpu"] if argv[0] == "histogram" else []
    assert _printed(capsys, t_beans, argv + extra) == _printed(capsys, j_beans, argv)


@pytest.mark.parametrize("cmd,names", [("take-columns", "cols5.txt"), ("take-rows", "rows5.txt")])
def test_take_tsv_equal_jax(ws, tmp_path, capsys, cmd, names):
    flag = "--columns" if cmd == "take-columns" else "--rows"
    outs = []
    for name, run in (("t", t_beans), ("j", j_beans)):
        out = str(tmp_path / f"{name}.tsv.gz")
        printed = _printed(capsys, run, [cmd, ws["a"], flag, str(ws["root"] / names),
                                         "--output", out])
        outs.append((gzip.open(out, "rt").read(), printed.replace(out, "")))
    assert outs[0] == outs[1]


def test_qc_equals_jax(ws, tmp_path):
    """Statistics within 1e-6 (whole counts: equal), masks equal, the
    report and the gene table equal."""
    flags = ["--min-genes", "5", "--max-mito-frac", "0.3", "--mads", "3", "--ribo-pattern", "^g1",
             "--feature-min-cells", "10", "--report"]
    t_beans(["qc", ws["a"], "--output", str(tmp_path / "t"), "--device", "cpu", *flags])
    j_beans(["qc", ws["a"], "--output", str(tmp_path / "j"), *flags])
    t, j = (pd.read_parquet(tmp_path / f"{x}.qc.parquet") for x in "tj")
    assert list(t.columns) == list(j.columns) and (t.cell == j.cell).all()
    for c in ("total", "n_genes", "mito_frac", "ribo_frac"):
        np.testing.assert_allclose(t[c], j[c], rtol=1e-6, atol=0, err_msg=c)
    np.testing.assert_array_equal(t.keep, j.keep)
    assert 0 < t.keep.sum() < len(t)
    assert pd.read_parquet(tmp_path / "t.qc.features.parquet").equals(
        pd.read_parquet(tmp_path / "j.qc.features.parquet"))
    rt, rj = (json.loads((tmp_path / f"{x}.qc.report.json").read_text()) for x in "tj")
    assert rt.keys() == rj.keys()
    for k in rj:
        assert rt[k] == pytest.approx(rj[k], rel=1e-6), k


def test_to_mtx_equals_jax(ws, tmp_path):
    t_beans(["to-mtx", ws["a"], "--output", str(tmp_path / "t")])
    j_beans(["to-mtx", ws["a"], "--output", str(tmp_path / "j")])
    for part in ("matrix.mtx.gz", "features.tsv.gz", "barcodes.tsv.gz"):
        assert gzip.open(tmp_path / f"t.{part}").read() == gzip.open(tmp_path / f"j.{part}").read()


def test_tile_cache_refuses(ws):
    with pytest.raises(SystemExit, match="COO"):
        t_beans(["tile-cache", ws["a"]])


def test_python_m_entry_runs_data_beans(ws, capsys):
    assert port_cli(["data-beans", "info", ws["a"]]) == 0
    assert capsys.readouterr().out.splitlines() == ["rows: 40", "cols: 60", "nnz: " + str(
        int((ws["dense_a"] != 0).sum()))]


# ---- h5 -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def h5_inputs(ws):
    h5py = pytest.importorskip("h5py")
    root, a = ws["root"], ws["dense_a"]
    csc = sp.csc_matrix(a)
    tenx = root / "tenx.h5"
    with h5py.File(tenx, "w") as f:
        g = f.create_group("matrix")
        for k, v in (("data", csc.data.astype(np.int32)), ("indices", csc.indices),
                     ("indptr", csc.indptr), ("shape", np.asarray(csc.shape))):
            g.create_dataset(k, data=v)
        g.create_dataset("barcodes", data=np.asarray([f"c{j}" for j in range(N)], "S"))
        g.create_group("features").create_dataset("name", data=np.asarray(_genes(), "S"))
    mol = root / "mol.h5"
    rng = np.random.default_rng(9)
    n_mol = 900
    with h5py.File(mol, "w") as f:
        f.create_dataset("barcode_idx", data=rng.integers(0, 80, n_mol))
        f.create_dataset("feature_idx", data=rng.integers(0, D, n_mol))
        f.create_dataset("count", data=rng.integers(1, 4, n_mol))
        f.create_dataset("barcodes", data=np.asarray([f"b{j}" for j in range(80)], "S"))
        f.create_group("features").create_dataset("name", data=np.asarray(_genes(), "S"))
    h5ad = root / "a.h5ad"
    j_beans(["to-h5ad", ws["a"], "--output", str(h5ad)])
    return {"tenx": str(tenx), "mol": str(mol), "h5ad": str(h5ad)}


@pytest.mark.parametrize("cmd", ["from-h5ad", "from-10x-matrix", "from-10x-molecule",
                                 "from-h5ad-squeeze"])
def test_h5_builders_write_jax_stores(h5_inputs, tmp_path, cmd):
    argv = {"from-h5ad": lambda o: ["from-h5ad", "--h5ad", h5_inputs["h5ad"], "--output", o],
            "from-10x-matrix": lambda o: ["from-10x-matrix", "--h5", h5_inputs["tenx"],
                                          "--output", o],
            "from-10x-molecule": lambda o: ["from-10x-molecule", "--h5", h5_inputs["mol"],
                                            "--output", o, "--min-umi", "2"],
            "from-h5ad-squeeze": lambda o: ["from-h5ad", "--h5ad", h5_inputs["h5ad"], "--output",
                                            o, "--do-squeeze", "--row-nnz-cutoff", "30"]}[cmd]
    got, want = _both(argv, tmp_path)
    assert_same_store(got, want)


def test_to_h5ad_and_list_h5_equal_jax(ws, h5_inputs, tmp_path, capsys):
    import h5py

    pd.DataFrame({"cell": [f"c{j}" for j in range(N)], "grp": np.arange(N) % 3}).to_parquet(
        tmp_path / "obs.parquet")
    outs = _both(lambda o: ["to-h5ad", ws["a"], "--output", o, "--obs",
                            str(tmp_path / "obs.parquet")], tmp_path, suffix=".h5ad")
    items = []
    for path in outs:
        got = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: got.__setitem__(name, np.asarray(obj[...]) if isinstance(
                obj, h5py.Dataset) else dict(obj.attrs)))
        items.append(got)
    assert items[0].keys() == items[1].keys()
    for k in items[1]:
        if isinstance(items[1][k], dict):
            assert str(items[0][k]) == str(items[1][k]), k
        else:
            np.testing.assert_array_equal(items[0][k], items[1][k], err_msg=k)
    assert (_printed(capsys, t_beans, ["list-h5", outs[0]])
            == _printed(capsys, j_beans, ["list-h5", outs[1]]))


def test_h5_commands_without_h5py_name_it(ws, h5_inputs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for argv in (["from-h5ad", "--h5ad", h5_inputs["h5ad"], "--output", str(tmp_path / "x")],
                 ["to-h5ad", ws["a"], "--output", str(tmp_path / "x.h5ad")],
                 ["list-h5", h5_inputs["tenx"]]):
        with pytest.raises(ImportError, match="h5py"):
            t_beans(argv)


# ---- parsers ---------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _subparsers(run, monkeypatch, prog_argv):
    def grab(self, argv=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        run(prog_argv)
    monkeypatch.undo()
    parser = e.value.args[0]
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or (a.dest,)): (a.dest, a.default, a.nargs,
                                                            getattr(a.type, "__name__", a.type),
                                                            a.choices, a.required)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_parsers_carry_jax_flags_and_defaults(monkeypatch):
    from legume_tpu.cli.sim_cli import run_sim as j_sim
    from legume_tpu_torch.cli.sim_cli import run_sim as t_sim

    for t_run, j_run, device_cmds in ((t_beans, j_beans, {"qc", "histogram"}),
                                      (t_sim, j_sim, set())):
        got = _subparsers(t_run, monkeypatch, ["info", "x"])
        want = _subparsers(j_run, monkeypatch, ["info", "x"])
        assert got.keys() == want.keys()
        for cmd in want:
            flags = dict(got[cmd])
            if cmd in device_cmds:
                assert flags.pop(("--device",))[1] == "cuda"
            assert flags == want[cmd], cmd


# ---- raw zarr fields --------------------------------------------------------------


def _compress(raw, codec, itemsize):
    if codec == "zlib":
        return zlib.compress(raw, 5)
    if codec == "gzip":
        return gzip.compress(raw, 5)
    if codec == "zstd":
        import pyarrow as pa

        return pa.Codec("zstd", compression_level=3).compress(raw, asbytes=True)
    from legume_tpu_torch.data import blosc_codec

    return blosc_codec.compress(raw, itemsize)


@pytest.mark.parametrize("codec", [None, "zlib", "gzip", "zstd", "blosc"])
@pytest.mark.parametrize("sep", [".", "/"])
def test_raw_zarr_v2_fields_equal_jax(tmp_path, codec, sep):
    """A 2-d C-order v2 array in chunks of 7 x 2 (edge chunks padded,
    one chunk missing: the fill value), read by both packages."""
    from legume_tpu.data.zarr_raw import read_zarr_numeric as j_read
    from legume_tpu_torch.data import blosc_codec
    from legume_tpu_torch.data.zarr_raw import read_zarr_numeric as t_read

    if codec == "blosc" and not blosc_codec.available():
        pytest.skip("no libblosc on this host")
    arr = np.arange(20 * 3, dtype="<i4").reshape(20, 3) * 3 - 7
    adir = tmp_path / "s.zarr" / "grp" / "x"
    adir.mkdir(parents=True)
    comp = None if codec is None else {"id": codec, **({"level": 5} if codec != "blosc" else {
        "cname": "blosclz", "clevel": 5, "shuffle": 1, "blocksize": 0})}
    (adir / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [20, 3], "chunks": [7, 2], "dtype": "<i4", "compressor": comp,
        "fill_value": 5, "order": "C", "filters": None, "dimension_separator": sep}))
    for i in range(3):
        for j in range(2):
            if (i, j) == (1, 1):
                continue  # missing: reads as the fill value
            block = np.zeros((7, 2), "<i4")
            part = arr[i * 7 : (i + 1) * 7, j * 2 : (j + 1) * 2]
            block[: part.shape[0], : part.shape[1]] = part
            raw = block.tobytes()
            target = adir / f"{i}{sep}{j}"
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(raw if codec is None else _compress(raw, codec, 4))
    got = t_read(str(tmp_path / "s.zarr"), "/grp/x")
    np.testing.assert_array_equal(got, j_read(str(tmp_path / "s.zarr"), "/grp/x"))
    want = arr.copy()
    want[7:14, 2:] = 5
    np.testing.assert_array_equal(got, want)


def test_raw_zarr_blosc_without_libblosc_names_it(tmp_path, monkeypatch):
    from legume_tpu_torch.data import blosc_codec
    from legume_tpu_torch.data.zarr_raw import read_zarr_numeric

    adir = tmp_path / "s.zarr" / "x"
    adir.mkdir(parents=True)
    (adir / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4", "fill_value": 0,
        "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}, "order": "C",
        "filters": None}))
    (adir / "0").write_bytes(b"\x02\x01\x21\x04" + bytes(28))
    monkeypatch.setattr(blosc_codec, "available", lambda: False)
    with pytest.raises(ImportError, match="libblosc"):
        read_zarr_numeric(str(tmp_path / "s.zarr"), "x")


@pytest.mark.parametrize("zipped", [False, True])
def test_raw_zarr_v3_fields_equal_jax(ws, tmp_path, zipped):
    """A v3 field (a store's own `by_column/data`) from a directory and
    from a `.zip` of it, read by both packages."""
    from legume_tpu.data.zarr_raw import read_zarr_numeric as j_read
    from legume_tpu_torch.data.zarr_raw import read_zarr_numeric as t_read

    path = ws["a"]
    if zipped:
        path = shutil.make_archive(str(tmp_path / "a"), "zip", ws["a"])
    got = t_read(path, "/by_column/data")
    np.testing.assert_array_equal(got, j_read(path, "/by_column/data"))
    np.testing.assert_array_equal(got, sp.csc_matrix(ws["dense_a"]).data)
