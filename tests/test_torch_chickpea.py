"""The port's `chickpea` (`legume_tpu_torch/chickpea/p2g.py`,
`cli/chickpea_cli.py`) and knockoffs (`ops/knockoff.py`) against the JAX
package's, on the CPU.

- The knockoff constructions (equi, me, mvr) and `knockoff_filter` give
  JAX's arrays exactly (numpy copies).
- `peak_to_gene` on the same pseudobulks: the same links, PIPs and
  effects within 1e-4, and the same knockoff selection.
- `chickpea p2g` through both CLIs, plain and `--pseudobulk` (with
  batches, `--use-adjusted`, `--qc`, `--loco` and `--knockoff-fdr`): the
  same pseudobulk partition (K1 and K3's plain versions here), the same
  links, PIPs and effects within 1e-4. `from-multiome` writes the same
  stores and fragments. The parser trees are equal but for `--device` on
  `p2g`.
- The JAX package's own recovery bars (`tests/test_chickpea.py`,
  `tests/test_cli_surface.py`) hold for the port.
"""

import argparse
import gzip

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.chickpea import p2g as jp2g
from legume_tpu.cli.main import run_chickpea as j_chickpea
from legume_tpu.ops import knockoff as jko
from legume_tpu_torch.chickpea import p2g as tp2g
from legume_tpu_torch.cli.main import run_chickpea as t_chickpea
from legume_tpu_torch.cli.main import run_sim as t_sim
from legume_tpu_torch.data import open_sparse_matrix
from legume_tpu_torch.ops import knockoff as tko
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def multiome_sim():
    """Paired RNA + ATAC pseudobulks, each gene driven by one true peak."""
    rng = np.random.default_rng(0)
    n, g, k = 200, 8, 60
    activity = rng.standard_normal((n, k))
    atac = rng.poisson(np.exp(0.5 * activity + 2.0)).astype(np.float64)
    true_peak = rng.choice(k, g, replace=False)
    rna = rng.poisson(np.exp(0.8 * activity[:, true_peak] + 2.0)).astype(np.float64)
    cis = {}
    for gi in range(g):
        decoys = rng.choice(np.setdiff1d(np.arange(k), [true_peak[gi]]), 9, replace=False)
        cis[gi] = np.sort(np.concatenate([[true_peak[gi]], decoys]))
    return rna, atac, cis, true_peak


@pytest.mark.parametrize("s_method", ["equi", "me", "mvr"])
def test_knockoffs_equal_jax(s_method):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80, 12)) @ rng.standard_normal((12, 12))
    a = jko.second_order_knockoffs(x, seed=4, eps=1e-3, s_method=s_method)
    b = tko.second_order_knockoffs(x, seed=4, eps=1e-3, s_method=s_method)
    assert np.array_equal(a, b)
    corr = np.corrcoef(x, rowvar=False)
    assert np.array_equal(jko.knockoff_s_equicorrelated(corr), tko.knockoff_s_equicorrelated(corr))
    w = rng.standard_normal(200) + np.r_[np.full(20, 3.0), np.zeros(180)]
    for fdr in (0.05, 0.2, 0.5):
        ta, sa = jko.knockoff_filter(w, fdr=fdr)
        tb, sb = tko.knockoff_filter(w, fdr=fdr)
        assert ta == tb and np.array_equal(sa, sb)


def test_peak_to_gene_matches_jax(multiome_sim):
    rna, atac, cis, _ = multiome_sim
    kw = dict(rank=30, L=2, num_steps=20, knockoff_fdr=0.2, seed=1)
    a = jp2g.peak_to_gene(rna, atac, cis, **kw)
    b = tp2g.peak_to_gene(rna, atac, cis, device="cpu", **kw)
    assert a.gene == b.gene and a.peak == b.peak
    assert np.abs(a.pip - b.pip).max() <= 1e-4 and np.abs(a.effect - b.effect).max() <= 1e-4
    assert np.array_equal(a.knockoff_selected, b.knockoff_selected)


class _Parsed(Exception):
    pass


def _subparsers(run, monkeypatch):
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        run(["p2g"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or (a.dest,)): (a.dest, a.default, a.nargs,
                                                            getattr(a.type, "__name__", a.type),
                                                            a.choices, a.required)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_chickpea_parser_carries_jax_flags_and_defaults(monkeypatch):
    got, want = _subparsers(t_chickpea, monkeypatch), _subparsers(j_chickpea, monkeypatch)
    assert list(got) == list(want) == ["p2g", "from-multiome"]
    flags = dict(got["p2g"])
    assert flags.pop(("--device",))[1] == "cuda"
    assert flags == want["p2g"] and got["from-multiome"] == want["from-multiome"]


@pytest.fixture(scope="module")
def multiome_files(tmp_path_factory):
    """`data-beans-sim multiome` cells (the port's writer), with two batches."""
    tmp = tmp_path_factory.mktemp("mo")
    out = str(tmp / "mo")
    t_sim(["multiome", "--genes", "6", "--peaks", "40", "--cols", "300", "--factors", "3",
           "--output", out])
    (tmp / "batch.txt").write_text("".join(f"b{j % 2}\n" for j in range(300)))
    return {"tmp": tmp, "out": out, "batch": str(tmp / "batch.txt")}


def _p2g_both(files, tmp, extra):
    out = files["out"]
    base = ["p2g", "--rna", f"{out}.rna.zarr", "--atac", f"{out}.atac.zarr", "--gff",
            f"{out}.genes.gff", "--cis-window", "20000", "--steps", "20", "-L", "2"]
    res = {}
    for side, run, dev in (("j", j_chickpea, []), ("t", t_chickpea, ["--device", "cpu"])):
        run(base + ["--out", str(tmp / side)] + extra + dev)
        res[side] = pd.read_parquet(tmp / f"{side}.p2g.parquet")
    return res["j"], res["t"]


@pytest.mark.parametrize("mode", ["plain", "pseudobulk"])
def test_cli_p2g_matches_jax(multiome_files, tmp_path, mode, capsys):
    extra = ["--knockoff-fdr", "0.2", "--loco", "--rank", "8"]
    if mode == "pseudobulk":
        extra += ["--pseudobulk", "--sort-dim", "5", "--proj-dim", "10", "--batch-files",
                  multiome_files["batch"], "--use-adjusted", "--qc", "--iter-opt", "5"]
    a, b = _p2g_both(multiome_files, tmp_path, extra)
    assert list(a.columns) == list(b.columns) and len(a) == len(b) > 0
    assert a["gene"].tolist() == b["gene"].tolist() and a["peak"].tolist() == b["peak"].tolist()
    assert np.abs(a["pip"] - b["pip"]).max() <= 1e-4
    assert np.abs(a["effect"] - b["effect"]).max() <= 1e-4
    assert a["selected"].tolist() == b["selected"].tolist()
    if mode == "pseudobulk":  # the same number of pseudobulks, from the same partition
        said = [ln for ln in capsys.readouterr().out.splitlines() if "pseudobulk mode" in ln]
        assert len(said) == 2 and said[0] == said[1]
    with gzip.open(tmp_path / "j.p2g.bed.gz", "rt") as f, gzip.open(tmp_path / "t.p2g.bed.gz",
                                                                     "rt") as g:
        ja, tb = f.read().splitlines(), g.read().splitlines()
    assert [ln.split("\t")[:4] for ln in ja] == [ln.split("\t")[:4] for ln in tb]


def _multiome_h5(tmp, n_cells=400, n_genes=30, n_peaks=40, seed=9):
    """A 10x multiome h5 with peak 7's activity driving gene 3."""
    import h5py

    rng = np.random.default_rng(seed)
    act = rng.gamma(2.0, 1.0, n_cells)
    atac = rng.poisson(1.0, (n_peaks, n_cells)).astype(np.float32)
    atac[7] = rng.poisson(3.0 * act)
    rna = rng.poisson(2.0, (n_genes, n_cells)).astype(np.float32)
    rna[3] = rng.poisson(4.0 * act)
    x = sp.csc_matrix(np.vstack([rna, atac]))
    h5 = str(tmp / "multi.h5")
    names = [f"g{i}".encode() for i in range(n_genes)] + [
        f"chr1:{1000 * i}-{1000 * i + 500}".encode() for i in range(n_peaks)]
    with h5py.File(h5, "w") as f:
        g = f.create_group("matrix")
        g["data"], g["indices"], g["indptr"] = x.data, x.indices, x.indptr
        g["shape"] = np.asarray(x.shape)
        g["barcodes"] = np.asarray([f"BC{j}".encode() for j in range(n_cells)])
        ff = g.create_group("features")
        ff["name"] = np.asarray(names)
        ff["feature_type"] = np.asarray([b"Gene Expression"] * n_genes + [b"Peaks"] * n_peaks)
    frag = tmp / "frags.tsv.gz"
    with gzip.open(frag, "wt") as f:
        f.write("# comment\nchr1\t100\t600\tBC0\t2\nchr1\t100\t600\tUNMATCHED\t1\n")
    return h5, str(frag)


def test_from_multiome_and_pseudobulk_p2g(tmp_path):
    """`tests/test_chickpea.py`'s from-multiome + `p2g --pseudobulk` bar on
    the port: the stores and fragments equal JAX's, and the driving peak
    ranks first."""
    pytest.importorskip("h5py")
    h5, frag = _multiome_h5(tmp_path)
    for side, run in (("j", j_chickpea), ("t", t_chickpea)):
        run(["from-multiome", h5, "--out", str(tmp_path / side), "--fragments", frag])
    for kind in ("rna", "atac"):
        a = open_sparse_matrix(str(tmp_path / f"j.{kind}.zarr"))
        b = open_sparse_matrix(str(tmp_path / f"t.{kind}.zarr"))
        assert a.row_names() == b.row_names() and a.column_names() == b.column_names()
        cols = np.arange(a.num_columns)
        assert (a.read_columns_csc(cols) != b.read_columns_csc(cols)).nnz == 0
    assert (gzip.open(tmp_path / "j.fragments.tsv.gz").read()
            == gzip.open(tmp_path / "t.fragments.tsv.gz").read())
    gff = tmp_path / "genes.gff"
    gff.write_text("chr1\tx\tgene\t7000\t7100\t.\t+\t.\tgene_name=g3\n")
    out = str(tmp_path / "pp")
    t_chickpea(["p2g", "--rna", str(tmp_path / "t.rna.zarr"), "--atac",
                str(tmp_path / "t.atac.zarr"), "--gff", str(gff), "--out", out, "--pseudobulk",
                "--sort-dim", "5", "--proj-dim", "10", "--cis-window", "8000", "--rank", "8",
                "--steps", "300", "--prior-var", "5.0", "--device", "cpu"])
    g3 = pd.read_parquet(out + ".p2g.parquet").query("gene == 'g3'").sort_values(
        "pip", ascending=False)
    assert len(g3) > 1 and g3.iloc[0]["peak"] == "chr1:7000-7500"


# ---- the JAX package's recovery bars, on the port ------------------------------


def test_peak_to_gene_recovers_true_peaks(multiome_sim):
    rna, atac, cis, true_peak = multiome_sim
    links = tp2g.peak_to_gene(rna, atac, cis, rank=30, L=2, num_steps=800, seed=1, device="cpu")
    assert len(links.gene) == sum(len(v) for v in cis.values())
    hits = 0
    for gi in range(rna.shape[1]):
        rows = [i for i, g in enumerate(links.gene) if g == gi]
        pk = np.asarray([links.peak[i] for i in rows])
        hits += pk[np.argmax(links.pip[rows])] == true_peak[gi]
    assert hits >= rna.shape[1] - 2


def test_peak_to_gene_knockoff_filter(multiome_sim):
    rna, atac, cis, true_peak = multiome_sim
    links = tp2g.peak_to_gene(rna, atac, cis, rank=30, L=2, num_steps=300, knockoff_fdr=0.2,
                              seed=2, device="cpu")
    sel = links.knockoff_selected
    assert sel is not None and sel.shape == links.pip.shape
    if sel.any():
        is_true = np.asarray([links.peak[i] == true_peak[links.gene[i]] for i in range(len(sel))])
        assert is_true[sel].mean() >= is_true.mean()


def test_chickpea_p2g_recovers_driving_peaks(tmp_path):
    out = str(tmp_path / "mo")
    t_sim(["multiome", "--genes", "20", "--peaks", "60", "--cols", "400", "--factors", "4",
           "--output", out])
    fit = str(tmp_path / "p2g")
    t_chickpea(["p2g", "--rna", f"{out}.rna.zarr", "--atac", f"{out}.atac.zarr", "--gff",
                f"{out}.genes.gff", "--out", fit, "--cis-window", "20000", "--steps", "300",
                "-L", "2", "--device", "cpu"])
    links = pd.read_parquet(f"{fit}.p2g.parquet")
    truth = pd.read_parquet(f"{out}.truth.parquet").set_index("gene")["peak"]
    assert (tmp_path / "p2g.p2g.bed.gz").exists() and (tmp_path / "p2g.chickpea.json").exists()
    pctls = []
    for gene, grp in links.groupby("gene"):
        m = grp["peak"] == truth.loc[gene]
        if m.any():
            pctls.append(float(grp["pip"].rank(pct=True)[m].iloc[0]))
    assert len(pctls) >= 15 and float(np.median(pctls)) > 0.7


def test_main_dispatches_chickpea(capsys):
    from legume_tpu_torch.cli.main import main

    with pytest.raises(SystemExit):
        main(["chickpea", "--help"])
    assert "from-multiome" in capsys.readouterr().out
