"""`faba index` / `faba genes` and cell calling in the port
(`faba/genes.py`, `faba/cell_calling.py`, `cli/faba_cmds/genes_cmds.py`)
against the JAX package's, on the CPU, and the port's `faba` parser tree.

The BAM is the port's simulated 10x-style run (`faba/bam_sim.py`: CB,
UB and GX tags, junction, exonic and intronic reads, PCR duplicates, a
few `chrM` genes). Gene counts equal the planted UMI counts and the JAX
package's matrices exactly; cell calling's categorical draws, null
snapshots and masks equal JAX's exactly (the same threefry stream and
XLA's cumsum order); the stores both CLIs write decode equal.
"""

import argparse

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import cell_calling as jcc
from legume_tpu.faba import genes as jgenes
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.data import sparse_io as tsio
from legume_tpu_torch.faba import bam_sim
from legume_tpu_torch.faba import cell_calling as tcc
from legume_tpu_torch.faba import genes as tgenes
from legume_tpu_torch.utils import prng


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("genes")
    bam, gff = str(tmp / "a.bam"), str(tmp / "a.gff")
    out = bam_sim.simulate_10x_bam(bam, gff, n_cells=160, n_genes=48, umis_per_cell=60,
                                   n_mito=3, seed=3)
    bam2 = str(tmp / "b.bam")
    out2 = bam_sim.simulate_10x_bam(bam2, str(tmp / "b.gff"), n_cells=90, n_genes=48,
                                    umis_per_cell=30, n_mito=3, seed=4)
    return dict(out, bam=bam, gff=gff, bam2=bam2, sim2=out2, tmp=tmp)


def _eq(a: sp.spmatrix, b: sp.spmatrix):
    assert a.shape == b.shape and (a != b).nnz == 0


def test_spliced_counts_equal_planted_and_jax(sim):
    s, u, genes, barcodes = tgenes.count_genes_spliced(sim["bam"], sim["gff"])
    _eq(s, sim["spliced"])
    _eq(u, sim["unspliced"])
    assert genes == sim["genes"] and barcodes == sim["barcodes"]
    js, ju, jg, jb = jgenes.count_genes_spliced(sim["bam"], sim["gff"])
    _eq(s, js)
    _eq(u, ju)
    assert (genes, barcodes) == (jg, jb)
    s2, u2, _, _ = tgenes.count_genes_spliced(sim["bam"], sim["gff"], gene_barcode_tag="GX")
    _eq(s2, s)
    _eq(u2, u)


@pytest.mark.parametrize("kw", [{}, {"dedup_umi": False}, {"min_mapq": 61},
                                {"gene_barcode_tag": "GX"}, {"gene_type": "protein_coding"}])
def test_count_genes_equal_jax(sim, kw):
    c, genes, barcodes = tgenes.count_genes(sim["bam"], sim["gff"], **kw)
    jc, jg, jb = jgenes.count_genes(sim["bam"], sim["gff"], **kw)
    _eq(c, jc)
    assert (genes, barcodes) == (jg, jb)
    if not kw:
        _eq(c, sim["spliced"] + sim["unspliced"])


def test_gff_exons_and_read_assignment_equal_jax(sim):
    model = tgenes.parse_gff_genes(sim["gff"])
    jmodel = jgenes.parse_gff_genes(sim["gff"])
    t_ex, j_ex = tgenes.parse_gff_exons(sim["gff"], model), jgenes.parse_gff_exons(sim["gff"], jmodel)
    assert t_ex.keys() == j_ex.keys()
    for g in t_ex:
        np.testing.assert_array_equal(t_ex[g], j_ex[g])
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 5, 3000)
    pos = rng.integers(0, 250_000, 3000)
    end = pos + rng.integers(1, 2000, 3000)
    names = [f"chr{i + 1}" for i in range(4)] + ["chrM"]
    np.testing.assert_array_equal(tgenes.assign_reads_to_genes(ref, pos, end, names, model),
                                  jgenes.assign_reads_to_genes(ref, pos, end, names, jmodel))
    # the vectorised exon test against the JAX package's per-read search
    gene = rng.integers(0, len(model.names), 3000)
    want = np.asarray([
        (lambda ivs, j: j >= 0 and pos[i] >= ivs[j, 0] and end[i] <= ivs[j, 1])(
            j_ex[int(gene[i])], np.searchsorted(j_ex[int(gene[i])][:, 0], pos[i], "right") - 1)
        for i in range(3000)])
    np.testing.assert_array_equal(tgenes._inside_one_exon(t_ex, gene, pos, end), want)


# ---- cell calling ----------------------------------------------------------------


@pytest.mark.parametrize("seed,g,n,t", [(0, 40, 3, 17), (5, 300, 7, 50), (9, 1, 2, 4)])
def test_categorical_draws_equal_jax(seed, g, n, t):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(g, 0.4)) + 1e-9
    logits = np.log(probs / probs.sum()).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jnp.asarray(logits),
                                             shape=(n, t)))
    got = tcc.categorical_draws(prng.key(seed), torch.from_numpy(logits), n, t).numpy()
    np.testing.assert_array_equal(got, want)


def test_null_snapshots_equal_jax():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.full(80, 0.5)) + 1e-9
    probs /= probs.sum()
    uniq = np.array([3, 11, 40, 97])
    want = jcc._null_snapshots(np.log(probs), probs, uniq, 300, 42)
    got = tcc._null_snapshots(np.log(probs), probs, uniq, 300, 42, device="cpu")
    np.testing.assert_array_equal(got, want)


def _droplets(seed=1, g=60, n_cells=40, n_empty=360):
    rng = np.random.default_rng(seed)
    amb = rng.dirichlet(np.full(g, 0.8))
    cell_prof = rng.dirichlet(np.full(g, 0.2), 4)
    cols = [rng.multinomial(int(rng.integers(300, 900)), cell_prof[i % 4]) for i in range(n_cells)]
    cols += [rng.multinomial(int(rng.integers(5, 120)), amb) for _ in range(n_empty)]
    return sp.csc_matrix(np.stack(cols, 1).astype(np.float32))


@pytest.mark.parametrize("filt", ["empty-drops", "ord-mag", "min-counts", "nnz"])
def test_call_cells_masks_equal_jax(filt):
    counts = _droplets()
    kw = dict(filter=filt, min_counts=200, expected_cells=40, ed_ambient_lo=150, ed_ambient_hi=400,
              ed_n_sims=400, ed_min_umis=20, seed=7)
    got = tcc.call_cells(counts, tcc.CellCallParams(**kw), device="cpu")
    want = jcc.call_cells(counts, jcc.CellCallParams(**kw))
    np.testing.assert_array_equal(got, want)
    assert got[:40].all()


def test_cell_qc_helpers_equal_jax(sim):
    counts = _droplets(3)
    amb = np.asarray(counts[:, 100:].sum(1)).ravel().astype(np.int64)
    np.testing.assert_array_equal(tcc.simple_good_turing(amb), jcc.simple_good_turing(amb))
    np.testing.assert_array_equal(tcc.simple_good_turing(np.zeros(5)),
                                  jcc.simple_good_turing(np.zeros(5)))
    tot = np.asarray(counts.sum(0)).ravel()
    p = tcc.CellCallParams(expected_cells=30)
    assert tcc.ordmag_cutoff(tot, p) == jcc.ordmag_cutoff(tot, jcc.CellCallParams(expected_cells=30))
    c = sim["spliced"] + sim["unspliced"]
    for kw in ({}, {"gene_min_cells": 3, "gene_min_counts": 5, "cell_min_genes": 4}):
        for a, b in zip(tcc.gene_qc_masks(c, **kw), jcc.gene_qc_masks(c, **kw)):
            np.testing.assert_array_equal(a, b)
    model = tgenes.parse_gff_genes(sim["gff"])
    chroms = [model.chrom_names[i] for i in model.chrom]
    for kw in ({}, {"keep_mito": True, "max_mito_frac": 0.05}, {"no_mito_cell_qc": True}):
        for a, b in zip(tcc.mito_qc(c, chroms, **kw), jcc.mito_qc(c, chroms, **kw)):
            np.testing.assert_array_equal(a, b)
    fr = np.sort(np.random.default_rng(0).beta(1, 20, 400))
    assert tcc.mito_elbow_cutoff(fr) == jcc.mito_elbow_cutoff(fr)
    lut = {"AAAC-1": "T", "GGGA": "B"}
    for cb in ("AAAC-1", "AAAC", "GGGA-1", "CCC"):
        assert tcc.match_barcode(lut, cb) == jcc.match_barcode(lut, cb)
    memb = sim["tmp"] / "memb.tsv"
    memb.write_text("AAAC-1\tT\nGGGA,B\nshort\n")
    assert tcc.load_cell_membership(str(memb)) == jcc.load_cell_membership(str(memb))


# ---- the CLI ------------------------------------------------------------------------


def _store_equal(got, want):
    g, w = tsio.open_sparse_matrix(got), tsio.open_sparse_matrix(want)
    assert g.row_names() == w.row_names() and g.column_names() == w.column_names()
    cols = np.arange(w.num_columns)
    _eq(g.read_columns_csc(cols), w.read_columns_csc(cols))


def test_faba_index_writes_jax_bai(sim, tmp_path, capsys):
    import shutil

    t_bam, j_bam = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    shutil.copy(sim["bam"], t_bam)
    shutil.copy(sim["bam"], j_bam)
    t_faba(["index", t_bam])
    j_faba(["index", j_bam])
    assert open(t_bam + ".bai", "rb").read() == open(j_bam + ".bai", "rb").read()
    t_faba(["index", t_bam])
    assert "exists (use --force to rebuild)" in capsys.readouterr().out
    t_faba(["index", "--force", t_bam])


@pytest.mark.parametrize("extra", [[], ["--splice"], ["--gene-qc", "--gene-min-cells", "2",
                                                       "--cell-min-genes", "3"],
                                   ["--row-nnz-cutoff", "5", "--column-nnz-cutoff", "4",
                                    "--gene-barcode-tag", "GX", "--no-dedup"]])
def test_faba_genes_writes_jax_stores(sim, tmp_path, extra):
    argv = ["genes", "--bam", f"{sim['bam']},{sim['bam2']}", "--gff", sim["gff"]] + extra
    t_faba(argv + ["--output", str(tmp_path / "t")])
    j_faba(argv + ["--output", str(tmp_path / "j")])
    names = [".spliced", ".unspliced"] if "--splice" in extra else [""]
    for batch in (".a", ".b"):
        for nm in names:
            _store_equal(str(tmp_path / f"t{batch}{nm}"), str(tmp_path / f"j{batch}{nm}"))
        if "--gene-qc" in extra:
            pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / f"t{batch}.cell_qc.parquet"),
                                          pd.read_parquet(tmp_path / f"j{batch}.cell_qc.parquet"))
    if "--splice" in extra:
        got = tsio.open_sparse_matrix(str(tmp_path / "t.a.spliced"))
        _eq(got.read_columns_csc(np.arange(got.num_columns)), sim["spliced"])


# ---- the parser tree ----------------------------------------------------------------


class _Parsed(Exception):
    pass


def _subparsers(run, monkeypatch):
    def grab(self, argv=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        run(["index", "x"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or (a.dest,)): (a.dest, a.default, a.nargs,
                                                            getattr(a.type, "__name__", a.type),
                                                            a.choices, a.required)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_faba_parser_carries_jax_flags_and_defaults(monkeypatch):
    got, want = _subparsers(t_faba, monkeypatch), _subparsers(j_faba, monkeypatch)
    assert list(got) == list(want)
    for cmd in want:
        flags = dict(got[cmd])
        if cmd in ("gem", "gem-encoder", "lineage", "dyn-assoc", "annotate", "plot"):
            assert flags.pop(("--device",))[1] == "cuda"
        assert flags == want[cmd], cmd


def test_data_parallel_raises(sim, tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        t_faba(["gem", "--spliced", "x", "--unspliced", "y", "--output", "o", "--data-parallel"])
