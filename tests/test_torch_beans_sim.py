"""`data-beans-sim` through both packages' CLIs from the same seeds, the
port on the CPU: every store decodes equal (and its `zarr.json`
documents JSON-equal), every table and batch file equal, and the
simulators' arrays equal JAX's (both draw with numpy's `default_rng`)."""

import gzip

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.cli.sim_cli import run_sim as j_sim
from legume_tpu.data import sim as jsim
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu_torch.cli.sim_cli import run_sim as t_sim
from legume_tpu_torch.data import sim as tsim

from test_torch_beans import assert_same_store


def _tables_equal(tmp_path, suffixes):
    for s in suffixes:
        t, j = tmp_path / f"t{s}", tmp_path / f"j{s}"
        if s.endswith(".gz"):
            assert gzip.open(t).read() == gzip.open(j).read(), s
        elif s.endswith(".parquet"):
            a, b = pd.read_parquet(t), pd.read_parquet(j)
            assert list(a.columns) == list(b.columns), s
            for c in b.columns:
                np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy(), err_msg=f"{s}:{c}")
        else:
            assert t.read_text() == j.read_text(), s


def _both(tmp_path, argv):
    t_sim([*argv, "--output", str(tmp_path / "t")])
    j_sim([*argv, "--output", str(tmp_path / "j")])


SIMS = {
    "topic": (["topic", "--rows", "120", "--cols", "300", "--factors", "4", "--batches", "3",
               "--pve-noise", "0.1", "--n-housekeeping", "5", "--batch-rank", "2", "--seed", "3"],
              [(".zarr", ".zarr")],
              [".dict.parquet", ".prop.parquet", ".ln_batch.parquet", ".batch.gz"]),
    "topic-hierarchical-holdout": (["topic", "--rows", "100", "--cols", "250",
                                    "--hierarchical-depth", "2", "--holdout-topics", "0", "2"],
                                   [(".zarr", ".zarr"), (".holdout.zarr", ".holdout.zarr")],
                                   [".dict.parquet", ".prop.parquet", ".batch.gz"]),
    "faba": (["faba", "--genes", "20", "--cols", "150", "--states", "4"], [(".zarr", ".zarr")],
             [".state.parquet", ".rates.parquet"]),
    "multimodal": (["multimodal", "--rows", "80", "50", "--cols", "120"],
                   [(".mod0.zarr", ".mod0.zarr"), (".mod1.zarr", ".mod1.zarr")],
                   [".prop.parquet"]),
    "multiome": (["multiome", "--genes", "40", "--peaks", "90", "--cols", "100",
                  "--linked-gene-fraction", "0.6", "--n-causal-per-gene", "2"],
                 [(".rna.zarr", ".rna.zarr"), (".atac.zarr", ".atac.zarr")],
                 [".genes.gff", ".truth.parquet"]),
}


@pytest.mark.parametrize("name", list(SIMS))
def test_sim_cli_equals_jax(tmp_path, name):
    argv, stores, tables = SIMS[name]
    _both(tmp_path, argv)
    for a, b in stores:
        assert_same_store(str(tmp_path / f"t{a}"), str(tmp_path / f"j{b}"))
    _tables_equal(tmp_path, tables)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("simref")
    sim = jsim.simulate_topic(rows=60, cols=200, factors=3, seed=5)
    path = str(root / "ref.zarr")
    create_sparse_from_csc(sim.counts, path, sim.row_names, sim.col_names)
    labels = root / "labels.tsv"
    pd.DataFrame({"cell": sim.col_names, "label": [f"t{k}" for k in sim.theta.argmax(1)]}).to_csv(
        labels, sep="\t", index=False)
    return {"path": path, "labels": str(labels), "sim": sim}


def test_bulk_and_copula_cli_equal_jax(tmp_path, reference):
    _both(tmp_path, ["bulk", "--backend", reference["path"], "--labels", reference["labels"],
                     "--samples", "6", "--reads", "5000"])
    _tables_equal(tmp_path, [".bulk.parquet", ".fractions.parquet"])
    _both(tmp_path, ["topic", "--reference", reference["path"], "--cols", "150",
                     "--copula-rank", "4", "--seed", "9"])
    assert_same_store(str(tmp_path / "t.zarr"), str(tmp_path / "j.zarr"))


def test_simulators_equal_jax(reference):
    sim = reference["sim"]
    labels = sim.theta.argmax(1)
    for a, b in zip(tsim.simulate_bulk(sim.counts, labels, n_samples=5, seed=2),
                    jsim.simulate_bulk(sim.counts, labels, n_samples=5, seed=2)):
        np.testing.assert_array_equal(a, b)
    t, j = tsim.simulate_faba(n_genes=15, n_cells=80, seed=4), jsim.simulate_faba(
        n_genes=15, n_cells=80, seed=4)
    assert (t.counts != j.counts).nnz == 0 and t.site_names == j.site_names
    for f in ("modality", "true_rates", "state"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    # more reference cells than max_ref_cells: the subsample draw too
    (tc, tp), (jc, jp) = (m.simulate_from_reference(sim.counts, 90, rank=3, seed=1,
                                                    max_ref_cells=150) for m in (tsim, jsim))
    assert (sp.csc_matrix(tc) != sp.csc_matrix(jc)).nnz == 0
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
