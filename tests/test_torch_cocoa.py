"""`cocoa` through both packages, the port on the CPU
(`cocoa/{collapse,stat,diff,sim}.py`, `cli/main.py::run_cocoa`).

The match cache: the port forms distances in float64, the JAX package
in float32 (|q|^2 - 2 q.r + |r|^2), so neighbours whose exact distances
nearly tie may come out in the other order; every differing entry must
be such a tie, and their count is reported. The statistics on the same
cache are held within 1e-5, the Gamma parameters, contrasts, z and p
within 1e-4; the permutation replay equals the single collection; and
`cocoa diff` (permutations, collider fix, housekeeping weights) and
`cocoa collapse` run through the port's CLI on `tests/test_cocoa_e2e.py`'s
simulations with effects within 1e-4 of JAX's.
"""

import json

import numpy as np
import pandas as pd
import pytest

from legume_tpu.cli.cocoa_cli import run_cocoa as j_run_cocoa
from legume_tpu.cocoa import collapse as jcol
from legume_tpu.cocoa import sim as jsim
from legume_tpu.cocoa import stat as jstat
from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.ops import random_projection as jrp
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.cocoa import collapse as tcol
from legume_tpu_torch.cocoa import sim as tsim
from legume_tpu_torch.cocoa import stat as tstat
from legume_tpu_torch.data import MemoryBackend

STAT_FIELDS = ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip")


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """`tests/test_cocoa.py`'s setup, with two topics."""
    sim = jsim.simulate_one(n_genes=80, n_indv=12, cells_per_indv=40, n_causal=10,
                            pve_exposure_gene=0.6, depth=4000, seed=3)
    jbe, tbe = JMem(sim.counts), MemoryBackend(sim.counts)
    _, proj_kn = jrp.project_columns(jbe, 16, seed=1)
    proj_nk = proj_kn.T.copy()
    n = sim.counts.shape[1]
    z = np.random.default_rng(0).dirichlet([2.0, 1.0], n).astype(np.float32)
    pb = (np.arange(n) % 4).astype(np.int64)
    cache = jcol.build_match_cache(proj_nk, sim.cell_indv, 12, knn=5)
    return dict(sim=sim, jbe=jbe, tbe=tbe, proj=proj_nk, z=z, pb=pb, cache=cache,
                jstat=jcol.collect_cocoa_stat(jbe, z, sim.cell_indv, pb, 4, sim.exposure, cache))


def test_match_cache_equals_jax_up_to_ties(setup):
    sim, proj, want = setup["sim"], setup["proj"], setup["cache"]
    got = tcol.build_match_cache(proj, sim.cell_indv, 12, knn=5, device="cpu")
    for name in ("idx", "dist", "valid", "matched_indv"):
        assert getattr(got, name).dtype == getattr(want, name).dtype
        assert getattr(got, name).shape == getattr(want, name).shape
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.dist[got.valid], want.dist[want.valid], rtol=0, atol=1e-4)
    # an entry may differ only where the two cells' exact distances tie
    x = proj.astype(np.float64)
    rows, cols = np.nonzero(got.idx != want.idx)
    exact = lambda c: np.linalg.norm(x[rows] - x[c], axis=1)  # noqa: E731
    gap = np.abs(exact(got.idx[rows, cols]) - exact(want.idx[rows, cols]))
    print(f"match cache: {len(rows)} of {got.idx.size} entries differ, exact gap max "
          f"{gap.max() if len(gap) else 0.0:.2e}")
    assert len(rows) <= 0.001 * got.idx.size
    assert (gap <= 1e-5).all(), gap


def test_match_cache_files_shared_with_jax(setup, tmp_path):
    sim, cache = setup["sim"], setup["cache"]
    key = tcol.match_cache_key(480, 5, 12, 16, 1, sim.cell_indv)
    assert key == jcol.match_cache_key(480, 5, 12, 16, 1, sim.cell_indv)
    assert tcol.match_cache_file(str(tmp_path), key) == jcol.match_cache_file(str(tmp_path), key)
    path = tcol.match_cache_file(str(tmp_path / "x.zarr"), key)
    jcol.save_match_cache(cache, path)
    back = tcol.load_match_cache(path)
    tcol.save_match_cache(back, path + ".port.npz")
    again = jcol.load_match_cache(path + ".port.npz")
    for name in ("idx", "dist", "valid", "matched_indv"):
        np.testing.assert_array_equal(getattr(again, name), getattr(cache, name))
    assert tcol.load_match_cache(str(tmp_path / "missing.npz")) is None


def test_stats_match_jax(setup):
    s = setup
    got = tcol.collect_cocoa_stat(s["tbe"], s["z"], s["sim"].cell_indv, s["pb"], 4,
                                  s["sim"].exposure, s["cache"], cell_block=128, device="cpu")
    for name in STAT_FIELDS:
        assert _rel(getattr(got, name), getattr(s["jstat"], name)) < 1e-5, name


def test_replay_equals_single_collection(setup):
    s = setup
    rng = np.random.default_rng(7)
    perms = [rng.permutation(s["sim"].exposure) for _ in range(2)]
    w = np.random.default_rng(1).uniform(0.5, 1.5, 80).astype(np.float32)
    multi = tcol.collect_cocoa_stat_multi(
        s["tbe"], s["z"], s["sim"].cell_indv, s["pb"], 4, np.stack([s["sim"].exposure] + perms),
        s["cache"], gene_weights=w, cell_block=200, t_chunk=2, device="cpu")
    assert len(multi) == 3
    for got, e in zip(multi, [s["sim"].exposure] + perms):
        want = tcol.collect_cocoa_stat(s["tbe"], s["z"], s["sim"].cell_indv, s["pb"], 4, e,
                                       s["cache"], gene_weights=w, device="cpu")
        for name in STAT_FIELDS:
            assert _rel(getattr(got, name), getattr(want, name)) < 1e-5, name


def test_parameters_contrast_and_pvalues_match_jax(setup):
    s = setup
    want = jstat.estimate_parameters(s["jstat"], n_opt_iter=40)
    got = tstat.estimate_parameters(s["jstat"], n_opt_iter=40, device="cpu")
    for side in ("shared", "residual", "exposure"):
        for ab in ("a", "b"):
            assert _rel(getattr(getattr(got, side), ab).numpy(),
                        np.asarray(getattr(getattr(want, side), ab))) < 1e-4, (side, ab)
    e_t = tstat.compute_exposure_contrast(got, s["sim"].exposure)
    e_j = jstat.compute_exposure_contrast(want, s["sim"].exposure)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-4)
    z = np.linspace(-4, 4, 17)
    np.testing.assert_allclose(tstat.z_to_pvalue(z), jstat.z_to_pvalue(z), rtol=1e-12)
    # the collider fix, with and without covariates
    cov = np.random.default_rng(2).normal(size=(12, 2))
    for c in (None, cov):
        got_z, got_s = tstat.remove_exposure_effect_from_topic_proportions(
            s["z"], s["sim"].cell_indv, s["sim"].exposure, covariates=c)
        want_z, want_s = jstat.remove_exposure_effect_from_topic_proportions(
            s["z"], s["sim"].cell_indv, s["sim"].exposure, covariates=c)
        np.testing.assert_array_equal(got_z, want_z)
        np.testing.assert_array_equal(got_s, want_s)


def test_simulators_equal_jax():
    for fn, kw in (("simulate_one", dict(n_genes=30, n_indv=6, cells_per_indv=10, seed=2)),
                   ("simulate_collider", dict(n_genes=30, n_types=3, n_indv=6, cells_per_indv=10,
                                              seed=4))):
        got, want = getattr(tsim, fn)(**kw), getattr(jsim, fn)(**kw)
        assert (got.counts != want.counts).nnz == 0
        for name in ("cell_indv", "exposure", "causal_genes", "beta"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """`tests/test_cocoa_e2e.py::test_cocoa_diff_e2e`'s sizes and flags
    on the collider simulation (2 cell types, used as hard topics, so the
    collider fix runs), written once and run through both packages'
    `cocoa diff` (8 permutations) and `collapse`."""
    tmp = tmp_path_factory.mktemp("cocoa")
    sim = jsim.simulate_collider(n_genes=60, n_types=2, n_indv=10, cells_per_indv=30,
                                 n_causal=8, depth=3000, seed=5)
    path = str(tmp / "counts.zarr")
    create_sparse_from_csc(sim.counts, path, [f"g{i}" for i in range(60)],
                           [f"c{j}" for j in range(sim.counts.shape[1])])
    (tmp / "indv.txt").write_text("\n".join(f"i{v}" for v in sim.cell_indv) + "\n")
    (tmp / "exp.tsv").write_text("".join(f"i{i}\t{x}\n" for i, x in enumerate(sim.exposure)))
    (tmp / "types.txt").write_text("\n".join(f"t{v}" for v in sim.cell_type) + "\n")
    flags = ["--data-files", path, "--indv", str(tmp / "indv.txt"), "--exposure",
             str(tmp / "exp.tsv"), "--topic-assignment", str(tmp / "types.txt"),
             "--n-pb-samples", "4", "--knn", "5", "--iter-opt", "40", "--permutations", "8",
             "--proj-dim", "12", "--no-match-cache"]
    j_run_cocoa(["diff", *flags, "--out", str(tmp / "j")])
    assert port_cli(["cocoa", "diff", *flags, "--out", str(tmp / "t"), "--device", "cpu"]) == 0
    cflags = ["--data-files", path, "--indv", str(tmp / "indv.txt"), "--iter-opt", "10"]
    j_run_cocoa(["collapse", *cflags, "--out", str(tmp / "jc")])
    assert port_cli(["cocoa", "collapse", *cflags, "--out", str(tmp / "tc"), "--device", "cpu"]) == 0
    return dict(tmp=tmp, sim=sim, path=path, flags=flags)


def test_cli_diff_matches_jax(e2e):
    tmp = e2e["tmp"]
    for name, cols in (("effect", ["gene", "effect"]), ("shared", ["gene", "shared"]),
                       ("residual", ["gene", "residual"]), ("pvalue", ["gene", "pvalue", "z"])):
        j = pd.read_parquet(tmp / f"j.{name}.parquet")
        t = pd.read_parquet(tmp / f"t.{name}.parquet")
        assert list(t.columns) == list(j.columns) == cols
        assert (t.gene == j.gene).all()
        for c in cols[1:]:
            atol = 1e-4 * max(1.0, float(np.abs(j[c]).max())) if c in ("shared", "residual") else 1e-4
            np.testing.assert_allclose(t[c], j[c], rtol=0, atol=atol, err_msg=name + c)
    doc = json.loads((tmp / "t.cocoa.json").read_text())
    assert doc["command"] == "cocoa-diff"
    for key in ("projection_s", "match_cache_s", "stat_collect_all_exposures_s", "gamma_fit_all_s"):
        assert doc["timings"][key] >= 0.0
    eff = pd.read_parquet(tmp / "t.effect.parquet").effect.to_numpy()
    causal = e2e["sim"].causal_genes
    assert np.abs(eff[causal]).mean() > np.abs(eff[~causal]).mean()


def test_cli_collapse_matches_jax(e2e):
    j = pd.read_parquet(e2e["tmp"] / "jc.pseudobulk.parquet")
    t = pd.read_parquet(e2e["tmp"] / "tc.pseudobulk.parquet")
    assert list(t.columns) == list(j.columns) == ["gene"] + [f"i{i}" for i in range(10)]
    np.testing.assert_allclose(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy(), rtol=1e-4)


def test_cli_simulators_and_unported_options(e2e, tmp_path):
    for cmd in ("simulate-one", "simulate-collider"):
        out = str(tmp_path / cmd)
        flags = [cmd, "--output", out, "--genes", "20", "--indv", "4", "--cells-per-indv", "5"]
        assert port_cli(["cocoa", *flags]) == 0
        j_run_cocoa([*flags[:2], out + "_j", *flags[3:]])
        assert (tmp_path / f"{cmd}.indv.txt").read_text() == \
            (tmp_path / f"{cmd}_j.indv.txt").read_text()
        assert (tmp_path / f"{cmd}.exposure.tsv").read_text() == \
            (tmp_path / f"{cmd}_j.exposure.tsv").read_text()
        assert pd.read_parquet(out + ".truth.parquet").equals(
            pd.read_parquet(out + "_j.truth.parquet"))
    assert (tmp_path / "simulate-collider.celltype.parquet").exists()
    base = ["cocoa", "diff", *e2e["flags"], "--out", str(tmp_path / "x"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="--data-parallel"):
        port_cli(base + ["--data-parallel"])
    # --gff is ported (faba's GFF reader): no longer refused up front
    from legume_tpu_torch.cocoa.diff import CocoaDiffArgs, check_supported

    assert check_supported(CocoaDiffArgs(data_files=["x"], out="x", indv_file="i",
                                         exposure_file="e", gff="x.gff")) is None


def test_match_cache_reused_across_packages(e2e, tmp_path):
    """The cache a JAX run leaves beside the data is the port's next run's."""
    import shutil

    path = str(tmp_path / "counts.zarr")
    shutil.copytree(e2e["path"], path)
    flags = [f if f != e2e["path"] else path for f in e2e["flags"] if f != "--no-match-cache"]
    flags[flags.index("--permutations") + 1] = "2"
    j_run_cocoa(["diff", *flags, "--out", str(tmp_path / "j")])
    assert port_cli(["cocoa", "diff", *flags, "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    doc = json.loads((tmp_path / "t.cocoa.json").read_text())
    assert doc["timings"]["match_cache_reused"] is True
    j = pd.read_parquet(tmp_path / "j.effect.parquet").effect
    t = pd.read_parquet(tmp_path / "t.effect.parquet").effect
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
