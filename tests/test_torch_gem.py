"""`faba gem` / `gem-encoder` and gem's posterior in the port
(`embedding/gem.py`, `embedding/posterior.py::gem_gibbs`,
`cli/faba_cmds/gem_cmds.py`) against the JAX package's, on the CPU.

- The initial parameters are the JAX package's threefry normals bit for
  bit (`utils/prng.py::normal_exact` evaluates XLA's CPU erfinv, log1p
  and log, fused multiply-adds included).
- `fit_gem` is full-batch and deterministic. Where the arithmetic rounds
  alike, its loss trace is held to JAX's within a relative 1e-5 (every
  50th epoch over 101 epochs). Its end state is held in float64 form:
  the port's float32 fit lies within twice the JAX float32 fit's
  distance from the port's float64 fit from the same start, 1e-5 at the
  least. `fit_gem_encoder` draws JAX's per-epoch mask keys and is held
  the same way.
- `gem_gibbs`: the first sweep's gene blocks and pb block (before any
  Gamma draw, which the port makes its own way) within 1e-5 of JAX's,
  the gates exactly; longer runs finite with the JAX shapes.
- The CLI: both packages' outputs on the same stores, at the bars above.
"""

import json

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax
from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.data import sparse_io as jsio
from legume_tpu.embedding import gem as jgem
from legume_tpu.embedding import posterior as jpost
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.embedding import gem as tgem
from legume_tpu_torch.embedding import posterior as tpost
from legume_tpu_torch.utils import prng as tprng


def _pb(seed=0, p=36, d=50, h=3):
    """Pseudobulk spliced / unspliced counts with a low-rank state and a
    per-gene velocity shift."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(p, h))
    beta = rng.normal(size=(d, h)) * 0.6
    delta = rng.normal(size=(d, h)) * 0.3 * (rng.random((d, 1)) < 0.4)
    s = rng.poisson(np.exp(z @ beta.T + 1.0)).astype(np.float32)
    u = rng.poisson(np.exp(z @ (beta + delta).T + 0.2)).astype(np.float32)
    return s, u


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_initial_parameters_equal_jax():
    s, u = _pb()
    p, d = s.shape
    want = jgem.fit_gem(s, u, epochs=0, seed=5)
    got = tgem.fit_gem(s, u, epochs=0, seed=5, device="cpu")
    np.testing.assert_array_equal(got.e_feat, want.e_feat)
    np.testing.assert_array_equal(got.pb_e, want.pb_e)
    init, _ = tgem.gem_encoder_init(d, 16, 3)
    k1, k2, _ = jax.random.split(jax.random.key(3), 3)
    np.testing.assert_array_equal(init["rho"], np.asarray(0.1 * jax.random.normal(k1, (d, 16))))
    np.testing.assert_array_equal(init["w1"], np.asarray(0.1 * jax.random.normal(k2, (16, 16))))
    for seed, shape in ((0, (300_000,)), (123, (50_000, 16))):
        np.testing.assert_array_equal(
            tprng.normal_exact(tprng.key(seed), shape),
            np.asarray(jax.random.normal(jax.random.key(seed), shape)))
    key = jax.random.key(9)
    want_keys = []
    for n_e in (100, 100, 7):
        key, kc = jax.random.split(key)
        want_keys.append(np.asarray(jax.random.key_data(jax.random.split(kc, n_e))))
    np.testing.assert_array_equal(tgem.epoch_keys(np.asarray(jax.random.key_data(jax.random.key(9))),
                                                  207), np.concatenate(want_keys))


_GEM_OPTS = [dict(), dict(sequential_velocity=True),
             dict(objective="softmax", weight_decay=0.01, grad_clip=0.5)]


@pytest.mark.parametrize("kw", _GEM_OPTS, ids=["joint", "sequential", "softmax-adamw-clip"])
def test_fit_gem_trace_and_end_state(kw):
    s, u = _pb(1)
    want = jgem.fit_gem(s, u, epochs=101, seed=2, **kw)
    got = tgem.fit_gem(s, u, epochs=101, seed=2, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    ref = tgem.fit_gem(s, u, epochs=101, seed=2, device="cpu", dtype=torch.float64, **kw)
    for name in ("e_feat", "delta", "pb_e", "b_feat_s", "b_feat_u", "pb_b"):
        bar = max(2 * _gap(getattr(want, name), getattr(ref, name)), 1e-5)
        assert _gap(getattr(got, name), getattr(ref, name)) <= bar, name


def test_fit_gem_lineage_dag_matches_jax():
    s, u = _pb(2, p=40)
    kw = dict(epochs=60, seed=1, lineage_dag=True, lineage_smooth=True)
    want = jgem.fit_gem(s, u, **kw)
    got = tgem.fit_gem(s, u, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_array_equal(got.dag_edges, want.dag_edges)
    np.testing.assert_array_equal(got.dag_leaves, want.dag_leaves)
    np.testing.assert_allclose(got.dag_pseudotime, want.dag_pseudotime, atol=1e-4)
    np.testing.assert_allclose(got.dag_fate, want.dag_fate, atol=1e-4)
    dense = tgem.fit_gem(s, u, device="cpu", epochs=20, lineage_dag=True, lineage_mst=False)
    assert len(dense.dag_edges) > len(got.dag_edges) and np.isfinite(dense.dag_fate).all()


def test_fit_gem_encoder_trace_and_end_state():
    s, u = _pb(3)
    want = jgem.fit_gem_encoder(s, u, epochs=101, seed=4)
    got = tgem.fit_gem_encoder(s, u, epochs=101, seed=4, device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    ref = tgem.fit_gem_encoder(s, u, epochs=101, seed=4, device="cpu", dtype=torch.float64)
    for name in ("rho", "delta", "w1", "b1", "bias_s"):
        bar = max(2 * _gap(getattr(want, name), getattr(ref, name)), 1e-5)
        assert _gap(getattr(got, name), getattr(ref, name)) <= bar, name
    np.testing.assert_allclose(got.encode(u), want.encode(u), atol=1e-3)


def _gibbs_args(seed=0):
    s, u = _pb(seed, p=30, d=40, h=2)
    fit = jgem.fit_gem(s, u, embedding_dim=3, epochs=80, seed=seed)
    return (s, u, fit.e_feat, fit.delta, fit.b_feat_s, fit.b_feat_u, fit.pb_e, fit.pb_b)


def test_gem_gibbs_first_sweep_matches_jax():
    args = _gibbs_args()
    kw = dict(n_sweeps=1, burnin=0, transitions_per_dim=2, seed=3)
    want = jpost.gem_gibbs(*args, **kw)
    stats = {}
    got = tpost.gem_gibbs(*args, **kw, device="cpu", stats=stats)
    np.testing.assert_array_equal(got.beta_pip, want.beta_pip)
    np.testing.assert_array_equal(got.delta_pip, want.delta_pip)
    for name in ("beta_mean", "delta_mean", "e_pb_mean", "b_pb_mean"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got.delta_identified, want.delta_identified)
    assert stats["ess_steps"] == 2 * 3 * 2 + 2


def test_gem_gibbs_runs_with_jax_shapes():
    """Six sweeps after two of burn-in: the JAX result's fields and
    shapes, finite, the delta gate nested in beta's."""
    args = _gibbs_args(1)
    got = tpost.gem_gibbs(*args, n_sweeps=6, burnin=2, seed=1, device="cpu")
    (p, d), h = args[0].shape, args[2].shape[1]
    shapes = dict(beta_mean=(d, h), beta_pip=(d, h), delta_mean=(d, h), delta_pip=(d, h),
                  e_pb_mean=(p, h), b_pb_mean=(p,), delta_identified=(d,),
                  beta_sigma2_trace=(6, h), delta_sigma2_trace=(6, h), rhat=(p,), ess=(p,))
    assert set(shapes) == set(jpost.GemGibbsResult.__dataclass_fields__)
    for name, shape in shapes.items():
        a = getattr(got, name)
        assert np.shape(a) == shape, name
        assert np.isfinite(np.asarray(a, np.float64)).all(), name
    assert ((got.delta_pip <= got.beta_pip + 1e-9).all() and (got.beta_pip >= 0).all()
            and (got.beta_pip <= 1).all())


# ---- the CLI ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Cell-level spliced / unspliced stores (600 cells, 60 genes) and
    pb-level ones (36 pseudobulks), written by the JAX package."""
    tmp = tmp_path_factory.mktemp("gem")
    rng = np.random.default_rng(11)
    n, d = 600, 60
    grp = rng.integers(0, 6, n)
    prof = rng.gamma(0.5, 1.0, (6, d)) + 0.05
    s = rng.poisson(prof[grp] * 1.5).astype(np.float32)
    u = rng.binomial(s.astype(np.int64), 0.3).astype(np.float32)
    genes = [f"g{i}" for i in range(d)]
    cells = [f"c{i}" for i in range(n)]
    out = dict(tmp=tmp)
    for nm, m in (("s", s), ("u", u)):
        jsio.create_sparse_from_csc(sp.csc_matrix(m.T), str(tmp / f"{nm}.zarr"), genes, cells)
        out[nm] = str(tmp / f"{nm}.zarr")
    sp_, up_ = _pb(4, p=36, d=d)
    for nm, m in (("ps", sp_), ("pu", up_)):
        jsio.create_sparse_from_csc(sp.csc_matrix(m.T), str(tmp / f"{nm}.zarr"), genes,
                                    [f"pb{i}" for i in range(36)])
        out[nm] = str(tmp / f"{nm}.zarr")
    return out


def _tables(prefix):
    names = ("gene_embedding", "velocity", "gene_velocity", "latent", "cell_embedding",
             "feature_embedding")
    return {n: pd.read_parquet(f"{prefix}.{n}.parquet") for n in names}


def _assert_outputs_close(t, j, atol):
    a, b = _tables(t), _tables(j)
    for n in a:
        assert list(a[n].columns) == list(b[n].columns), n
        assert a[n].iloc[:, 0].tolist() == b[n].iloc[:, 0].tolist(), n
        np.testing.assert_allclose(a[n].iloc[:, 1:].to_numpy(np.float64),
                                   b[n].iloc[:, 1:].to_numpy(np.float64), atol=atol, err_msg=n)
    assert json.load(open(f"{t}.gem.json")) == json.load(open(f"{j}.gem.json"))


@pytest.mark.parametrize("argv", [
    ["gem", "--epochs", "60"],
    ["gem", "--epochs", "40", "--raw", "--sort-dim", "3", "--proj-dim", "8", "--block-size", "256"],
    ["gem-encoder", "--epochs", "40"],
    ["gem", "--epochs", "40", "--lineage-dag"],
], ids=["gem", "gem-raw", "gem-encoder", "lineage-dag"])
def test_gem_commands_equal_jax(stores, argv):
    tmp = stores["tmp"]
    raw = "--raw" in argv
    ins = ["--spliced", stores["s" if raw else "ps"], "--unspliced", stores["u" if raw else "pu"]]
    tag = "_".join(argv[:1] + [a.strip("-") for a in argv[3:4]])
    res = t_faba(argv + ins + ["--output", str(tmp / f"t_{tag}"), "--device", "cpu"])
    j_faba(argv + ins + ["--output", str(tmp / f"j_{tag}")])
    _assert_outputs_close(str(tmp / f"t_{tag}"), str(tmp / f"j_{tag}"), atol=2e-3)
    assert res["fit_s"] >= 0 and len(res["losses"]) >= 1
    if raw:
        np.testing.assert_array_equal(np.load(tmp / f"t_{tag}.partition.npz")["fine_groups"],
                                      np.load(tmp / f"j_{tag}.partition.npz")["fine_groups"])
        assert res["projection_s"] >= 0 and res["pseudobulk_s"] >= 0
    if "--lineage-dag" in argv:
        for n in ("dag_pseudotime", "dag_fate"):
            a = pd.read_parquet(tmp / f"t_{tag}.{n}.parquet")
            b = pd.read_parquet(tmp / f"j_{tag}.{n}.parquet")
            assert list(a.columns) == list(b.columns)
            np.testing.assert_allclose(a.iloc[:, 1:].to_numpy(np.float64),
                                       b.iloc[:, 1:].to_numpy(np.float64), atol=1e-3)


def test_gem_posterior_writes_the_jax_table(stores):
    """`--posterior`: the JAX command's table (`gene`, `delta_pip`,
    `delta_norm`, `beta_pip`, `identified`), pips in [0, 1]; with
    `--lineage-dag` it refuses, as the JAX command does."""
    tmp = stores["tmp"]
    argv = ["gem", "--epochs", "30", "--posterior", "4", "-d", "4", "--spliced", stores["ps"],
            "--unspliced", stores["pu"]]
    res = t_faba(argv + ["--output", str(tmp / "t_post"), "--device", "cpu"])
    a = pd.read_parquet(tmp / "t_post.delta_posterior.parquet")
    assert list(a.columns) == ["gene", "delta_pip", "delta_norm", "beta_pip", "identified"]
    assert a.gene.tolist() == [f"g{i}" for i in range(60)]
    assert a[["delta_pip", "beta_pip"]].to_numpy().min() >= 0
    assert a[["delta_pip", "beta_pip"]].to_numpy().max() <= 1
    assert np.isfinite(res["posterior_rhat_max"])
    for run in (t_faba, j_faba):
        with pytest.raises(SystemExit):
            run(argv + ["--output", str(tmp / "bad"), "--lineage-dag"])
