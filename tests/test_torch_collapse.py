"""Collapse statistics, the Gamma fit and DC-Poisson refinement of the
port against the JAX package on the same inputs (port on the CPU)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from legume_tpu.data.sparse_io import MemoryBackend as JMemoryBackend
from legume_tpu.data.vec import SparseIoVec as JVec
from legume_tpu.ops import collapse as jclp
from legume_tpu.ops import dc_poisson as jdc
from legume_tpu.ops import gamma as jgamma
from legume_tpu.ops import random_projection as jrp
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.data.sparse_io import MemoryBackend
from legume_tpu_torch.data.vec import SparseIoVec
from legume_tpu_torch.ops import collapse as tclp
from legume_tpu_torch.ops import dc_poisson as tdc
from legume_tpu_torch.ops import gamma as tgamma

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    sim = simulate_topic(rows=120, cols=500, factors=4, batches=2, seed=21)
    jv, tv = JVec(), SparseIoVec()
    jv.push(JMemoryBackend(sim.counts, sim.row_names, sim.col_names))
    tv.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    jv.register_batches(sim.batch.astype(str))
    tv.register_batches(sim.batch.astype(str))
    _, proj_kn = jrp.project_columns(jv, 16, block_size=128, batch_membership=sim.batch, seed=3)
    codes = jrp.binary_sort_columns(proj_kn, 5, seed=3)
    groups, s = jrp.compact_group_codes(codes)
    batches = jv.batch_membership()
    js = jclp.collect_basic_stats(jv, groups, s, num_batches=2, batches=batches, block_size=128)
    js = jclp.collect_matched_stats(jv, groups, s, batches, 2, proj_kn.T.copy(), knn=5, stat=js,
                                    cell_block=128)
    ts = tclp.collect_basic_stats(tv, groups, s, num_batches=2, batches=batches, block_size=128,
                                  device="cpu")
    ts = tclp.collect_matched_stats(tv, groups, s, batches, 2, proj_kn.T.copy(), knn=5, stat=ts,
                                    cell_block=128, device="cpu")
    return dict(js=js, ts=ts, groups=groups, s=s, proj_kn=proj_kn)


@pytest.mark.parametrize(
    "plane", ["observed_sum_ds", "imputed_sum_ds", "residual_sum_ds", "size_s",
              "observed_sum_db", "n_bs"]
)
def test_collapsed_stat_planes_match(data, plane):
    np.testing.assert_allclose(getattr(data["ts"], plane), getattr(data["js"], plane), **TOL)


def test_matched_stats_ran(data):
    assert data["ts"].imputed_sum_ds.sum() > 0 and data["ts"].residual_sum_ds.sum() > 0


@pytest.mark.parametrize("name", ["mu_observed", "mu_adjusted", "mu_residual", "gamma", "delta"])
def test_optimized_gamma_planes_match(data, name):
    jout = jclp.optimize(data["js"], num_iter=30)
    tout = tclp.optimize(data["ts"], num_iter=30, device="cpu")
    jp, tp = getattr(jout, name), getattr(tout, name)
    np.testing.assert_allclose(tp.a.numpy(), np.asarray(jp.a), **TOL)
    np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b), **TOL)
    np.testing.assert_allclose(tp.mean().numpy(), np.asarray(jp.mean()), **TOL)


def test_unbatched_optimize_and_merge(data):
    groups = data["groups"]
    f2c = (np.arange(data["s"]) % 3).astype(np.int32)
    jm = jclp.merge_stat(data["js"], f2c, 3)
    tm = tclp.merge_stat(data["ts"], f2c, 3)
    np.testing.assert_allclose(tm.observed_sum_ds, jm.observed_sum_ds, **TOL)
    np.testing.assert_allclose(tm.n_bs, jm.n_bs, **TOL)
    jm.observed_sum_db = jm.observed_sum_db[:, :1]
    tm.observed_sum_db = tm.observed_sum_db[:, :1]
    jo, to = jclp.optimize(jm, num_iter=5), tclp.optimize(tm, num_iter=5, device="cpu")
    assert to.mu_adjusted is None and jo.mu_adjusted is None
    np.testing.assert_allclose(to.mu_observed.b.numpy(), np.asarray(jo.mu_observed.b), **TOL)
    assert len(groups) == 500


def test_gamma_param_summaries_and_sampling():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 40, (30, 20)).astype(np.float32)
    b = rng.uniform(0.5, 9, (30, 20)).astype(np.float32)
    jp = jgamma.GammaParam(a=a, b=b)
    tp = tgamma.GammaParam(a=torch.from_numpy(a), b=torch.from_numpy(b))
    for f in ("mean", "sd", "log_mean", "log_sd"):
        np.testing.assert_allclose(getattr(tp, f)().numpy(), np.asarray(getattr(jp, f)()), rtol=2e-6, atol=1e-6)
    # draws match in distribution: mean and variance of 4,000 draws
    big = tgamma.GammaParam(a=torch.full((4000,), 3.0), b=torch.full((4000,), 2.0))
    x = big.sample(torch.Generator().manual_seed(0)).numpy()
    assert abs(x.mean() - 1.5) < 0.05 and abs(x.var() - 0.75) < 0.08


def _dc_inputs(seed):
    rng = np.random.default_rng(seed)
    e, m, k = 80, 30, 6
    labels = rng.integers(0, k, e).astype(np.int32)
    centers = rng.gamma(2.0, 1.0, (k, m))
    prof = rng.poisson(centers[labels] * 3).astype(np.float32)
    cand = rng.random((e, k)) < 0.5
    cand[np.arange(e), labels] = True
    return sp.csr_matrix(prof), labels, k, cand, prof.sum(1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dc_poisson_refined_labels_equal(seed):
    prof, labels, k, cand, size = _dc_inputs(seed)
    kw = dict(candidates=cand, size_factors=size, num_gibbs=3, num_greedy=3, seed=seed + 5)
    j = jdc.refine_with_candidates(prof, labels, k, **kw)
    t = tdc.refine_with_candidates(prof, labels, k, device="cpu", **kw)
    np.testing.assert_array_equal(t.labels, np.asarray(j.labels))
    assert t.n_moves_per_sweep == j.n_moves_per_sweep
    np.testing.assert_allclose(t.score_trace, j.score_trace, rtol=1e-5)
