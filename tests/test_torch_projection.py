"""Projection, binary sort, gene statistics and kNN of the port against
the JAX package on the same simulated data (port on the CPU)."""

import numpy as np
import pytest

from legume_tpu.data.sparse_io import MemoryBackend as JMemoryBackend
from legume_tpu.data.vec import SparseIoVec as JVec
from legume_tpu.ops import gene_stats as jgs
from legume_tpu.ops import knn as jknn
from legume_tpu.ops import random_projection as jrp
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.data.sparse_io import MemoryBackend
from legume_tpu_torch.data.vec import SparseIoVec
from legume_tpu_torch.ops import gene_stats as tgs
from legume_tpu_torch.ops import knn as tknn
from legume_tpu_torch.ops import random_projection as trp
from legume_tpu_torch.utils import prng

SEED = prng.DEFAULT_PROJECTION_SEED


def _vecs(rows=150, cols=700, batches=2, seed=7):
    sim = simulate_topic(rows=rows, cols=cols, factors=4, batches=batches, seed=seed)
    jv, tv = JVec(), SparseIoVec()
    jv.push(JMemoryBackend(sim.counts, sim.row_names, sim.col_names))
    tv.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    if batches > 1:
        jv.register_batches(sim.batch.astype(str))
        tv.register_batches(sim.batch.astype(str))
    return sim, jv, tv


def test_simulate_topic_is_the_same_generator():
    from legume_tpu.data.sim import simulate_topic as jsim

    a = simulate_topic(rows=60, cols=90, factors=3, batches=2, seed=5)
    b = jsim(rows=60, cols=90, factors=3, batches=2, seed=5)
    assert (a.counts != b.counts).nnz == 0
    np.testing.assert_array_equal(a.batch, b.batch)
    np.testing.assert_allclose(a.beta, b.beta)


@pytest.mark.parametrize("batches", [1, 2])
def test_project_columns_matches(batches):
    sim, jv, tv = _vecs(batches=batches)
    memb = sim.batch if batches > 1 else None
    w = np.ones(sim.counts.shape[0], np.float32)
    w[::7] = 0.0  # an HVG-style gate
    jb, jp = jrp.project_columns(jv, 24, block_size=256, batch_membership=memb, row_weights=w, seed=SEED)
    tb, tp = trp.project_columns(tv, 24, block_size=256, batch_membership=memb, row_weights=w,
                                 seed=SEED, device="cpu")
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=2e-4, atol=2e-5)


def _zscored_sort_coords(proj_kn, kk, seed):
    import torch

    from legume_tpu_torch.ops.rsvd import rsvd

    _, _, vt = rsvd(torch.from_numpy(proj_kn), kk, key=prng.key_from_seed(seed, 17))
    q = vt.T
    return (q - q.mean(0)) / np.maximum(q.std(0), 1e-12)


def test_binary_sort_codes_equal():
    sim, jv, tv = _vecs(cols=900)
    _, jp = jrp.project_columns(jv, 50, block_size=512, batch_membership=sim.batch, seed=SEED)
    _, tp = trp.project_columns(tv, 50, block_size=512, batch_membership=sim.batch, seed=SEED, device="cpu")
    jcodes = jrp.binary_sort_columns(jp, 10, seed=SEED)
    tcodes = trp.binary_sort_columns(tp, 10, seed=SEED, device="cpu")
    diff = np.nonzero(jcodes != tcodes)[0]
    if len(diff):
        # a code may differ only where a z-scored rSVD coordinate sits at 0
        z = _zscored_sort_coords(tp, 10, SEED)
        near_zero = (np.abs(z[diff]) < 1e-5).any(axis=1)
        assert near_zero.all(), f"codes differ away from 0 for cells {diff[~near_zero]}"
    assert len(diff) == 0 or len(diff) < 3
    g_j, s_j = jrp.compact_group_codes(jcodes)
    g_t, s_t = trp.compact_group_codes(tcodes)
    if len(diff) == 0:
        np.testing.assert_array_equal(g_t, g_j)
        assert s_t == s_j


def test_rsvd_matches():
    import jax.numpy as jnp
    import torch

    from legume_tpu.ops.rsvd import rsvd as jrsvd
    from legume_tpu.utils.prng import key_from_seed
    from legume_tpu_torch.ops.rsvd import rsvd as trsvd

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((40, 8)) @ rng.standard_normal((8, 300))).astype(np.float32)
    ju, js, jvt = jrsvd(jnp.asarray(x), 6, key=key_from_seed(3, 17))
    tu, ts, tvt = trsvd(torch.from_numpy(x), 6, key=prng.key_from_seed(3, 17))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-4)
    # same signs, not only the same subspace
    np.testing.assert_allclose(tvt, np.asarray(jvt), atol=1e-4)
    np.testing.assert_allclose(tu, np.asarray(ju), atol=1e-4)


def test_gene_stats_hvg_and_fisher_match():
    _, jv, tv = _vecs(rows=200, cols=500, batches=1)
    js = jgs.streaming_gene_stats(jv, block_size=128)
    ts = tgs.streaming_gene_stats(tv, block_size=128, device="cpu")
    np.testing.assert_allclose(ts.mean, js.mean, rtol=1e-5)
    np.testing.assert_allclose(ts.var, js.var, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.pi, js.pi, rtol=1e-6)
    assert ts.n_cells == js.n_cells
    np.testing.assert_array_equal(
        tgs.hvg_row_weights(tv, 60, block_size=128, device="cpu"),
        jgs.hvg_row_weights(jv, 60, block_size=128),
    )
    np.testing.assert_allclose(
        tgs.nb_fisher_weights(tv, block_size=128, device="cpu"),
        jgs.nb_fisher_weights(jv, block_size=128), rtol=1e-4,
    )
    np.testing.assert_array_equal(
        tgs.select_hvg_by_stats(ts.mean, ts.var, 30), jgs.select_hvg_by_stats(js.mean, js.var, 30)
    )


def _assert_knn_match(td, ti, jd, ji, tol=1e-4):
    """Same k-th distances; same neighbour sets where the distance gap to
    the next candidate is above the tolerance."""
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=tol)
    for q in range(td.shape[0]):
        gaps = np.diff(np.concatenate([jd[q], [np.inf]]))
        if gaps[-1] > tol and np.all(gaps > tol):
            assert set(ti[q]) == set(ji[q]), q


def test_knn_search_within_and_matched():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((300, 12)).astype(np.float32)
    q = rng.standard_normal((70, 12)).astype(np.float32)
    mask = rng.random(300) < 0.6
    jd, ji = jknn.knn_search(q, pts, 6, chunk=32, mask=mask)
    td, ti = tknn.knn_search(q, pts, 6, chunk=32, mask=mask, device="cpu")
    _assert_knn_match(td, ti, jd, ji)
    assert mask[ti].all()
    jd, ji = jknn.knn_within(pts, 5, chunk=64)
    td, ti = tknn.knn_within(pts, 5, chunk=64, device="cpu")
    _assert_knn_match(td, ti, jd, ji)
    assert not (ti == np.arange(300)[:, None]).any()
    batches = rng.integers(0, 3, 300)
    ji, jdist, jvalid = jknn.matched_neighbors_across_batches(pts, batches, 3, 4, chunk=64)
    ti, tdist, tvalid = tknn.matched_neighbors_across_batches(pts, batches, 3, 4, chunk=64, device="cpu")
    np.testing.assert_array_equal(tvalid, jvalid)
    _assert_knn_match(np.where(tvalid, tdist, 0), ti, np.where(jvalid, jdist, 0), ji)
