"""The port's copy of Leiden gives the JAX package's memberships and
qualities on the graphs of `tests/test_leiden.py`; its kNN adjacency
(torch kNN) is close to the JAX package's on random points, and
`leiden_at_count` picks the same partition."""

import numpy as np
import pytest
import scipy.sparse as sp

from legume_tpu.ops import leiden as jleiden
from legume_tpu.senna.deconvolve import leiden_at_count as j_leiden_at_count
from legume_tpu_torch.ops import leiden as tleiden
from legume_tpu_torch.senna.deconvolve import leiden_at_count


def _planted_graph():
    rng = np.random.default_rng(36)
    n = int(rng.integers(20, 60))
    p = float(rng.uniform(0.05, 0.25))
    a = np.triu((rng.random((n, n)) < p).astype(float), 1)
    return sp.csr_matrix(a + a.T)


def _random_graph(seed):
    rng = np.random.default_rng(seed + 500)
    n = int(rng.integers(30, 90))
    p = float(rng.uniform(0.04, 0.2))
    a = np.triu((rng.random((n, n)) < p) * rng.random((n, n)), 1)
    return sp.csr_matrix(a + a.T)


def _two_cliques():
    n = 8
    a = np.zeros((2 * n, 2 * n))
    a[:n, :n] = 1
    a[n:, n:] = 1
    np.fill_diagonal(a, 0)
    a[0, n] = a[n, 0] = 0.1
    return sp.csr_matrix(a)


def _assert_same(adj, **kw):
    t = tleiden.leiden_clustering(adj, **kw)
    j = jleiden.leiden_clustering(adj, **kw)
    np.testing.assert_array_equal(t.membership, j.membership)
    assert t.n_communities == j.n_communities
    assert t.quality == j.quality


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("seed", [1, 7])
def test_planted_graph_memberships_equal(refine, seed):
    _assert_same(_planted_graph(), seed=seed, refine=refine, objective="modularity")


@pytest.mark.parametrize("objective,resolution", [("modularity", 1.0), ("cpm", 0.1)])
def test_random_battery_memberships_equal(objective, resolution):
    for seed in range(12):
        _assert_same(_random_graph(seed), seed=seed, refine=True, objective=objective,
                     resolution=resolution)


def test_two_cliques_memberships_equal():
    _assert_same(_two_cliques(), seed=0)


def _clustered_points(seed=0, n=240, h=6, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, (k, h))
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, h))).astype(np.float32)


@pytest.mark.parametrize("mode", ["fuzzy", "binary"])
def test_knn_adjacency_close(mode):
    x = np.random.default_rng(3).normal(size=(200, 8)).astype(np.float32)
    t = tleiden.knn_adjacency(x, k=15, mode=mode, device="cpu")
    j = jleiden.knn_adjacency(x, k=15, mode=mode)
    assert t.shape == j.shape == (200, 200)
    np.testing.assert_array_equal((t != 0).toarray(), (j != 0).toarray())
    np.testing.assert_allclose(t.toarray(), j.toarray(), rtol=1e-4, atol=1e-6)


def test_leiden_at_count_equal():
    x = _clustered_points()
    t = leiden_at_count(x, 4, knn=15, device="cpu")
    j = j_leiden_at_count(x, 4, knn=15)
    np.testing.assert_array_equal(t, j)
