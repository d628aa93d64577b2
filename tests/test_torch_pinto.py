"""`pinto lc`'s stages through both packages, the port on the CPU: the
spatial kNN (ties to the lower index; exact at tissue scale, where the
JAX package's float32 expansion is not), the edge profiles' CSR, the
frozen incidence, one sweep from the same labels and key (JAX's randint
and Gumbel bits), and whole fits and cascades on the same edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.spatial import cKDTree

from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.ops.knn import knn_within as j_knn_within
from legume_tpu.pinto import cascade as jcas
from legume_tpu.pinto import lc as jlc
from legume_tpu_torch.data import MemoryBackend as TMem
from legume_tpu_torch.ops.knn import knn_within as t_knn_within
from legume_tpu_torch.pinto import cascade as tcas
from legume_tpu_torch.pinto import lc as tlc
from legume_tpu_torch.utils import prng


def _spatial_sim():
    """`tests/test_pinto.py::spatial_sim`: two domains of uniform cells."""
    rng = np.random.default_rng(0)
    n_per, d = 400, 60
    coords = np.concatenate([
        rng.uniform([0, 0], [1, 1], size=(n_per, 2)),
        rng.uniform([1.2, 0], [2.2, 1], size=(n_per, 2)),
    ])
    domain = np.repeat([0, 1], n_per)
    beta = np.full((2, d), 0.3)
    beta[0, : d // 2] = 3.0
    beta[1, d // 2 :] = 3.0
    y = rng.poisson(beta[domain] * 4.0).astype(np.float32).T
    return coords, domain, y


def _planted_domains(seed=7, side=14, d=50):
    """`tests/test_pinto.py::_planted_domains`: a side x side lattice, two
    domains with opposite gene programs."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)
    domain = (coords[:, 0] < side / 2).astype(int)
    prog = np.stack([np.linspace(4, 0.2, d), np.linspace(0.2, 4, d)])
    counts = rng.poisson(prog[domain] * 2.0).astype(np.float32).T
    return coords, domain, counts


FIXTURES = {"uniform": _spatial_sim, "lattice": _planted_domains}


def _backends(counts):
    genes = [f"g{i}" for i in range(counts.shape[0])]
    cells = [f"c{j}" for j in range(counts.shape[1])]
    csc = sp.csc_matrix(counts)
    return JMem(csc, genes, cells), TMem(csc, genes, cells)


def _feed_edges(monkeypatch, edges):
    """The port's fits take these edges in place of their own spatial kNN."""
    for mod in (tlc, tcas):
        monkeypatch.setattr(mod, "spatial_knn_edges", lambda *a, **k: edges)


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    table = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(table, (ia, ib), 1)
    comb = lambda x: x * (x - 1) / 2.0  # noqa: E731
    s_ij, s_a, s_b = comb(table).sum(), comb(table.sum(1)).sum(), comb(table.sum(0)).sum()
    expected = s_a * s_b / comb(len(a))
    return float((s_ij - expected) / (0.5 * (s_a + s_b) - expected))


@pytest.mark.parametrize("k", [6, 8, 10])
def test_knn_breaks_lattice_ties_as_jax(k):
    """On a 14 x 14 lattice nearly every row ties at the k-th distance;
    the port's rows (set and order) equal `lax.top_k`'s, lower index
    first among equal distances."""
    coords, _, _ = _planted_domains()
    d_j, i_j = j_knn_within(coords.astype(np.float32), k)
    d_t, i_t = t_knn_within(coords, k, device="cpu")
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-6, atol=1e-6)
    assert list(i_t[15, :8]) == [1, 14, 16, 29, 0, 2, 28, 30][:k]


@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_spatial_knn_edges_equal_jax(fixture, reciprocal):
    coords = FIXTURES[fixture]()[0]
    want = jlc.spatial_knn_edges(coords, 8, reciprocal=reciprocal)
    got = tlc.spatial_knn_edges(coords, 8, reciprocal=reciprocal, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_spatial_knn_exact_at_tissue_scale():
    """20,000 cells uniform over a 1.5 mm square 5 mm from the origin
    (µm), as float32 coordinates (both packages' kNN take float32): the
    port's neighbour sets equal the exact float64 kNN (cKDTree) in every
    row; the JAX package's float32 expansion |q|^2 - 2 q.r + |r|^2 loses
    the k-th neighbour in 1,537 rows with XLA's CPU backend (ROADMAP §3),
    held here to a band around that."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(5000.0, 6500.0, (20_000, 2)).astype(np.float32).astype(np.float64)
    k = 10
    _, exact = cKDTree(coords).query(coords, k=k + 1)
    exact = np.sort(exact[:, 1:], axis=1)
    _, got = t_knn_within(coords, k, device="cpu")
    np.testing.assert_array_equal(np.sort(got, axis=1), exact)
    _, jax_idx = j_knn_within(coords.astype(np.float32), k)
    jax_rows_off = int((np.sort(np.asarray(jax_idx), axis=1) != exact).any(1).sum())
    assert 1000 <= jax_rows_off <= 2500, jax_rows_off


@pytest.mark.parametrize("variant", ["plain", "weights", "batch_scale"])
def test_edge_profiles_equal_jax(variant, monkeypatch):
    coords, _, counts = _spatial_sim()
    jb, tb = _backends(counts)
    edges = jlc.spatial_knn_edges(coords, 6)
    rng = np.random.default_rng(1)
    kw = {}
    if variant == "weights":
        w = rng.uniform(0.2, 2.0, counts.shape[0]).astype(np.float32)
        w[::7] = 0.0  # min-gene-count drops
        kw = {"gene_weights": w}
    elif variant == "batch_scale":
        delta = rng.uniform(0.1, 10.0, (counts.shape[0], 3)).astype(np.float32)
        memb = rng.integers(0, 3, counts.shape[1])
        kw = {"batch_scale": (delta, memb), "gene_weights": np.full(counts.shape[0], 0.5, np.float32)}
    want = jlc.edge_profiles(jb, edges, block=300, **kw)
    monkeypatch.setattr(tlc, "EDGE_CHUNK", 1000)  # several chunks
    got = tlc.edge_profiles(tb, edges, block=300, **kw)
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape


def test_node_membership_and_log_incidence_match_jax():
    coords, _, _ = _planted_domains()
    edges = jlc.spatial_knn_edges(coords, 6)
    labels = np.random.default_rng(2).integers(0, 3, len(edges))
    th_j = jlc.compute_node_membership(edges, labels, len(coords), 3)
    th_t = tlc.compute_node_membership(edges, labels, len(coords), 3)
    np.testing.assert_array_equal(th_t, th_j)
    want = jlc.fit_log_incidence(edges, labels, th_j, 3, a=1.5, b=0.5)
    got = tlc.fit_log_incidence(edges, labels, th_t, 3, a=1.5, b=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def sweep_inputs():
    coords, _, counts = _spatial_sim()
    jb, _ = _backends(counts)
    edges = jlc.spatial_knn_edges(coords, 8)
    w = np.random.default_rng(4).uniform(0.5, 1.5, counts.shape[0]).astype(np.float32)
    return edges, jlc.edge_profiles(jb, edges, gene_weights=w)


@pytest.mark.parametrize("sample", [True, False])
def test_one_sweep_matches_jax(sweep_inputs, sample):
    """From the same labels and key: the init labels are JAX's randint,
    the noise is JAX's Gumbel bit for bit, the scores agree within 1e-5 of
    the largest |score|, and the labels agree wherever the top two noisy
    scores are more than 1e-4 apart."""
    edges, prof = sweep_inputs
    e, d = prof.shape
    k, seed = 5, 11
    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    lab_j = jax.random.randint(k_init, (e,), 0, k, dtype=jnp.int32)
    _, k_s = jax.random.split(key)
    kd = prng.key(seed)
    kd, kd_init = prng.split(kd)
    _, kd_s = prng.split(kd)
    lab_t = prng.randint_rows(prng.key_rows(kd_init[None], "cpu"), e, 0, k)[0].to(torch.int32)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    noise = prng.gumbel_keys(kd_s[None], e * k, "cpu").view(e, k)
    g_j = np.asarray(jax.random.gumbel(k_s, (e, k)))
    np.testing.assert_array_equal(noise.numpy().view(np.uint32), g_j.view(np.uint32))

    coo = prof.tocoo()
    inc = np.random.default_rng(5).normal(0, 0.3, (e, k)).astype(np.float32)
    new_j, sc_j = jlc._sweep(
        k_s, jnp.asarray(coo.row, jnp.int32), jnp.asarray(coo.col, jnp.int32),
        jnp.asarray(coo.data), jnp.asarray(np.asarray(prof.sum(1)).ravel().astype(np.float32)),
        lab_j, jnp.asarray(inc), jnp.ones(e, jnp.float32),
        k=k, n_edges=e, n_genes=d, alpha=1.0, a0=1.0, b0=1.0, sample=sample)
    plane = tlc.SweepPlane.from_csr(prof, "cpu")
    new_t, sc_t = tlc.sweep(plane, lab_t, noise if sample else None, torch.from_numpy(inc),
                            k=k, alpha=1.0)
    sc_j = np.asarray(sc_j)
    assert np.abs(sc_t.numpy() - sc_j).max() <= 1e-5 * np.abs(sc_j).max()
    noisy = sc_j + (g_j if sample else 0.0)
    top2 = np.sort(noisy, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(new_t.numpy()[clear], np.asarray(new_j)[clear])


# Bars measured on these fixtures before they were set: both packages
# recover the planted domains (cell ARI 1.0 on the lattice, 0.98+ on the
# uniform cells), and the two packages' edge labels agree exactly where
# no near-tie flips (ARI between packages 1.0 on both fixtures).
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_fit_link_community_matches_jax(fixture, monkeypatch):
    coords, domain, counts = FIXTURES[fixture]()
    jb, tb = _backends(counts)
    edges = jlc.spatial_knn_edges(coords, 6)
    kw = dict(n_communities=2, knn=6, n_sweeps=15, n_greedy=5, em_sweeps=8, seed=3)
    j = jlc.fit_link_community(jb, coords, **kw)
    np.testing.assert_array_equal(j.edges, edges)
    _feed_edges(monkeypatch, j.edges)
    t = tlc.fit_link_community(tb, coords, device="cpu", **kw)
    cell_j, cell_t = j.propensity.argmax(1), t.propensity.argmax(1)
    assert ari(cell_j, domain) >= 0.9 and ari(cell_t, domain) >= ari(cell_j, domain) - 0.05
    assert ari(t.edge_labels, j.edge_labels) >= 0.95
    assert [p for p, _ in t.scores_trace][:15] == [p for p, _ in j.scores_trace][:15]
    np.testing.assert_allclose([s for _, s in t.scores_trace[:15]],
                               [s for _, s in j.scores_trace[:15]], rtol=1e-4)
    np.testing.assert_allclose(t.propensity.sum(1), 1.0, rtol=1e-5)


def test_cascade_matches_jax(monkeypatch):
    coords, domain, counts = _spatial_sim()
    jb, tb = _backends(counts)
    kw = dict(levels=(3, 2), knn=6, n_sweeps=12, min_edges=40, seed=5)
    j = jcas.cascade_link_community(jb, coords, **kw)
    _feed_edges(monkeypatch, j.edges)  # JAX's float32 kNN parts from the exact one here
    t = tcas.cascade_link_community(tb, coords, device="cpu", **kw)
    assert ari(t.levels[0], j.levels[0]) >= 0.95
    assert ari(t.edge_labels, j.edge_labels) >= 0.9
    assert len(t.leaf_names) == len(j.leaf_names)
    assert t.propensity.shape == j.propensity.shape
