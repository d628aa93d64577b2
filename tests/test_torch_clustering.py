"""`senna clustering` through both packages, port on the CPU: k-means
labels and centres, the hsblock sweep (its deltas against brute force,
each sweep against the JAX package's), BHC merges and the per-cluster
sums, `run_clustering` with `min_cluster_size`, and `--from` through the
port's run manifest."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.special import gammaln

import legume_tpu.ops.hsblock as jhs
from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.ops.kmeans import kmeans as jkmeans
from legume_tpu.senna import clustering as jclu
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data import MemoryBackend, SparseIoVec
from legume_tpu_torch.ops import bhc as tbhc
from legume_tpu_torch.ops import hsblock as ths
from legume_tpu_torch.ops.kmeans import kmeans as tkmeans
from legume_tpu_torch.senna import clustering as tclu
from legume_tpu_torch.utils import prng
from legume_tpu_torch.utils.output import read_table, write_table


def _blobs(seed, n=2000, k=6, d=5):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 10.0, (k, d))
    truth = rng.integers(0, k, n)
    return (centres[truth] + rng.normal(0.0, 1.0, (n, d))).astype(np.float32), truth


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_kmeans_labels_equal_centres_within_1e5(seed):
    x, _ = _blobs(seed)
    jc, jl = jkmeans(x, 6, seed=seed)
    tc, tl = tkmeans(x, 6, seed=seed, device="cpu")
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)


def _sbm(seed=0, n_per=80, blocks=4, p_in=0.15, p_out=0.01):
    """The planted partition of `tests/test_hsblock.py`."""
    rng = np.random.default_rng(seed)
    truth = np.repeat(np.arange(blocks), n_per)
    p = np.where(truth[:, None] == truth[None, :], p_in, p_out)
    a = np.triu((rng.random((len(truth), len(truth))) < p).astype(np.float64), 1)
    return sp.csr_matrix(a + a.T), truth


def _edges(adj):
    coo = sp.coo_matrix(sp.triu(adj, 1))
    src = np.concatenate([coo.row, coo.col]).astype(np.int64)
    dst = np.concatenate([coo.col, coo.row]).astype(np.int64)
    w = np.concatenate([coo.data, coo.data])
    return src, dst, w, np.asarray(adj.sum(1)).ravel()


def _port_delta(adj, labels, k):
    src, dst, w, deg = _edges(adj)
    t = torch.from_numpy
    ones = torch.ones(k, k, dtype=torch.float64)
    return ths.sweep_delta(t(src), t(dst), t(w), t(deg), t(labels.astype(np.int64)), ones, ones,
                           k=k, dc=True)[0].numpy()


def test_hsblock_sweep_deltas_match_brute_force():
    rng = np.random.default_rng(1)
    n, k = 15, 4
    a = np.triu((rng.random((n, n)) < 0.4) * rng.integers(1, 4, (n, n)), 1).astype(float)
    adj = a + a.T
    labels = rng.integers(0, k, n)

    def full_score(lab):
        onehot = np.eye(k)[lab]
        edge = onehot.T @ (adj @ onehot)
        edge -= np.diag(np.diag(edge) / 2)
        vol = adj.sum(1) @ onehot
        tot = np.outer(vol, vol)
        np.fill_diagonal(tot, np.diag(tot) / 2)
        iu = np.triu_indices(k)
        return float((gammaln(1.0 + edge[iu]) - (1.0 + edge[iu]) * np.log(1.0 + tot[iu])).sum())

    base = full_score(labels)
    want = np.zeros((n, k))
    for v in range(n):
        for t in range(k):
            lab2 = labels.copy()
            lab2[v] = t
            want[v, t] = full_score(lab2) - base
    got = _port_delta(sp.csr_matrix(adj), labels, k)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_hsblock_each_sweep_follows_jax_on_the_planted_blocks():
    """JAX's own Gibbs chain on the planted partition (depth 4, seed 1):
    from each sweep's labels and key, the port's sweep picks the JAX
    package's labels, except where JAX's two best scores lie within its
    float32 resolution of the score differences (5e-3)."""
    adj, _ = _sbm()
    n, k = adj.shape[0], 8
    src, dst, w, deg = _edges(adj)
    j_args = [jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
              jnp.asarray(w.astype(np.float32)), jnp.asarray(deg.astype(np.float32))]
    key, k_init = jax.random.split(jax.random.key(1))
    pkey, pk_init = prng.split(prng.key(1))
    labels = jax.random.randint(k_init, (n,), 0, k, dtype=jnp.int32)
    np.testing.assert_array_equal(prng.randint(pk_init, (n,), 0, k), np.asarray(labels))
    ties = 0
    for sweep in range(30):
        key, ks = jax.random.split(key)
        pkey, pks = prng.split(pkey)
        sample = sweep < 20
        new, _, _ = jhs._sweep(ks, *j_args, labels, jnp.ones((k, k)), jnp.ones((k, k)),
                               k=k, n=n, dc=True, sample=sample)
        score = _port_delta(adj, np.asarray(labels), k)
        if sample:
            score = score + prng.gumbel(pks, (n, k))
        got = score.argmax(1)
        top2 = np.sort(score, 1)[:, -2:]
        differ = got != np.asarray(new)
        assert np.all(top2[differ, 1] - top2[differ, 0] < 5e-3), sweep
        ties += int(differ.sum())
        labels = new
    assert ties <= 3


def test_hsblock_recovers_the_planted_blocks():
    adj, truth = _sbm()
    res = ths.hsblock_clustering(adj, max_depth=3, seed=1, device="cpu")
    assert res.membership.max() + 1 >= 3
    acc = sum(np.bincount(truth[res.membership == c]).max() for c in np.unique(res.membership))
    assert acc / len(truth) > 0.9
    assert len(set(res.tree_paths)) == len(res.tree_paths)
    want = jhs.hsblock_clustering(adj, max_depth=3, seed=1)
    assert abs(res.loglik - want.loglik) < 0.05 * abs(want.loglik)


def test_bhc_merges_and_cut_equal():
    from legume_tpu.ops.bhc import bhc_cluster

    rng = np.random.default_rng(0)
    progs = np.full((3, 40), 1.0)
    for t in range(3):
        progs[t, 13 * t : 13 * (t + 1)] = 20.0
    profiles = np.concatenate([rng.poisson(progs[t] * 10, size=(4, 40)) for t in range(3)]).astype(float)
    for cut in (0.0, 5.0):
        want = bhc_cluster(profiles, alpha=0.5, cutoff=cut)
        got = tbhc.bhc_cluster(profiles, alpha=0.5, cutoff=cut)
        assert got.merges == want.merges
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.n_clusters == want.n_clusters


@pytest.fixture(scope="module")
def latent_run(tmp_path_factory):
    """A latent of separated topic mixtures and counts drawn from them,
    written as the port writes a topic run (latent table + manifest)."""
    tmp = tmp_path_factory.mktemp("clu")
    rng = np.random.default_rng(4)
    n, k, d = 600, 5, 60
    truth = rng.integers(0, k, n)
    theta = rng.dirichlet(np.full(k, 0.2), n) * 0.2 + 0.8 * np.eye(k)[truth]
    z = np.log(theta).astype(np.float32)
    beta = rng.dirichlet(np.full(d, 0.3), k)
    counts = sp.csc_matrix(rng.poisson(30 * theta @ beta).T.astype(np.float32))
    names = np.asarray([f"c{i}" for i in range(n)])
    from legume_tpu_torch.utils.output import matrix_columns

    path = write_table(str(tmp / "run.latent"), matrix_columns(z, "topic", "cell", names))
    from legume_tpu_torch.utils.manifest import RunManifest

    RunManifest(command="topic", outputs={"latent": path}).save(str(tmp / "run"))
    return dict(tmp=tmp, z=z, path=path, counts=counts, names=names, truth=truth)


@pytest.mark.parametrize("method", ["kmeans", "leiden"])
def test_run_clustering_equal_with_min_cluster_size(latent_run, tmp_path, method):
    kw = dict(latent=latent_run["path"], method=method, n_clusters=8, knn=10,
              min_cluster_size=40, seed=3)
    want = jclu.run_clustering(jclu.ClusteringArgs(out=str(tmp_path / "j"), **kw))
    got = tclu.run_clustering(tclu.ClusteringArgs(out=str(tmp_path / "t"), **kw), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() or method == "leiden"
    t = read_table(str(tmp_path / "t.clusters.parquet"))
    np.testing.assert_array_equal(t["cluster"], got)


def test_run_clustering_hsblock_runs(latent_run, tmp_path):
    labels = tclu.run_clustering(tclu.ClusteringArgs(
        latent=latent_run["path"], out=str(tmp_path / "h"), method="hsblock", hsblock_depth=3,
        knn=10), device="cpu")
    assert labels.shape == (600,) and 2 <= labels.max() + 1 <= 4


def test_bhc_cluster_sums_within_1e5(latent_run):
    from legume_tpu.data import SparseIoVec as JVec
    from legume_tpu.data.visitors import visit_columns_by_block
    from legume_tpu.ops import sparse as jsparse

    counts, truth = latent_run["counts"], latent_run["truth"].copy()
    truth[::7] = -1  # unassigned cells drop out
    k = int(truth.max()) + 1
    tvec = SparseIoVec()
    tvec.push(MemoryBackend(counts))
    got = tclu.cluster_sums(tvec, truth, k, block_size=128, device="cpu")
    jvec = JVec()
    jvec.push(JMem(counts))
    seg = np.where(truth >= 0, truth, k).astype(np.int32)
    want = np.zeros((counts.shape[0], k))
    for blk in visit_columns_by_block(jvec, block_size=128):
        plane = jsparse.collapse_block(
            jnp.asarray(blk.row_ids), jsparse.block_col_ids(blk), jnp.asarray(blk.vals),
            seg_of_col=jnp.asarray(np.concatenate([seg[blk.lb : blk.lb + blk.ncols], [k]])),
            num_genes=counts.shape[0], num_groups=k)
        want += np.asarray(plane, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dense = counts.toarray()
    np.testing.assert_allclose(got[:, 2], dense[:, truth == 2].sum(1), rtol=1e-6)


def test_clustering_cli_from_the_manifest_with_bhc(latent_run, tmp_path):
    from legume_tpu.data.sparse_io import create_sparse_from_csc

    data = str(tmp_path / "counts.zarr")
    create_sparse_from_csc(latent_run["counts"], data)
    src = str(latent_run["tmp"] / "run")
    out = str(tmp_path / "c")
    argv = ["senna", "clustering", "--from", src, "--out", out, "--method", "kmeans",
            "--n-clusters", "5", "--data-files", data, "--bhc-cut=-1e9", "--device", "cpu"]
    assert port_cli(argv) == 0
    doc = json.loads(open(src + ".senna.json").read())
    assert doc["outputs"]["clusters"] == out + ".clusters.parquet"
    assert doc["outputs"]["latent"] == latent_run["path"]
    labels = read_table(out + ".clusters.parquet")["cluster"]
    kw = dict(latent=latent_run["path"], method="kmeans", n_clusters=5, data_files=[data],
              bhc_cut=-1e9)
    want = jclu.run_clustering(jclu.ClusteringArgs(out=str(tmp_path / "j"), **kw))
    np.testing.assert_array_equal(labels, want)
    for name in ("bhc.merges", "bhc.cut"):
        t, j = read_table(f"{out}.{name}.parquet"), read_table(str(tmp_path / f"j.{name}.parquet"))
        assert list(t) == list(j) and len(t["cluster" if name == "bhc.cut" else "left"]) == 5 - (
            name == "bhc.merges")  # the whole tree: k - 1 merges
        for c in t:
            np.testing.assert_allclose(t[c], j[c], rtol=1e-9)
