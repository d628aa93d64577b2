"""`senna layout` (umap, tumap, tsne, phate) and `senna plot` /
`plot-topic` through both packages, port on the CPU.

UMAP's and t-SNE's descents are chaotic: a difference of one unit in the
last place grows about tenfold every few steps. So the trajectories are
held to the JAX package's where the arithmetic rounds alike (UMAP's
draws bit for bit, t-UMAP's first 20 steps, UMAP's first 5, t-SNE's
first 5 iterations), and the full layouts to the reference's own bars.
PHATE's refinement cancels (its Laplacian product sums terms of both
signs to a small gradient), so its layout is held within twice the
reference's own distance from the same refinement in float64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import legume_tpu.ops.layouts as jlay
import legume_tpu.ops.umap as jumap
from legume_tpu.cli import main as jcli
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.ops import layouts as tlay
from legume_tpu_torch.ops import rounding
from legume_tpu_torch.ops import umap as tumap
from legume_tpu_torch.utils import prng
from legume_tpu_torch.utils.output import read_table


def _two_blobs(seed=4):
    """`tests/test_aux.py:80`'s clusters."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.3, size=(100, 5))
    b = rng.normal(4, 0.3, size=(100, 5))
    return np.concatenate([a, b]).astype(np.float32)


def _simplex_blobs():
    """`tests/test_aux.py:308`'s planted simplex clusters."""
    rng = np.random.default_rng(0)
    a = rng.dirichlet([8, 1, 1, 1], 120)
    b = rng.dirichlet([1, 1, 8, 1], 120)
    return np.vstack([a, b]).astype(np.float32)


def _blobs(n_per=60, d=20, seed=0):
    """`tests/test_layouts.py`'s blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(3, d))
    x = np.concatenate(
        [c + rng.normal(scale=1.0, size=(n_per, d)) for c in centers]
    ).astype(np.float32)
    return x, np.repeat(np.arange(3), n_per)


def _knn_purity(y, labels, k=10):
    d2 = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]
    return (labels[nbr] == labels[:, None]).mean()


def _graph_points():
    rng = np.random.default_rng(4)
    return np.concatenate([rng.normal(0, 0.3, (150, 5)), rng.normal(4, 0.3, (150, 5))]
                          ).astype(np.float32)


@pytest.fixture(scope="module")
def graph():
    """The fuzzy graph and SGD inputs of 300 points (two blobs)."""
    x = _graph_points()
    src, dst, w = jumap.fuzzy_edges(x, 15)
    xc = x - x.mean(0)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    emb0 = jumap.init_2d_from_scores(u[:, :2] * s[:2], 0)
    return dict(x=x, src=src, dst=dst, w=w, probs=w / w.sum(), emb0=emb0)


def test_pc_scores_init_and_curve_match_jax():
    x = _simplex_blobs()
    want, got = jumap.pc_scores(x, 3, 1), tumap.pc_scores(x, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tumap.init_2d_from_scores(got, 3),
                               jumap.init_2d_from_scores(want, 3), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tumap._fit_ab(0.1, 1.0), jumap._fit_ab(0.1, 1.0), rtol=1e-6)
    with pytest.raises(ValueError):
        tumap.pc_scores(x, 0, 1)


def test_fuzzy_edges_equal_and_weights_exact(graph):
    """The edges equal the JAX package's. The weights are within 1e-6 of
    the weights of the exact (float64) distances; the JAX package's own
    kNN expands |q - r|^2 in float32 and is off by up to ~1e-4 at these
    coordinates, so the two packages' weights are held within 2e-4."""
    x = graph["x"]
    # the points the JAX weights were made from, unchanged since
    np.testing.assert_array_equal(x, _graph_points())
    src, dst, w = tumap.fuzzy_edges(x, 15, device="cpu")
    np.testing.assert_array_equal(src, graph["src"])
    np.testing.assert_array_equal(dst, graph["dst"])
    np.testing.assert_allclose(w, graph["w"], rtol=0, atol=2e-4)
    # the same weights from float64 distances to the same neighbours
    x64 = x.astype(np.float64)
    d_all = np.sqrt(((x64[:, None] - x64[None]) ** 2).sum(-1))
    np.fill_diagonal(d_all, np.inf)
    idx = np.argsort(d_all, axis=1, kind="stable")[:, :15]
    d = np.take_along_axis(d_all, idx, 1)
    rho = d[:, :1]
    sigma = np.maximum(d.mean(1, keepdims=True) - rho, 1e-3)
    import scipy.sparse as sp

    n = len(x)
    g = sp.csr_matrix((np.exp(-np.maximum(d - rho, 0) / sigma).ravel(),
                       (np.repeat(np.arange(n), 15), idx.ravel())), shape=(n, n))
    g = (g + g.T - g.multiply(g.T)).tocoo()
    exact = dict(zip(zip(g.row, g.col), g.data))
    np.testing.assert_allclose(w, [exact[e] for e in zip(src, dst)], rtol=0, atol=1e-6)


def test_sgd_draws_equal_jax_random(graph):
    n_steps, batch, n = 20, 256, len(graph["x"])
    eidx, neg = tumap.sgd_draws(0, graph["probs"], n_steps=n_steps, batch=batch, n_points=n,
                                device="cpu")
    keys = jax.random.split(jax.random.key(0), n_steps)
    for i in range(n_steps):
        k1, k2 = jax.random.split(keys[i])
        want_e = jax.random.choice(k1, len(graph["src"]), (batch,), p=jnp.asarray(graph["probs"]))
        want_n = jax.random.randint(k2, (batch, 5), 0, n)
        np.testing.assert_array_equal(eidx[i].numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(want_n))


def test_device_draws_equal_the_host_stream():
    keys = prng.split(prng.key(11), 4)
    rows = prng.key_rows(keys, "cpu")
    p = np.random.default_rng(0).random(500).astype(np.float32)
    p /= p.sum()
    got = prng.choice_rows(rows, torch.from_numpy(prng.cumsum_f32(p)), 64).numpy()
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(prng.uniform_rows(rows, 100)[i].numpy(),
                                      prng.uniform(k, (100,)))
        np.testing.assert_array_equal(got[i], prng.choice(k, p, (64,)))
        for span in (7, 65536, 65537, 100_000):
            np.testing.assert_array_equal(prng.randint_rows(rows, 50, 0, span)[i].numpy(),
                                          prng.randint(k, (50,), 0, span))


@pytest.mark.parametrize("kernel,n_steps", [("tumap", 20), ("umap", 5)])
def test_umap_sgd_matches_jax(graph, kernel, n_steps):
    """t-UMAP's 20 steps (bit-equal in every run so far) and UMAP's first 5
    within 1e-4. UMAP's `pow` is the correctly rounded one, where the
    reference's libm `powf` differs in about one value of 1,500, and XLA
    contracts some of the step's products into fused multiply-adds by
    where its vector loops fall; the chaos grows those last-place
    differences to ~7e-5 by step 10."""
    a, b = (1.0, 1.0) if kernel == "tumap" else jumap._fit_ab(0.1, 1.0)
    kw = dict(n_steps=n_steps, batch=256, n_points=len(graph["x"]), a=a, b=b)
    want = np.asarray(jumap._umap_sgd(
        jax.random.key(0), jnp.asarray(graph["emb0"]), jnp.asarray(graph["src"]),
        jnp.asarray(graph["dst"]), jnp.asarray(graph["probs"]), **kw))
    got = tumap._umap_sgd(0, graph["emb0"], graph["src"], graph["dst"], graph["probs"],
                          device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["umap_blobs", "tumap_pcs"])
def test_umap_layouts_pass_the_reference_bars(case):
    if case == "umap_blobs":
        emb = tumap.umap(_two_blobs(), n_neighbors=10, n_epochs=60, seed=0, device="cpu")
        ca, cb = emb[:100].mean(0), emb[100:].mean(0)
        within = np.linalg.norm(emb[:100] - ca, axis=1).mean()
        assert np.linalg.norm(ca - cb) > 2.0 * within
    else:
        emb = tumap.umap(_simplex_blobs(), kernel="tumap", pcs=3, n_epochs=60, seed=1,
                         device="cpu")
        gap = np.linalg.norm(emb[:120].mean(0) - emb[120:].mean(0))
        assert gap / max(emb[:120].std(), emb[120:].std()) > 1.5
    assert np.isfinite(emb).all()


def test_tsne_calibration_and_first_iterations_match_jax():
    x, _ = _blobs()
    want = np.asarray(jlay._calibrate_p(jlay._pairwise_sq_dists(jnp.asarray(x)), 20.0))
    d2 = rounding.sq_dists(torch.from_numpy(x), fused=False)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jlay._pairwise_sq_dists(jnp.asarray(x))))
    np.testing.assert_allclose(tlay._calibrate_p(d2, 20.0).numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlay.tsne(x, perplexity=20, n_iter=5, device="cpu"),
                               jlay.tsne(x, perplexity=20, n_iter=5), rtol=0, atol=1e-4)


def test_tsne_separates_blobs():
    x, labels = _blobs()
    y = tlay.tsne(x, perplexity=20, n_iter=300, seed=0, device="cpu")
    assert y.shape == (180, 2) and np.isfinite(y).all()
    assert _knn_purity(y, labels) > 0.95


def test_phate_init_equal_and_refinement_within_the_reference_rounding():
    x, labels = _blobs(seed=1)
    pd_, y0 = tlay.phate_init(x, knn=5, device="cpu")
    np.testing.assert_allclose(y0, jlay.phate(x, knn=5, n_iter=0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlay.phate_refine(pd_, y0, n_iter=1, device="cpu"),
                               jlay.phate(x, knn=5, n_iter=1), rtol=0, atol=1e-4)
    # the same refinement in float64, from the same start
    n, y, t = len(x), y0.astype(np.float64), pd_.astype(np.float64)
    for _ in range(200):
        dy = np.sqrt(np.maximum(((y[:, None] - y[None]) ** 2).sum(-1), 1e-12))
        c = (dy - t) / dy
        np.fill_diagonal(c, 0.0)
        y = y - (n * 0.5) * 4.0 * (c.sum(1)[:, None] * y - c @ y) / (n * n)
    want = jlay.phate(x, knn=5, n_iter=200)
    got = tlay.phate_refine(pd_, y0, n_iter=200, device="cpu")
    assert np.abs(got - want).max() <= 2.0 * np.abs(want - y).max()
    assert _knn_purity(got, labels) > 0.9


def test_phate_trajectory_orders_points():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 1, 150)
    x = (np.outer(t, rng.normal(size=10)) + rng.normal(scale=0.05, size=(150, 10))
         ).astype(np.float32)
    y = tlay.phate(x, knn=5, n_iter=200, device="cpu")
    assert abs(np.corrcoef(np.linalg.norm(y - y[0], axis=1), t)[0, 1]) > 0.8


@pytest.fixture(scope="module")
def latent(tmp_path_factory):
    """A log-simplex latent written as the JAX package writes one
    (`senna/topic.py`: a DataFrame indexed by cell, reset to a `cell` column)."""
    tmp = tmp_path_factory.mktemp("lay")
    rng = np.random.default_rng(7)
    n, k = 150, 4
    truth = rng.integers(0, k, n)
    theta = rng.dirichlet(np.full(k, 0.3), n) * 0.3 + 0.7 * np.eye(k)[truth]
    path = str(tmp / "z.latent.parquet")
    pd.DataFrame(np.log(theta).astype(np.float32), index=[f"c{i}" for i in range(n)],
                 columns=[f"t{j}" for j in range(k)]).reset_index(names="cell").to_parquet(path)
    return dict(tmp=tmp, path=path, theta=theta, truth=truth)


def _manifest(prefix):
    return json.loads(open(prefix + ".senna.json").read())


@pytest.mark.parametrize("method,extra", [("umap", []), ("tumap", ["--pcs", "2"]),
                                          ("tsne", []), ("phate", [])])
def test_layout_cli_writes_what_the_jax_cli_writes(latent, method, extra):
    tmp = latent["tmp"]
    argv = ["layout", "--latent", latent["path"], "--method", method, "--epochs", "20", *extra]
    jcli.run_senna([*argv, "--out", str(tmp / f"j_{method}")])
    port_cli(["senna", *argv, "--out", str(tmp / f"p_{method}"), "--device", "cpu"])
    j, p = _manifest(str(tmp / f"j_{method}")), _manifest(str(tmp / f"p_{method}"))
    assert set(p["outputs"]) == set(j["outputs"]) and p["params"] == j["params"]
    assert p["outputs"]["layout"] == str(tmp / f"p_{method}.layout.parquet")
    xy = read_table(p["outputs"]["layout"])
    jxy = pd.read_parquet(j["outputs"]["layout"])
    assert list(xy) == list(jxy.columns) == ["cell", "x", "y"]
    np.testing.assert_array_equal(xy["cell"], jxy["cell"])
    assert np.isfinite(np.stack([xy["x"], xy["y"]])).all()
    assert {"read_s", "total_s"} <= set(p["timings"])


@pytest.fixture(scope="module")
def topic_run(tmp_path_factory):
    """A small port `senna topic` run: the `--from` source of the chain."""
    from legume_tpu.data.sparse_io import create_sparse_from_csc
    from legume_tpu_torch.data.sim import simulate_topic

    tmp = tmp_path_factory.mktemp("chain")
    sim = simulate_topic(rows=100, cols=240, factors=3, batches=1, seed=5)
    data = str(tmp / "x.zarr")
    create_sparse_from_csc(sim.counts, data, sim.row_names, sim.col_names)
    out = str(tmp / "topic")
    port_cli(["senna", "topic", "--data-files", data, "--out", out, "-k", "3",
              "--encoder-layers", "16", "--epochs", "2", "--num-levels", "1",
              "--hvg-genes", "0", "--block-size", "128", "--device", "cpu"])
    return dict(tmp=tmp, out=out)


@pytest.mark.parametrize("colour_by", ["cluster", "topic", "pseudotime", "annotation"])
def test_topic_run_chains_through_layout_clustering_and_plot(topic_run, colour_by):
    tmp, src = topic_run["tmp"], topic_run["out"]
    if not os.path.exists(str(tmp / "lay.layout.parquet")):
        port_cli(["senna", "layout", "--from", src, "--out", str(tmp / "lay"), "--epochs", "5",
                  "--device", "cpu"])
        port_cli(["senna", "clustering", "--from", src, "--out", str(tmp / "cl"),
                  "--method", "kmeans", "--n-clusters", "3", "--device", "cpu"])
    outputs = _manifest(src)["outputs"]
    assert outputs["layout"] == str(tmp / "lay.layout.parquet")
    assert outputs["clusters"] == str(tmp / "cl.clusters.parquet")
    cells = read_table(outputs["layout"])["cell"]
    pd.DataFrame({"cell": cells, "pseudotime": np.linspace(0, 1, len(cells))}).to_parquet(
        str(tmp / "pt.parquet"))
    (tmp / "ann.tsv").write_text("".join(f"{c}\tlab{i % 2}\n" for i, c in enumerate(cells)))
    extra = {"cluster": ["--hull", "--svg"],
             "topic": ["--layout", outputs["latent"], "--colour-by", "topic", "--no-labels"],
             "pseudotime": ["--colour-by", "pseudotime", "--pseudotime", str(tmp / "pt.parquet")],
             "annotation": ["--colour-by", "annotation", "--annotation", str(tmp / "ann.tsv")]}
    out = str(tmp / f"plot_{colour_by}.png")
    port_cli(["senna", "plot", "--from", src, "--out", out, *extra[colour_by]])
    assert os.path.getsize(out) > 0
    if colour_by == "cluster":
        assert os.path.getsize(str(tmp / "plot_cluster.svg")) > 0


@pytest.mark.parametrize("group_by", [None, "lines", "table"])
def test_plot_topic_with_the_dictionary(topic_run, group_by):
    tmp, src = topic_run["tmp"], topic_run["out"]
    cells = read_table(_manifest(src)["outputs"]["latent"])["cell"]
    args = ["senna", "plot-topic", "--from", src, "--top-genes", "5"]
    if group_by == "lines":
        (tmp / "groups.txt").write_text("".join(f"g{i % 2}\n" for i in range(len(cells))))
        args += ["--group-by", str(tmp / "groups.txt"), "--no-dict"]
    elif group_by == "table":
        pd.DataFrame({"cell": cells, "batch": [f"b{i % 3}" for i in range(len(cells))]}
                     ).to_parquet(str(tmp / "groups.parquet"))
        args += ["--group-by", str(tmp / "groups.parquet"), "--no-dict"]
    out = str(tmp / f"topics_{group_by}.png")
    port_cli([*args, "--out", out])
    if group_by is None:
        for f in (out, out + ".top_genes.tsv", out + ".dict_hinton.png"):
            assert os.path.getsize(f) > 0
        lines = open(out + ".top_genes.tsv").read().splitlines()
        assert len(lines) == 3 and all(len(ln.split("\t")) == 6 for ln in lines)
    else:
        n_groups = 2 if group_by == "lines" else 3
        written = [f for f in os.listdir(tmp) if f.startswith(f"topics_{group_by}.")]
        assert len(written) == n_groups and not os.path.exists(out + ".top_genes.tsv")


def test_plot_strand_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="GFF"):
        port_cli(["senna", "plot-strand", "--activity", "a.parquet", "--gff", "g.gff",
                  "--out", str(tmp_path / "s")])
