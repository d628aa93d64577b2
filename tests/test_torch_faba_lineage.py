"""`faba lineage` and `faba plot` in the port against the JAX package
(`legume_tpu/faba/{lineage,lineage_run}.py`, `cli/faba_cmds/gem_cmds.py`,
`plot_cmds.py`), on the planted Y trajectory of
`tests/test_lineage_forest.py` (700 cells, two dimensions).

Exact: k-means labels, candidate edges, direction calls and the bootstrap /
permutation draws behind them, the branching (parents, roots, trees), the
principal curves, pseudotime and every table a run with `--layout none`
writes. The layouts: PHATE's refinement rounds otherwise than XLA's
(`tests/test_torch_layout.py`), so its `cells_2d` / `nodes_2d` /
`curves_2d` and velocity arrows hold within 1e-4 (1.2e-5 measured, on a
span of 1.75). t-UMAP's 200 epochs are chaotic (`test_torch_layout.py`
holds its first steps), so its layout holds by the correlation of the two
layouts' pairwise cell distances, above 0.95 (0.980 measured), and its
velocity grid by its columns.
"""

import os

import numpy as np
import pandas as pd
import pytest

from faba_parity import same
from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import lineage as J
from legume_tpu.faba import lineage_run as JR
from legume_tpu.ops.kmeans import kmeans as j_kmeans
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.faba import lineage as T
from legume_tpu_torch.faba import lineage_run as TR
from legume_tpu_torch.ops.kmeans import kmeans as t_kmeans
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

LAYOUT_TABLES = ("cells_2d", "nodes_2d", "curves_2d")


@pytest.fixture(scope="module")
def y_trajectory():
    rng = np.random.default_rng(0)

    def seg(a, b, n):
        t = rng.uniform(0, 1, n)[:, None]
        return (np.array(a) + t * (np.array(b) - np.array(a))
                + rng.normal(0, 0.05, (n, 2)))

    theta = np.vstack([
        seg([0, 0], [1, 0], 300),
        seg([1, 0], [2, 1], 200),
        seg([1, 0], [2, -1], 200),
    ]).astype(np.float32)
    vel = (np.vstack([
        np.tile([1, 0], (300, 1)),
        np.tile([0.7, 0.7], (200, 1)),
        np.tile([0.7, -0.7], (200, 1)),
    ]) + rng.normal(0, 0.3, (700, 2))).astype(np.float32)
    return theta, vel


@pytest.fixture(scope="module")
def nodes(y_trajectory):
    """The JAX package's k-means grouping at 15 centroids, its MST and
    candidate edges: the inputs both packages' host stages take."""
    theta, _ = y_trajectory
    centroids, labels = j_kmeans(theta, 15, seed=1)
    centroids, labels = np.asarray(centroids), np.asarray(labels)
    mst = J.mst_from_centroids(centroids)
    return centroids, labels, mst, J.candidate_edges(centroids, mst, 4)


@pytest.fixture(scope="module")
def prefix(y_trajectory, tmp_path_factory):
    """A gem-style prefix over the Y: latent, velocity, a gene embedding
    pointing at the three compartments and a marker panel naming them."""
    theta, vel = y_trajectory
    tmp = tmp_path_factory.mktemp("lineage")
    cells = [f"c{i}" for i in range(len(theta))]

    def table(mat, cols, name, key="cell", rows=cells):
        pd.DataFrame(mat, columns=cols).assign(**{key: rows}).set_index(key) \
            .reset_index().to_parquet(tmp / f"fit.{name}.parquet")

    table(theta, ["h0", "h1"], "latent")
    table(vel, ["v0", "v1"], "velocity")
    gene_emb = np.zeros((30, 2), np.float32)
    gene_emb[:10] = [0.2, 0.0]
    gene_emb[10:20] = [2.0, 1.0]
    gene_emb[20:] = [2.0, -1.0]
    table(gene_emb, ["h0", "h1"], "gene_embedding", "gene", [f"g{i}" for i in range(30)])
    (tmp / "markers.tsv").write_text("".join(
        [f"g{i}\tTrunk\n" for i in range(10)]
        + [f"g{i}\tBranchUp\n" for i in range(10, 20)]
        + [f"g{i}\tBranchDown\n" for i in range(20, 30)]))
    tau = -theta[:, 1]  # gem's DAG pseudotime: lowest at the up-branch tip
    pd.DataFrame({"cell": cells, "pseudotime": tau}).to_parquet(tmp / "fit.dag_pseudotime.parquet")
    return str(tmp / "fit"), str(tmp / "markers.tsv"), cells


def test_kmeans_grouping_equals_jax(y_trajectory, nodes):
    theta, _ = y_trajectory
    centroids, labels = t_kmeans(theta, 15, seed=1, device="cpu")
    np.testing.assert_array_equal(np.asarray(labels), nodes[1])
    np.testing.assert_allclose(np.asarray(centroids), nodes[0], rtol=0, atol=1e-6)


def _direction_case(mod, case, y_trajectory, nodes):
    theta, vel = y_trajectory
    centroids, labels, mst, cand = nodes
    if case == "mst":
        return mod.mst_from_centroids(centroids)
    if case == "candidates":
        return mod.candidate_edges(centroids, mst, 4)
    if case == "directions":
        return mod.edge_directionality(centroids, vel, labels, cand, mst,
                                       n_boot=100, n_perm=200, seed=1)
    if case == "noise_abstains":
        noise = np.random.default_rng(2).normal(0, 1, vel.shape).astype(np.float32)
        return mod.edge_directionality(centroids, noise, labels, cand, mst,
                                       n_boot=100, n_perm=200, seed=1)
    if case == "mst_only":
        return mod.mst_only_directions(centroids, mst)
    if case == "bootstrap_and_sign_flip":
        rng = np.random.default_rng(5)
        x = rng.normal(0.2, 1.0, 40)
        return (mod.bootstrap_mean_ci(x, 200, 0.05, np.random.default_rng(1)),
                mod.sign_flip_pvalue(x, 300, np.random.default_rng(2)),
                mod.benjamini_hochberg(rng.uniform(0, 1, 25)))
    dirs = mod.edge_directionality(centroids, vel, labels, cand, mst,
                                   n_boot=100, n_perm=200, seed=1)
    arcs, aff = mod.assemble_arcs(dirs, 15, None, None)
    br = mod.max_branching(15, arcs, aff)
    if case == "branching":
        return arcs, aff, br
    if case == "forest":
        return mod.fit_forest_curves(theta, centroids, labels, br, dirs, resolution=40)
    root = int(np.argmin(centroids[:, 0]))
    return mod.fit_principal_curves(theta, centroids, mst, root, resolution=50)


@pytest.mark.parametrize("case", ["mst", "candidates", "directions", "noise_abstains",
                                  "mst_only", "bootstrap_and_sign_flip", "branching", "forest",
                                  "principal_curves"])
def test_host_stages_equal_jax(case, y_trajectory, nodes):
    same(_direction_case(T, case, y_trajectory, nodes),
         _direction_case(J, case, y_trajectory, nodes), case)


def test_max_branching_equals_jax_on_random_arc_sets():
    rng = np.random.default_rng(0)
    for _ in range(60):
        n = int(rng.integers(2, 7))
        arcs = []
        for _ in range(int(rng.integers(1, n * (n - 1) + 1))):
            u, v = rng.integers(0, n, 2)
            if u != v:
                arcs.append((int(u), int(v), float(rng.uniform(0, 2))))
        aff = rng.uniform(0, 2, n)
        same(T.max_branching(n, arcs, aff), J.max_branching(n, arcs, aff))


def test_root_resolvers_equal_jax(prefix, nodes):
    pre, _, cells = prefix
    labels = nodes[1]
    for mod in (T, J):
        assert mod.gem_root_node(pre, cells, labels, 15) == J.gem_root_node(pre, cells, labels, 15)
        assert (mod.resolve_root_hint(None, cells[7], cells, labels, 15, None, None)
                == J.resolve_root_hint(None, cells[7], cells, labels, 15, None, None))
    conf = np.linspace(0.2, 0.9, 4)
    calls = ["Trunk", "BranchUp", "Trunk", "unassigned"]
    assert T.root_type_node(calls, conf, "Trunk") == J.root_type_node(calls, conf, "Trunk") == 2


def test_theta_loading_and_layout_lifts_equal_jax(tmp_path, y_trajectory):
    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.ones(5), 50).astype(np.float32)
    pd.DataFrame(np.log(theta), columns=[f"k{j}" for j in range(5)]).assign(
        cell=[f"c{i}" for i in range(50)]).set_index("cell").reset_index().to_parquet(
        tmp_path / "t.latent.parquet")
    same(TR.load_theta(str(tmp_path / "t"), "auto", no_velocity=True),
         JR.load_theta(str(tmp_path / "t"), "auto", no_velocity=True))
    pts, vel = y_trajectory
    land = pts[::7]
    coords = np.stack([pts[::7, 0] * 2, pts[::7, 1]], 1).astype(np.float32)
    same(TR.project_cells_nystrom(pts, land, coords, 15),
         JR.project_cells_nystrom(pts, land, coords, 15))
    same(TR.project_onto_cells(land, pts, pts, 15), JR.project_onto_cells(land, pts, pts, 15))
    same(TR.velocity_grid_arrows(pts, pts, vel, 15, device="cpu"),
         JR.velocity_grid_arrows(pts, pts, vel, 15))


RUNS = {
    # a run that lays nothing out: every table exact
    "none_markers_root_type": dict(n_centroids=12, layout="none", markers=True,
                                   marker_num_perm=50, marker_n_boot=20, marker_min_support=0.3,
                                   root_type="Trunk"),
    "none_root_from_gem": dict(n_centroids=12, layout="none", root_from_gem=True),
    "phate": dict(n_centroids=15, layout="phate", phate_landmarks=80),
    "umap": dict(n_centroids=15, layout="umap", layout_pcs=0),
}


def _run_both(prefix, tmp_path, name):
    pre, markers, _ = prefix
    kw = dict(RUNS[name])
    if kw.pop("markers", False):
        kw["markers"] = markers
    kw = dict(seed=1, latent_geometry="euclidean", edge_direction_n_boot=80,
              edge_direction_n_perm=150, curve_resolution=40, **kw)
    got = TR.run_lineage(pre, str(tmp_path / "t"), device="cpu", **kw)
    want = JR.run_lineage(pre, str(tmp_path / "j"), **kw)
    return got, want


def _tables(tmp_path, side):
    return sorted(f[len(side) + 1:] for f in os.listdir(tmp_path) if f.startswith(side + "."))


@pytest.mark.parametrize("name", list(RUNS))
def test_run_lineage_writes_jax_tables(name, prefix, tmp_path):
    got, want = _run_both(prefix, tmp_path, name)
    assert set(got.pop("timings")) >= {"kmeans_s", "directions_s", "forest_s", "write_s"}
    same(got, want)
    files = _tables(tmp_path, "t")
    assert files == _tables(tmp_path, "j") and "pseudotime.parquet" in files
    for f in files:
        a, b = pd.read_parquet(tmp_path / f"t.{f}"), pd.read_parquet(tmp_path / f"j.{f}")
        assert list(a.columns) == list(b.columns), f
        table = f.split(".")[0]
        if table == "velocity_grid_2d" and name == "umap":
            assert list(a.columns) == list(b.columns) and len(a) > 5
        elif table == "cells_2d" and name == "umap":
            assert list(a.cell) == list(b.cell)
            d = [np.linalg.norm(t[:, None] - t[None], axis=-1).ravel()
                 for t in (a[["x", "y"]].to_numpy(), b[["x", "y"]].to_numpy())]
            assert np.corrcoef(*d)[0, 1] > 0.95
        elif table in LAYOUT_TABLES + ("velocity_grid_2d",):
            xy = [c for c in ("x", "y", "dx", "dy") if c in a.columns]
            if name == "phate":
                np.testing.assert_allclose(a[xy].to_numpy(), b[xy].to_numpy(), rtol=0, atol=1e-4,
                                           err_msg=f)
            same(a.drop(columns=xy), b.drop(columns=xy), f)
        else:
            same(a, b, f)


def test_lineage_meets_the_planted_y_bars(prefix, y_trajectory, tmp_path):
    theta, _ = y_trajectory
    res = TR.run_lineage(prefix[0], str(tmp_path / "y"), n_centroids=15, seed=1,
                         latent_geometry="euclidean", layout="none",
                         edge_direction_n_boot=80, edge_direction_n_perm=150,
                         curve_resolution=40, device="cpu")
    assert res["n_trees"] == 1 and res["n_lineages"] >= 2
    pt = pd.read_parquet(tmp_path / "y.pseudotime.parquet")
    assert np.corrcoef(theta[:, 0], np.nan_to_num(pt.pseudotime))[0, 1] > 0.95
    assert pd.read_parquet(tmp_path / "y.trees.parquet")["n_cells"].sum() == len(theta)


def test_cli_lineage_matches_jax(prefix, tmp_path, capsys):
    pre = prefix[0]
    argv = ["lineage", "--from", pre, "--n-centroids", "12", "--latent-geometry", "euclidean",
            "--layout", "none", "--edge-direction-n-boot", "50", "--edge-direction-n-perm",
            "100", "--curve-resolution", "30", "--seed", "1"]
    timings = t_faba(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    t_out = capsys.readouterr().out
    j_faba(argv + ["--out", str(tmp_path / "j")])
    assert t_out == capsys.readouterr().out and "kmeans_s" in timings
    files = _tables(tmp_path, "t")
    assert files == _tables(tmp_path, "j")
    for f in files:
        same(pd.read_parquet(tmp_path / f"t.{f}"), pd.read_parquet(tmp_path / f"j.{f}"), f)
    # the legacy explicit-file pair
    lat, vel = f"{pre}.latent.parquet", f"{pre}.velocity.parquet"
    legacy = ["lineage", "--latent", lat, "--velocity", vel, "--n-centroids", "12",
              "--layout", "none", "--edge-direction-n-boot", "40",
              "--edge-direction-n-perm", "60", "--curve-resolution", "20"]
    t_faba(legacy + ["--out", str(tmp_path / "lt"), "--device", "cpu"])
    j_faba(legacy + ["--out", str(tmp_path / "lj")])
    same(pd.read_parquet(tmp_path / "lt.edges.parquet"),
         pd.read_parquet(tmp_path / "lj.edges.parquet"))


def test_plot_renders_the_lineage_as_jax_does(prefix, tmp_path):
    pytest.importorskip("matplotlib")
    pre, markers, _ = prefix
    TR.run_lineage(pre, str(tmp_path / "q"), n_centroids=10, seed=1,
                   latent_geometry="euclidean", layout="phate", phate_landmarks=60,
                   curve_resolution=25, edge_direction_n_boot=50, edge_direction_n_perm=100,
                   markers=markers, marker_num_perm=30, marker_n_boot=10,
                   marker_min_support=0.2, device="cpu")
    lat = f"{pre}.latent.parquet"
    base = ["plot", "-f", str(tmp_path / "q"), "--latent", lat]
    t_faba(base + ["-o", str(tmp_path / "fig.pdf"), "--color-by", "celltype", "--svg",
                   "--pt-ramp", "rank", "--device", "cpu"])
    assert os.path.getsize(tmp_path / "fig.pdf") > 0 and os.path.getsize(tmp_path / "fig.svg") > 0
    t_faba(base + ["-o", str(tmp_path / "pt.png"), "--layout", "tumap", "--no-velocity-field",
                   "--backbone", "tree", "--device", "cpu"])
    assert os.path.getsize(tmp_path / "pt.png") > 0
