"""`senna pseudotime` (principal graph and `--velocity`) and `senna layout
--method tree` through both packages, port on the CPU: nodes within
1e-4, the tree, cell assignments, branches and root equal, pseudotime
within 1e-5, the tree layout's pieces within 1e-6, and the CLI's files
and manifest keys equal, a JAX-written pseudotime run included."""

import json

import numpy as np
import pandas as pd
import pytest

import legume_tpu.ops.principal_graph as jpg
from legume_tpu.cli import main as jcli
from legume_tpu.embedding.lineage import velocity_oriented_lineage as jlineage
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.embedding.lineage import velocity_oriented_lineage as tlineage
from legume_tpu_torch.ops import principal_graph as tpg
from legume_tpu_torch.utils.output import read_table


def _linear(seed=0):
    """`tests/test_trajectory.py:10`'s curve."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, 300))
    x = np.stack([t * 4, np.sin(t * 3)], 1) + rng.normal(0, 0.05, (300, 2))
    return x.astype(np.float32), t


def _y_shape():
    """`tests/test_trajectory.py:30`'s stem and two arms."""
    rng = np.random.default_rng(2)
    t = rng.uniform(0, 1, 100)
    stem = np.stack([t, np.zeros_like(t)], 1)
    arm1 = np.stack([1 + t, t], 1)
    arm2 = np.stack([1 + t, -t], 1)
    return (np.concatenate([stem, arm1, arm2]) + rng.normal(0, 0.03, (300, 2))).astype(np.float32)


def _star():
    """`tests/test_layouts.py:52`'s three branches in 3-D."""
    rng = np.random.default_rng(5)
    rows = []
    for dx, dy in ((1.0, 0.0), (-0.5, 0.866), (-0.5, -0.866)):
        for i in range(80):
            s = i / 80 * 5.0
            rows.append([dx * s + rng.normal(0, 0.05), dy * s + rng.normal(0, 0.05), 0.0])
    return np.asarray(rows, np.float32)


CASES = {
    "linear": lambda: (_linear()[0], dict(n_nodes=20, root_cell=0, seed=1)),
    "y_shape": lambda: (_y_shape(), dict(n_nodes=24, root_cell=None, seed=3)),
    "star_root_node": lambda: (_star(), dict(n_nodes=24, root_node=5, seed=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pseudotime_matches_jax(case):
    x, kw = CASES[case]()
    if case == "y_shape":
        kw["root_cell"] = int(np.argmin(x[:100, 0]))
    want = jpg.pseudotime(x, **kw)
    got = tpg.pseudotime(x, **kw, device="cpu")
    np.testing.assert_allclose(got.nodes, want.nodes, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.cell_to_node, want.cell_to_node)
    np.testing.assert_array_equal(got.branch, want.branch)
    assert got.root == want.root
    np.testing.assert_allclose(got.pseudotime, want.pseudotime, rtol=0, atol=1e-5)


def test_pseudotime_orders_and_branches():
    """`tests/test_trajectory.py`'s bars on the port."""
    x, t = _linear()
    pg = tpg.pseudotime(x, n_nodes=20, root_cell=0, seed=1, device="cpu")
    assert np.corrcoef(pg.pseudotime, t)[0, 1] > 0.95
    assert pg.pseudotime.min() >= 0 and pg.pseudotime.max() <= 1
    y = _y_shape()
    pg = tpg.pseudotime(y, n_nodes=24, root_cell=int(np.argmin(y[:100, 0])), seed=3, device="cpu")
    assert len(np.unique(pg.branch[pg.branch >= 0])) >= 3
    nodes, adj = tpg.fit_principal_tree(np.random.default_rng(1).normal(size=(200, 3))
                                        .astype(np.float32), n_nodes=15, seed=0, device="cpu")
    assert adj.sum() / 2 == nodes.shape[0] - 1 and np.allclose(adj, adj.T)


def test_tree_layout_pieces_match_jax():
    x = _star()
    pg = jpg.pseudotime(x, n_nodes=24, root_node=5, seed=0)
    edges, w = jpg.edge_list_from_adjacency(pg.nodes, pg.edges)
    t_edges, t_w = tpg.edge_list_from_adjacency(pg.nodes, pg.edges)
    np.testing.assert_array_equal(t_edges, edges)
    np.testing.assert_array_equal(t_w, w)
    je, jt = jpg.project_cells_to_edges(x, pg.nodes, edges)
    te, tt = tpg.project_cells_to_edges(x, pg.nodes, edges, device="cpu")
    np.testing.assert_array_equal(te, je)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    jxy = jpg.reingold_tilford_layout(pg.nodes, edges, w, pg.root)
    txy = tpg.reingold_tilford_layout(pg.nodes, edges, w, pg.root)
    np.testing.assert_allclose(txy, jxy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpg.place_cells_on_tree(edges, jxy, je, jt, jitter_frac=0.05),
                               jpg.place_cells_on_tree(edges, jxy, je, jt, jitter_frac=0.05),
                               rtol=0, atol=1e-6)


def _trajectory(n=300, seed=0):
    """`tests/test_lineage.py:8`'s curved path and its forward velocity."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n))
    pts = np.stack([t * 4.0, np.sin(t * 3.0)], 1)
    pts += rng.normal(scale=0.08, size=pts.shape)
    vel = np.stack([np.full(n, 4.0), 3.0 * np.cos(t * 3.0)], 1)
    vel += rng.normal(scale=0.2, size=vel.shape)
    return pts.astype(np.float32), vel.astype(np.float32), t


@pytest.mark.parametrize("seed,sign", [(0, 1.0), (1, -1.0)])
def test_velocity_lineage_matches_jax(seed, sign):
    pts, vel, t = _trajectory(seed=seed)
    want = jlineage(pts, sign * vel, n_nodes=15, seed=0)
    got = tlineage(pts, sign * vel, n_nodes=15, seed=0, device="cpu")
    assert got.root_node == want.root_node
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_allclose(got.pseudotime, want.pseudotime, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.consistency, want.consistency, rtol=0, atol=1e-5)
    assert sign * np.corrcoef(got.pseudotime, t)[0, 1] > 0.9
    if sign > 0:
        assert (got.consistency > 0).mean() > 0.8


def _manifest(prefix):
    return json.loads(open(prefix + ".senna.json").read())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The star as a JAX-written latent; each package's pseudotime run on it
    (principal graph and velocity) and its tree layout."""
    tmp = tmp_path_factory.mktemp("pt")
    z = _star()
    zp = str(tmp / "z.parquet")
    cells = [f"c{i}" for i in range(len(z))]
    pd.DataFrame(z, index=cells, columns=["h0", "h1", "h2"]).reset_index(names="cell").to_parquet(zp)
    vel = np.roll(z, -1, axis=0) - z
    vp = str(tmp / "vel.parquet")
    pd.DataFrame(vel, index=cells, columns=["v0", "v1", "v2"]).reset_index(names="cell").to_parquet(vp)
    origin = str(int(np.argmin((z**2).sum(1))))
    for who, run in (("j", jcli.run_senna), ("p", lambda a: port_cli(["senna", *a, "--device", "cpu"]))):
        run(["pseudotime", "--latent", zp, "--out", str(tmp / f"{who}_pt"), "--n-nodes", "24",
             "--root-cell", origin])
        run(["pseudotime", "--latent", zp, "--out", str(tmp / f"{who}_vel"), "--velocity", vp,
             "--n-nodes", "12"])
        run(["layout", "--method", "tree", "--from", str(tmp / f"{who}_pt"), "--out",
             str(tmp / f"{who}_tl"), "--tree-jitter", "0.05"])
    return tmp


@pytest.mark.parametrize("mode", ["pt", "vel"])
def test_pseudotime_cli_writes_what_the_jax_cli_writes(runs, mode):
    j, p = _manifest(str(runs / f"j_{mode}")), _manifest(str(runs / f"p_{mode}"))
    assert set(p["outputs"]) == set(j["outputs"]) and p["params"] == j["params"]
    want = pd.read_parquet(j["outputs"]["pseudotime"])
    got = read_table(p["outputs"]["pseudotime"])
    assert list(got) == list(want.columns)
    np.testing.assert_allclose(got["pseudotime"], want["pseudotime"], rtol=0, atol=1e-5)
    if mode == "pt":
        for col in ("branch", "node"):
            np.testing.assert_array_equal(got[col], want[col])
        for key in ("pt_nodes_latent", "pt_edges"):
            g, w = read_table(p["outputs"][key]), pd.read_parquet(j["outputs"][key])
            assert list(g) == list(w.columns)
        np.testing.assert_array_equal(read_table(p["outputs"]["pt_edges"])["to"],
                                      pd.read_parquet(j["outputs"]["pt_edges"])["to"])
    else:
        np.testing.assert_allclose(got["consistency"], want["consistency"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("source", ["p", "j"])
def test_layout_tree_cli_matches_jax(runs, source, tmp_path):
    """The port's tree layout of its own pseudotime run and of the JAX
    package's (its parquet nodes, edges and latent) against the JAX
    package's tree layout; y tracks the geodesic pseudotime and the star
    fans out into at least 3 leaf slots (`tests/test_layouts.py:52`)."""
    if source == "j":  # a copy of the JAX run's manifest, so the JAX run stays as written
        doc = _manifest(str(runs / "j_pt"))
        (tmp_path / "jpt.senna.json").write_text(json.dumps(doc))
        port_cli(["senna", "layout", "--method", "tree", "--from", str(tmp_path / "jpt"),
                  "--out", str(tmp_path / "tl"), "--tree-jitter", "0.05", "--device", "cpu"])
        p = _manifest(str(tmp_path / "jpt"))
    else:
        p = _manifest(str(runs / "p_pt"))
    j = _manifest(str(runs / "j_pt"))
    assert set(p["outputs"]) == set(j["outputs"])
    for key, cols in (("tree_cell_coords", ["cell", "x", "y"]), ("tree_nodes_2d", ["node", "x", "y"])):
        got, want = read_table(p["outputs"][key]), pd.read_parquet(j["outputs"][key])
        assert list(got) == cols == list(want.columns)
        np.testing.assert_allclose(np.stack([got["x"], got["y"]], 1),
                                   want[["x", "y"]].to_numpy(), rtol=0, atol=1e-4)
    xy = read_table(p["outputs"]["tree_cell_coords"])
    nodes = read_table(p["outputs"]["tree_nodes_2d"])
    t_true = np.tile(np.arange(80) / 80 * 5.0, 3)
    ok = np.isfinite(xy["y"])
    assert ok.mean() >= 0.9 and np.corrcoef(xy["y"][ok], t_true[ok])[0, 1] > 0.8
    assert len(np.unique(np.round(nodes["x"][np.isfinite(nodes["x"])], 3))) >= 3
