"""`faba lineage` orchestration: inputs, layouts, marker node calls,
and every table the command puts on disk
(`faba/src/lineage/{run,input,layout,velocity_grid,traj_annotation,
write}.rs` equivalents). The port's copy of the JAX package's
`faba/lineage_run.py`: the same tables under the same names, with k-means,
the kNN, PHATE and UMAP on `device` (default `cuda`) through the port's
ops; the rest is the same numpy on the host. `run_lineage` returns its
stage seconds under `timings`.

Declared divergences (MIGRATION.md):
  - θ-table auto-detection is EMPIRICAL (exp(rows) summing to 1 marks
    a log-θ simplex) rather than manifest-stamped: our producers do
    not stamp `latent: log-theta` (`input.rs resolve_theta_from`
    checks the manifest).
  - gem here names its H-space cell table `latent.parquet`; the
    loader accepts `cell_embedding.parquet` first and falls back.
  - node marker calls score node centroids against the gem gene
    embedding with a permutation-z (the `annotate_by_projection`
    core); the reference routes through its term-ORA engine. The
    bootstrap redraws BOTH the marker panels and the k-means grouping
    per replicate, as the reference does (`traj_annotation.rs`).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

import numpy as np

from ..ops.kmeans import kmeans
from .lineage import (
    ABSTAIN,
    Branching,
    EdgeDirections,
    PrincipalCurves,
    _CALL_NAMES,
    apply_geometry,
    assemble_arcs,
    candidate_edges,
    choose_k,
    cluster_features,
    edge_directionality,
    fit_forest_curves,
    gem_root_node,
    l2_normalize_rows,
    max_branching,
    mst_from_centroids,
    mst_only_directions,
    resolve_root_hint,
    root_type_node,
    theta_centroids_from_labels,
)

log = logging.getLogger(__name__)

WARP_STEP_FRAC = 0.15  # layout.rs WARP_STEP_FRAC
GRID = 30  # velocity_grid.rs GRID
MIN_PER_CELL = 5  # velocity_grid.rs MIN_PER_CELL


# ---------------------------------------------------------------- #
# Inputs (lineage/input.rs)                                         #
# ---------------------------------------------------------------- #


@dataclass
class LoadedTheta:
    cell_names: list
    theta: np.ndarray  # native (untransformed)
    velocity: np.ndarray | None
    theta_from: str  # resolved: "latent" | "cell-embedding"


def _read_cell_table(path: str):
    import pandas as pd

    df = pd.read_parquet(path)
    return (
        df.iloc[:, 0].astype(str).tolist(),
        df.iloc[:, 1:].to_numpy(np.float32),
    )


def _looks_log_theta(mat: np.ndarray) -> bool:
    """Empirical log-θ check: exp of each row sums to ~1 (the simplex
    contract `input.rs` reads from the manifest stamp)."""
    probe = np.exp(mat[: min(64, len(mat))].astype(np.float64))
    return bool(np.allclose(probe.sum(1), 1.0, atol=1e-2))


def load_theta(
    prefix: str, theta_from: str = "auto", *, no_velocity: bool = False
) -> LoadedTheta:
    """Read the θ/δ pair by prefix (`input.rs load_theta`): the
    `latent` path holds LOG θ (exponentiated here) paired with
    `velocity_factor.parquet` (K space); the embedding path reads
    `cell_embedding.parquet` (or our gem's `latent.parquet` H table)
    paired with `velocity.parquet`."""
    ce_path = f"{prefix}.cell_embedding.parquet"
    lat_path = f"{prefix}.latent.parquet"
    if theta_from == "auto":
        if os.path.exists(lat_path):
            _, probe = _read_cell_table(lat_path)
            if _looks_log_theta(probe):
                theta_from = "latent"
                log.info(
                    "--theta-from auto → latent: %s holds a log-θ simplex, "
                    "fitting the simplex directly", lat_path,
                )
            else:
                theta_from = "cell-embedding"
        else:
            theta_from = "cell-embedding"

    if theta_from == "latent":
        cells, mat = _read_cell_table(lat_path)
        if not _looks_log_theta(mat):
            raise ValueError(
                f"--theta-from latent: {lat_path} rows do not exponentiate "
                "to a simplex — this is not a log-θ table; pass "
                "--theta-from cell-embedding"
            )
        theta = np.exp(mat.astype(np.float64)).astype(np.float32)
        vel_path = f"{prefix}.velocity_factor.parquet"
    else:
        path = ce_path if os.path.exists(ce_path) else lat_path
        cells, theta = _read_cell_table(path)
        vel_path = f"{prefix}.velocity.parquet"

    velocity = None
    if not no_velocity:
        if os.path.exists(vel_path):
            vcells, velocity = _read_cell_table(vel_path)
            if velocity.shape != theta.shape:
                raise ValueError(
                    f"velocity {vel_path} shape {velocity.shape} must match "
                    f"θ shape {theta.shape} — δ must live in θ's space"
                )
        else:
            log.warning(
                "velocity file %s absent; forest falls back to the "
                "geometric MST", vel_path,
            )
    return LoadedTheta(
        cell_names=cells, theta=theta, velocity=velocity,
        theta_from=theta_from,
    )


def resolve_geometry(requested: str, theta_from: str) -> str:
    """auto → hellinger on a simplex, cosine on a cell embedding
    (`input.rs resolve_geometry`)."""
    if requested != "auto":
        return requested
    return "hellinger" if theta_from == "latent" else "cosine"


# ---------------------------------------------------------------- #
# Layouts (lineage/layout.rs, velocity_grid.rs)                     #
# ---------------------------------------------------------------- #


def project_cells_nystrom(
    query: np.ndarray,  # [M, D]
    landmarks: np.ndarray,  # [L, D]
    coords: np.ndarray,  # [L, 2]
    knn: int,
    alpha: float = 40.0,
    *,
    block: int = 4096,
) -> np.ndarray:
    """Alpha-decay Nyström lift onto a landmark layout
    (`matrix_util/layout.rs project_cells_nystrom`): per query, the
    kernel bandwidth is the distance to its knn-th landmark; weights
    row-normalize (nearest landmark wins on total underflow)."""
    m, nl = len(query), len(landmarks)
    out = np.zeros((m, 2), np.float32)
    if m == 0 or nl == 0:
        return out
    kth = min(max(knn, 1), nl) - 1
    l2 = (landmarks.astype(np.float64) ** 2).sum(1)
    for s in range(0, m, block):
        q = query[s : s + block].astype(np.float64)
        d = np.sqrt(np.maximum(
            (q**2).sum(1)[:, None] - 2.0 * q @ landmarks.T.astype(np.float64)
            + l2[None], 0.0,
        ))
        sigma = np.maximum(np.sort(d, axis=1)[:, kth], 1e-6)
        w = np.exp(-np.minimum((d / sigma[:, None]) ** alpha, 700.0))
        tot = w.sum(1)
        dead = tot <= 1e-12
        if dead.any():
            w[dead] = 0.0
            w[np.nonzero(dead)[0], d[dead].argmin(1)] = 1.0
            tot[dead] = 1.0
        out[s : s + block] = (w / tot[:, None]) @ coords
    return out.astype(np.float32)


def project_onto_cells(
    pts: np.ndarray, cell_theta: np.ndarray, cells_2d: np.ndarray, knn: int
) -> np.ndarray:
    """Place θ-space points onto a cells-only 2D layout at the mean 2D
    of their knn θ-nearest cells (`layout.rs project_onto_cells` —
    t-UMAP has no Nyström)."""
    n = len(cell_theta)
    k = int(np.clip(knn, 1, max(n, 1)))
    out = np.zeros((len(pts), 2), np.float32)
    c2 = (cell_theta**2).sum(1)
    for p0 in range(0, len(pts), 1024):
        pb = pts[p0 : p0 + 1024]
        d2 = (pb**2).sum(1)[:, None] - 2.0 * pb @ cell_theta.T + c2[None]
        nn = np.argpartition(d2, min(k - 1, n - 1), axis=1)[:, :k]
        out[p0 : p0 + 1024] = cells_2d[nn].mean(axis=1)
    return out


def phate_landmark_layout(
    theta_n: np.ndarray, *, knn: int, t, n_landmarks: int, seed: int,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """PHATE on k-means landmarks when N exceeds the budget — caps the
    O(n³) work, the rest lifts via Nyström (`layout.rs
    phate_landmark_layout`); exact PHATE below the budget."""
    from ..ops.layouts import phate as phate_2d

    n = len(theta_n)
    if n <= n_landmarks or n_landmarks < 3:
        return theta_n, phate_2d(theta_n, knn=knn, t=t, seed=seed, device=device)
    land, _ = kmeans(theta_n, n_landmarks, iters=15, seed=seed, device=device)
    land = np.asarray(land, np.float32)
    return land, phate_2d(land, knn=knn, t=t, seed=seed, device=device)


def warp_layout_along_flow(
    nodes_2d: np.ndarray,
    cells_2d: np.ndarray,
    dirs: EdgeDirections,
    br: Branching,
    labels: np.ndarray,
) -> None:
    """Nudge nodes along the net 2D flow of their confident selected
    edges (child downstream, parent upstream), step = 15% of the mean
    selected-edge length; cells follow their node (`layout.rs
    warp_layout_along_flow`). In place."""
    k = len(nodes_2d)
    dmap = dirs.as_map()
    disp = np.zeros((k, 2), np.float64)
    len_sum = len_cnt = 0.0
    for v in range(k):
        p = br.parent[v]
        if p is None:
            continue
        i = dmap.get((min(p, v), max(p, v)))
        if i is None or dirs.call[i] == ABSTAIN:
            continue
        d = nodes_2d[v] - nodes_2d[p]
        ln = max(float(np.linalg.norm(d)), 1e-6)
        len_sum += ln
        len_cnt += 1
        u = float(dirs.confidence[i]) * d / ln
        disp[v] += u
        disp[p] -= u
    step = WARP_STEP_FRAC * len_sum / len_cnt if len_cnt else 0.0
    nodes_2d += (step * disp).astype(nodes_2d.dtype)
    ok = labels < k
    cells_2d[ok] += (step * disp[labels[ok]]).astype(cells_2d.dtype)


def velocity_grid_arrows(
    cells_2d: np.ndarray,
    theta: np.ndarray,
    delta: np.ndarray,
    knn: int,
    *,
    device="cuda",
) -> np.ndarray:
    """scVelo-style gridded arrows (`velocity_grid.rs
    velocity_grid_arrows`): per-cell 2D velocity = θ-neighbour
    transition-weighted mean layout displacement (weight =
    max(0, cos(δ_i, θ_j − θ_i))), averaged onto a 30×30 lattice,
    bins with ≥ 5 cells, unit arrows scaled to the grid pitch.
    Returns [G, 4] rows (x, y, dx, dy)."""
    from ..ops.knn import knn_within

    n, h = theta.shape
    if n == 0:
        return np.zeros((0, 4), np.float32)
    k = int(np.clip(knn, 1, n - 1))
    _, nbr_idx = knn_within(theta, k, device=device)
    nbr_idx = np.asarray(nbr_idx, np.int64)
    # symmetric neighbour lists via the edge union
    cell_vel = np.zeros((n, 2), np.float64)
    di = np.linalg.norm(delta, axis=1)
    src = np.repeat(np.arange(n), nbr_idx.shape[1])
    dst = nbr_idx.ravel()
    both_src = np.concatenate([src, dst])
    both_dst = np.concatenate([dst, src])
    dth = theta[both_dst] - theta[both_src]  # [E, H]
    dot = (delta[both_src] * dth).sum(1)
    dj = np.linalg.norm(dth, axis=1)
    cos = np.where(
        (dj > 1e-6) & (di[both_src] > 1e-8),
        dot / np.maximum(di[both_src] * dj, 1e-12), 0.0,
    )
    wt = np.maximum(cos, 0.0)
    d2d = cells_2d[both_dst] - cells_2d[both_src]
    dn = np.maximum(np.linalg.norm(d2d, axis=1), 1e-8)
    contrib = wt[:, None] * d2d / dn[:, None]
    np.add.at(cell_vel, both_src, contrib)
    wsum = np.zeros(n)
    np.add.at(wsum, both_src, wt)
    nz = wsum > 0
    cell_vel[nz] /= wsum[nz, None]

    xmin, ymin = cells_2d.min(0)
    xmax, ymax = cells_2d.max(0)
    wx, wy = max(xmax - xmin, 1e-6), max(ymax - ymin, 1e-6)
    pitch = min(wx / GRID, wy / GRID)
    gx = np.minimum(((cells_2d[:, 0] - xmin) / wx * GRID).astype(int), GRID - 1)
    gy = np.minimum(((cells_2d[:, 1] - ymin) / wy * GRID).astype(int), GRID - 1)
    key = gx * GRID + gy
    out = []
    for kk in np.unique(key):
        sel = key == kk
        if sel.sum() < MIN_PER_CELL:
            continue
        mx, my = cells_2d[sel].mean(0)
        mdx, mdy = cell_vel[sel].mean(0)
        mag = float(np.hypot(mdx, mdy))
        if mag < 1e-6:
            continue
        out.append((mx, my, mdx / mag * pitch, mdy / mag * pitch))
    return np.asarray(out, np.float32).reshape(-1, 4)


# ---------------------------------------------------------------- #
# Marker node calls (lineage/traj_annotation.rs)                    #
# ---------------------------------------------------------------- #


def load_marker_sets(path: str) -> dict:
    """Marker panels from a `gene<TAB>celltype` TSV (tab/comma/space
    delimited, `args.rs --markers`) or a GMT (≥3 columns = GMT)."""
    import gzip
    import re

    opener = gzip.open if str(path).endswith(".gz") else open
    sets: dict[str, list] = {}
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = re.split(r"[\t, ]+", line)
            if len(parts) >= 3 and "\t" in line and len(line.split("\t")) >= 3:
                sets.setdefault(parts[0], []).extend(
                    g for g in parts[2:] if g
                )  # GMT row
            elif len(parts) >= 2:
                sets.setdefault(parts[1], []).append(parts[0])
    return sets


@dataclass
class NodeCalls:
    """Per-node marker call (`CommunityCalls` role)."""

    labels: list  # [K] cell-type string per node
    confidence: np.ndarray  # [K]
    zscores: np.ndarray  # [K, T]
    types: list


def node_marker_calls(
    raw_theta: np.ndarray,  # [N, H] — H-space cell embedding
    gene_emb: np.ndarray,  # [D, H] co-embedded gene vectors
    gene_names: list,
    marker_sets: dict,
    labels: np.ndarray,
    k: int,
    *,
    theta_fit: np.ndarray,  # grouping space, for bootstrap regrouping
    num_perm: int = 500,
    bootstrap: bool = True,
    n_boot: int = 200,
    min_support: float = 0.5,
    kmeans_iter: int = 100,
    seed: int = 0,
    device="cuda",
) -> NodeCalls:
    """Name each trajectory node by cell type: node centroids (mean
    H-space embedding) scored against marker signatures with a
    permutation null; the stability bootstrap redraws BOTH the panels
    and the k-means grouping per replicate (`traj_annotation.rs
    compute_node_calls`) — a label that survives a re-seeded grouping
    is a label worth printing on a trajectory."""
    from ..embedding.type_annotation import annotate_by_projection

    def centroids_of(lab):
        c = np.zeros((k, raw_theta.shape[1]), np.float64)
        np.add.at(c, lab, raw_theta.astype(np.float64))
        cnt = np.maximum(np.bincount(lab, minlength=k), 1)
        return (c / cnt[:, None]).astype(np.float32)

    base = annotate_by_projection(
        centroids_of(labels), gene_emb, gene_names, marker_sets,
        n_permutations=num_perm, min_z=0.0, seed=seed,
    )
    conf = _z_to_conf(base.zscores.max(1))
    out_labels = list(base.labels)
    if bootstrap and n_boot > 0:
        rng = np.random.default_rng(seed)
        agree = np.zeros(k)
        for r in range(n_boot):
            panels = {
                t: list(rng.choice(g, len(g), replace=True))
                for t, g in marker_sets.items()
            }
            _, lab_r = kmeans(
                theta_fit, k, iters=kmeans_iter, seed=int(rng.integers(2**31)),
                device=device,
            )
            lab_r = np.asarray(lab_r)
            rep = annotate_by_projection(
                centroids_of(lab_r), gene_emb, gene_names, panels,
                n_permutations=0 if num_perm == 0 else 20,
                min_z=0.0, seed=int(rng.integers(2**31)),
            )
            # map each original node to the replicate node holding the
            # plurality of its cells, then compare calls
            for v in range(k):
                members = labels == v
                if not members.any():
                    continue
                counts = np.bincount(lab_r[members], minlength=k)
                twin = int(counts.argmax())
                if rep.labels[twin] == out_labels[v]:
                    agree[v] += 1
        support = agree / n_boot
        conf = np.minimum(conf, support).astype(np.float32)
        for v in range(k):
            if support[v] < min_support:
                out_labels[v] = "unassigned"
    return NodeCalls(
        labels=out_labels, confidence=conf.astype(np.float32),
        zscores=base.zscores, types=list(marker_sets),
    )


def _z_to_conf(z: np.ndarray) -> np.ndarray:
    from math import sqrt

    from scipy.special import erf

    return 0.5 * (1.0 + erf(np.asarray(z, np.float64) / sqrt(2.0)))


# ---------------------------------------------------------------- #
# run_lineage orchestration (lineage/run.rs)                        #
# ---------------------------------------------------------------- #


def run_lineage(
    prefix: str,
    out: str | None = None,
    *,
    theta: np.ndarray | None = None,  # explicit override (back-compat)
    velocity: np.ndarray | None = None,
    cell_names: list | None = None,
    theta_from: str = "auto",
    latent_geometry: str = "auto",
    n_centroids: int | None = None,
    seed: int = 42,
    kmeans_iter: int = 100,
    cluster_space: str = "identity",
    no_edge_direction: bool = False,
    no_orient_velocity: bool = False,
    edge_cand_knn: int = 4,
    edge_direction_n_boot: int = 200,
    edge_direction_n_perm: int = 500,
    edge_alpha: float = 0.05,
    edge_min_cells: int = 2,
    root_affinity: float | None = None,
    root_type: str | None = None,
    root_from_gem: bool = False,
    root_node: int | None = None,
    root_cell: str | None = None,
    curve_bandwidth: float = 0.0,
    curve_resolution: int = 100,
    max_iter: int = 15,
    tol: float = 1e-3,
    markers: str | None = None,
    marker_num_perm: int = 500,
    marker_obo: str | None = None,
    marker_label_cl: str | None = None,
    no_bootstrap_markers: bool = False,
    marker_n_boot: int = 200,
    marker_min_support: float = 0.5,
    layout: str = "phate",
    layout_space: str = "identity",
    layout_pcs: int = 20,
    velocity_aware_layout: str = "auto",
    phate_knn: int = 15,
    phate_t: int = 0,
    phate_landmarks: int = 2000,
    device="cuda",
) -> dict:
    """The full `faba lineage` pipeline (`run.rs run_lineage`); writes
    the reference's table set under `{out}.*` and returns a summary
    dict, with the seconds of each stage under `timings`. See module
    docstring for declared divergences."""
    timings: dict = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        timings[name] = t1 - t0
        t0 = t1

    out = out or prefix
    if root_type is not None and markers is None:
        raise ValueError(
            "--root-type needs --markers (the node cell-type calls come "
            "from the marker annotation)"
        )
    if theta is None:
        loaded = load_theta(prefix, theta_from, no_velocity=no_orient_velocity)
        theta_native, vel = loaded.theta, loaded.velocity
        cell_names = loaded.cell_names
        theta_from = loaded.theta_from
    else:
        theta_native = np.asarray(theta, np.float32)
        vel = None if no_orient_velocity else velocity
        cell_names = (
            list(cell_names) if cell_names is not None
            else [f"cell_{i}" for i in range(len(theta_native))]
        )
        theta_from = "cell-embedding" if theta_from == "auto" else theta_from
    n = len(theta_native)
    if n < 2:
        raise ValueError(f"need >= 2 cells, got {n}")

    lap("load_s")
    geometry = resolve_geometry(latent_geometry, theta_from)
    theta_t = apply_geometry(theta_native, geometry)
    log.info("fit + layout geometry: %s", geometry)

    k = choose_k(n, n_centroids)
    feats = cluster_features(theta_t, vel, cluster_space)
    _, labels = kmeans(feats, k, iters=kmeans_iter, seed=seed, device=device)
    labels = np.asarray(labels)
    lap("kmeans_s")
    centroids = theta_centroids_from_labels(theta_t, labels, k)
    log.info("lineage: %d cells x %d dims -> %d centroids",
             n, theta_t.shape[1], k)
    mst = mst_from_centroids(centroids)

    # node velocities (mean δ per node)
    if vel is not None:
        node_vel = theta_centroids_from_labels(vel, labels, k)
    else:
        node_vel = np.zeros_like(centroids)

    cand = candidate_edges(centroids, mst, edge_cand_knn)
    if vel is not None and not no_edge_direction:
        dirs = edge_directionality(
            centroids, vel, labels, cand, mst,
            n_boot=edge_direction_n_boot, n_perm=edge_direction_n_perm,
            alpha=edge_alpha, min_cells=edge_min_cells, seed=seed,
        )
    else:
        dirs = mst_only_directions(centroids, mst)
    n_called = int((dirs.call != ABSTAIN).sum())
    lap("directions_s")
    log.info("edge directions: %d/%d candidate edges confidently oriented",
             n_called, len(dirs))

    # marker node calls BEFORE rooting so --root-type can use them
    node_calls = None
    if markers is not None:
        node_calls = _compute_node_calls(
            prefix, out, markers, theta_native, labels, k,
            theta_fit=theta_t, num_perm=marker_num_perm,
            bootstrap=not no_bootstrap_markers, n_boot=marker_n_boot,
            min_support=marker_min_support, kmeans_iter=kmeans_iter,
            seed=seed, obo=marker_obo, label_cl=marker_label_cl,
            device=device,
        )
        lap("markers_s")

    type_root = (
        root_type_node(node_calls.labels, node_calls.confidence, root_type)
        if (root_type is not None and node_calls is not None) else None
    )
    gem_root = (
        gem_root_node(prefix, cell_names, labels, k)
        if root_from_gem else None
    )
    hint = resolve_root_hint(
        root_node, root_cell, cell_names, labels, k, type_root, gem_root
    )

    arcs, aff = assemble_arcs(dirs, k, root_affinity, hint)
    br = max_branching(k, arcs, aff)
    log.info("forest: %d tree(s), %d directed edge(s) over %d nodes",
             len(br.roots), sum(p is not None for p in br.parent), k)

    forest = fit_forest_curves(
        theta_t, centroids, labels, br, dirs,
        max_iter=max_iter, tol=tol, resolution=curve_resolution,
        bandwidth=curve_bandwidth,
    )
    curves = forest.curves
    lap("forest_s")
    n_unplaced = int(np.isnan(curves.pseudotime).sum())
    if n_unplaced:
        log.warning(
            "%d/%d cell(s) have no pseudotime (tree too small for a "
            "curve); written as NaN and skipped by `faba dyn-assoc`",
            n_unplaced, n,
        )

    # ------------------------------------------------------------ #
    # outputs (write.rs schemas)
    # ------------------------------------------------------------ #
    _write_nodes(centroids, f"{out}.nodes.parquet")
    _write_nodes(node_vel, f"{out}.node_velocity.parquet")
    _write_edges(dirs, br, f"{out}.edges.parquet")
    _write_trees(br, labels, dirs, f"{out}.trees.parquet")
    _write_lineages(curves, f"{out}.lineages.parquet")
    _write_pseudotime(
        curves, forest.cell_tree, forest.order_conf, cell_names,
        f"{out}.pseudotime.parquet",
    )
    _write_cell_matrix(curves.weights, cell_names, "lineage",
                       f"{out}.cell_lineage_weights.parquet")
    _write_cell_matrix(curves.lineage_pseudotime, cell_names, "lineage",
                       f"{out}.lineage_pseudotime.parquet")
    _write_curves(curves, f"{out}.curves.parquet")
    if node_calls is not None:
        _write_trajectory_annotation(
            node_calls, br, f"{out}.trajectory_annotation.parquet"
        )
    lap("write_s")

    if layout != "none":
        _emit_layout(
            layout, theta_t, theta_native, vel, geometry, layout_space,
            centroids, curves, cell_names, labels, dirs, br,
            velocity_aware_layout, phate_knn, phate_t, phate_landmarks,
            layout_pcs, seed, out, n_called, device,
        )
        lap("layout_s")

    return {
        "n_cells": n, "k": k, "n_trees": len(br.roots),
        "n_lineages": curves.n_lineages(), "roots": br.roots,
        "edges_called": n_called, "edges_total": len(dirs),
        "n_unplaced": n_unplaced, "timings": timings,
    }


def _compute_node_calls(
    prefix, out, markers, raw_theta, labels, k, *, theta_fit, num_perm,
    bootstrap, n_boot, min_support, kmeans_iter, seed, obo, label_cl,
    device="cuda",
) -> NodeCalls:
    """Marker node calls + `{out}.lineage_annot.parquet`
    (`traj_annotation.rs compute_node_calls`). The gene vectors come
    from `{prefix}.gene_embedding.parquet` — the co-embedded H-space
    table, not β (`gem/marker_embedding.rs` rationale)."""
    import pandas as pd

    ge_path = f"{prefix}.gene_embedding.parquet"
    if not os.path.exists(ge_path):
        raise FileNotFoundError(
            f"--markers needs {ge_path} (the gem co-embedded gene vectors)"
        )
    ge = pd.read_parquet(ge_path)
    gene_names = ge.iloc[:, 0].astype(str).tolist()
    gene_emb = ge.iloc[:, 1:].to_numpy(np.float32)
    if gene_emb.shape[1] != raw_theta.shape[1]:
        raise ValueError(
            f"gene embedding H={gene_emb.shape[1]} but θ H="
            f"{raw_theta.shape[1]} — marker scoring needs one space"
        )
    sets = load_marker_sets(markers)
    calls = node_marker_calls(
        raw_theta, gene_emb, gene_names, sets, labels, k,
        theta_fit=theta_fit, num_perm=num_perm, bootstrap=bootstrap,
        n_boot=n_boot, min_support=min_support,
        kmeans_iter=kmeans_iter, seed=seed, device=device,
    )
    table = {
        "node": [f"node_{i}" for i in range(k)],
        "cell_type": calls.labels,
        "confidence": calls.confidence,
    }
    if obo is not None and label_cl is not None:
        table["cl_id"] = _cl_ids(calls.labels, label_cl)
    pd.DataFrame(table).to_parquet(f"{out}.lineage_annot.parquet")
    log.info("wrote %s.lineage_annot.parquet", out)
    return calls


def _cl_ids(labels: list, label_cl: str) -> list:
    """label → CL id map from a `label<TAB>CL:id` TSV
    (`--marker-label-cl`)."""
    lut = {}
    with open(label_cl) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                lut[parts[0].lower()] = parts[1]
    return [lut.get(str(lab).lower(), ".") for lab in labels]


# ---------------------------------------------------------------- #
# Writers (write.rs)                                                #
# ---------------------------------------------------------------- #


def _write_nodes(mat: np.ndarray, path: str) -> None:
    import pandas as pd

    pd.DataFrame(
        mat, columns=[f"T{j}" for j in range(mat.shape[1])],
        index=[f"node_{i}" for i in range(len(mat))],
    ).reset_index(names="node").to_parquet(path)
    log.info("Wrote %s", path)


def _write_edges(dirs: EdgeDirections, br: Branching, path: str) -> None:
    """All candidate edges with stats + the branching's selection
    (`write.rs write_edge_directions` schema, column for column)."""
    import pandas as pd

    m = len(dirs)
    sel = np.zeros(m, np.float32)
    dfrom = np.full(m, np.nan, np.float32)
    dto = np.full(m, np.nan, np.float32)
    tree = np.full(m, np.nan, np.float32)
    for i in range(m):
        a, b = int(dirs.edge[i, 0]), int(dirs.edge[i, 1])
        if br.parent[b] == a:
            sel[i], dfrom[i], dto[i], tree[i] = 1, a, b, br.tree[b]
        elif br.parent[a] == b:
            sel[i], dfrom[i], dto[i], tree[i] = 1, b, a, br.tree[a]
    pd.DataFrame({
        "edge": [f"edge_{i}" for i in range(m)],
        "from": dirs.edge[:, 0].astype(np.float32),
        "to": dirs.edge[:, 1].astype(np.float32),
        "geom_dist": dirs.geom_dist,
        "velocity_flux": dirs.flux,
        "se": dirs.se, "ci_lo": dirs.ci_lo, "ci_hi": dirs.ci_hi,
        "p": dirs.p, "q": dirs.q,
        "n_cells": dirs.n_cells.astype(np.float32),
        "confidence": dirs.confidence,
        "in_mst": dirs.in_mst.astype(np.float32),
        "selected": sel, "directed_from": dfrom, "directed_to": dto,
        "tree": tree,
        "call": [_CALL_NAMES[int(c)] for c in dirs.call],
    }).to_parquet(path)
    log.info("Wrote %s", path)


def _write_trees(
    br: Branching, labels: np.ndarray, dirs: EdgeDirections, path: str
) -> None:
    import pandas as pd

    k = len(br.parent)
    n_comp = len(br.roots)
    n_nodes = np.bincount(br.tree, minlength=n_comp).astype(np.float32)
    n_cells = np.bincount(
        br.tree[labels[labels < k]], minlength=n_comp
    ).astype(np.float32)
    dmap = dirs.as_map()
    csum = np.zeros(n_comp)
    ccnt = np.zeros(n_comp)
    for v in range(k):
        p = br.parent[v]
        if p is None:
            continue
        i = dmap.get((min(p, v), max(p, v)))
        if i is not None:
            csum[br.tree[v]] += dirs.confidence[i]
            ccnt[br.tree[v]] += 1
    pd.DataFrame({
        "tree": [f"tree_{c}" for c in range(n_comp)],
        "root": np.asarray(br.roots, np.float32),
        "n_nodes": n_nodes, "n_cells": n_cells,
        "mean_confidence": np.where(ccnt > 0, csum / np.maximum(ccnt, 1),
                                    np.nan).astype(np.float32),
    }).to_parquet(path)
    log.info("Wrote %s (%d tree(s))", path, n_comp)


def _write_lineages(curves: PrincipalCurves, path: str) -> None:
    import pandas as pd

    rows = [
        (l, step, node)
        for l, c in enumerate(curves.curves)
        for step, node in enumerate(c.node_path)
    ]
    pd.DataFrame(
        np.asarray(rows, np.float32).reshape(-1, 3),
        columns=["lineage", "step", "node"],
    ).to_parquet(path)
    log.info("Wrote %s", path)


def _write_pseudotime(
    curves: PrincipalCurves, cell_tree, order_conf, cell_names, path
) -> None:
    """`pseudotime` and `branch` stay the first two columns for
    back-compat with `faba dyn-assoc` (`write.rs write_pseudotime`)."""
    import pandas as pd

    pd.DataFrame({
        "cell": list(cell_names),
        "pseudotime": curves.pseudotime,
        "branch": curves.branch.astype(np.float32),
        "tree": np.where(cell_tree < 0, np.nan,
                         cell_tree.astype(np.float32)),
        "order_confidence": order_conf,
    }).to_parquet(path)
    log.info("Wrote %s", path)


def _write_cell_matrix(mat, cell_names, col_prefix, path) -> None:
    import pandas as pd

    pd.DataFrame(
        mat, columns=[f"{col_prefix}_{l}" for l in range(mat.shape[1])],
    ).assign(cell=list(cell_names)).set_index("cell").reset_index(
    ).to_parquet(path)
    log.info("Wrote %s", path)


def _write_curves(curves: PrincipalCurves, path: str) -> None:
    import pandas as pd

    d = curves.curves[0].points.shape[1] if curves.curves else 0
    rows = []
    for l, c in enumerate(curves.curves):
        for g in range(len(c.points)):
            rows.append([l, g, c.lambda_grid[g], *c.points[g]])
    pd.DataFrame(
        np.asarray(rows, np.float32).reshape(-1, 3 + d),
        columns=["lineage", "grid", "lambda"] + [f"T{j}" for j in range(d)],
    ).to_parquet(path)
    log.info("Wrote %s", path)


def _write_trajectory_annotation(
    calls: NodeCalls, br: Branching, path: str
) -> None:
    """Node roles from the rooted forest: root | terminal | internal
    — terminals derived from children, not orientation, so abstained
    edges cannot misclassify a leaf (`write_trajectory_annotation`)."""
    import pandas as pd

    k = len(br.parent)
    has_child = np.zeros(k, bool)
    for p in br.parent:
        if p is not None:
            has_child[p] = True
    roles = [
        "root" if br.parent[v] is None
        else ("internal" if has_child[v] else "terminal")
        for v in range(k)
    ]
    pd.DataFrame({
        "node": [f"node_{i}" for i in range(k)],
        "role": roles,
        "cell_type": calls.labels,
        "confidence": calls.confidence,
    }).to_parquet(path)
    log.info("wrote %s (%d nodes; %d root(s))", path, k, len(br.roots))


def _write_xy(mat, rows, header, path) -> None:
    import pandas as pd

    pd.DataFrame({header: list(rows), "x": mat[:, 0], "y": mat[:, 1]}
                 ).to_parquet(path)
    log.info("Wrote %s", path)


def _write_curves_2d(coords, meta, path) -> None:
    import pandas as pd

    pd.DataFrame({
        "lineage": np.asarray([m[0] for m in meta], np.float32),
        "grid": np.asarray([m[1] for m in meta], np.float32),
        "x": coords[:, 0], "y": coords[:, 1],
    }).to_parquet(path)
    log.info("Wrote %s", path)


# ---------------------------------------------------------------- #
# Layout emission (lineage/layout.rs)                               #
# ---------------------------------------------------------------- #


def _stack_curve_points(curves: PrincipalCurves):
    pts, meta = [], []
    for l, c in enumerate(curves.curves):
        pts.append(c.points)
        meta += [(l, g) for g in range(len(c.points))]
    return (np.concatenate(pts, axis=0) if pts
            else np.zeros((0, 1), np.float32)), meta


def _emit_layout(
    kind, theta_t, theta_native, vel, geometry, layout_space,
    centroids, curves, cell_names, labels, dirs, br,
    velocity_aware, phate_knn, phate_t, phate_landmarks, layout_pcs,
    seed, out, n_called, device="cuda",
) -> None:
    curve_pts, meta = _stack_curve_points(curves)
    if kind == "phate":
        land, land_2d = phate_landmark_layout(
            theta_t, knn=phate_knn, t=(phate_t if phate_t > 0 else "auto"),
            n_landmarks=phate_landmarks, seed=seed, device=device,
        )
        exact = len(land) == len(theta_t)
        log.info("PHATE layout: %d cells (%s)", len(theta_t),
                 "exact" if exact else f"{len(land)} landmarks + Nystrom")
        cells_2d = (land_2d.copy() if exact else project_cells_nystrom(
            theta_t, land, land_2d, phate_knn))
        nodes_2d = project_cells_nystrom(centroids, land, land_2d, phate_knn)
        frac = n_called / max(len(dirs), 1)
        warp = {"on": True, "off": False, "auto": frac >= 0.5}[velocity_aware]
        if warp:
            log.info("PHATE: velocity-aware warp (%.0f%% of edges oriented)",
                     100 * frac)
            warp_layout_along_flow(nodes_2d, cells_2d, dirs, br, labels)
        curves_2d = project_cells_nystrom(
            curve_pts, land, land_2d, phate_knn)
    else:  # umap
        from ..ops.umap import umap

        if layout_space == "nascent" and vel is not None:
            feats = apply_geometry(theta_native + vel, geometry)
        elif layout_space == "concat" and vel is not None:
            feats = np.concatenate([theta_t, l2_normalize_rows(vel)], axis=1)
        else:
            feats = theta_t
        feats_n = feats if geometry == "euclidean" else l2_normalize_rows(feats)
        cells_2d = umap(
            feats_n, n_neighbors=phate_knn, seed=seed, kernel="tumap",
            pcs=layout_pcs, device=device,
        ).astype(np.float32)
        nodes_2d = project_onto_cells(centroids, theta_t, cells_2d, phate_knn)
        curves_2d = project_onto_cells(curve_pts, theta_t, cells_2d, phate_knn)

    _write_xy(cells_2d, cell_names, "cell", f"{out}.cells_2d.parquet")
    _write_xy(nodes_2d, [f"node_{i}" for i in range(len(nodes_2d))],
              "node", f"{out}.nodes_2d.parquet")
    _write_curves_2d(curves_2d, meta, f"{out}.curves_2d.parquet")
    # arrows LAST, off the final (possibly warped) coordinates
    if vel is not None:
        import pandas as pd

        grid = velocity_grid_arrows(cells_2d, theta_native, vel, phate_knn,
                                    device=device)
        log.info("velocity field: %d gridded arrow(s)", len(grid))
        pd.DataFrame(grid, columns=["x", "y", "dx", "dy"]).to_parquet(
            f"{out}.velocity_grid_2d.parquet"
        )
        log.info("Wrote %s.velocity_grid_2d.parquet", out)
