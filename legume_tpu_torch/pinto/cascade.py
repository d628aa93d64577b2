"""pinto lc cascade: multilevel V-cycle link-community refinement (the
port of the JAX package's `pinto/cascade.py`).

Level 0 fits a coarse link-community partition over all spatial edges;
each coarse community's edge subset is then re-clustered at the next
level's resolution, producing hierarchical labels `c0/c3/...` plus a
per-cell propensity at every level. Coarse sweeps see all edges (fast
mixing); fine sweeps only ever touch one community's edges (small,
parallelizable subproblems) — the V-cycle shape of the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..utils.prng import DEFAULT_PROJECTION_SEED
from .lc import _fit_edge_labels, compute_node_membership, edge_profiles, spatial_knn_edges

log = logging.getLogger(__name__)


@dataclass
class CascadeResult:
    edge_labels: list  # [E] hierarchical labels "c2/c0"
    levels: list  # per-level flat label arrays [E]
    propensity: np.ndarray  # [N, K_leaf] leaf-community propensity
    leaf_names: list
    edges: np.ndarray
    traces: dict = field(default_factory=dict)


def cascade_link_community(
    data,
    coords: np.ndarray,
    *,
    levels: tuple = (6, 4),
    knn: int = 10,
    n_sweeps: int = 30,
    min_edges: int = 50,
    gene_weights: np.ndarray | None = None,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
) -> CascadeResult:
    n = data.num_columns
    d = data.num_rows
    edges = spatial_knn_edges(coords, knn, device=device)
    profiles = edge_profiles(data, edges, gene_weights=gene_weights)
    e = profiles.shape[0]
    log.info("cascade: %d edges, levels %s", e, levels)

    lab0, trace0 = _fit_edge_labels(
        profiles, levels[0], n_genes=d, n_sweeps=n_sweeps, seed=seed, device=device
    )
    level_labels = [lab0]
    traces = {"level0": trace0}
    names = [f"c{c}" for c in lab0]

    current = lab0.astype(object)
    for li, k_fine in enumerate(levels[1:], start=1):
        fine = np.full(e, -1, np.int64)
        for c in np.unique(lab0) if li == 1 else np.unique(level_labels[-1]):
            members = np.nonzero(level_labels[-1] == c)[0]
            if len(members) < max(min_edges, 2 * k_fine):
                fine[members] = 0  # too small to split
                continue
            sub = profiles[members]
            sub_lab, tr = _fit_edge_labels(
                sub.tocsr(), k_fine, n_genes=d,
                n_sweeps=max(n_sweeps // 2, 10),
                seed=seed + 1000 * li + int(c), device=device,
            )
            fine[members] = sub_lab
            traces[f"level{li}/c{c}"] = tr
        names = [f"{nm}/c{f}" for nm, f in zip(names, fine)]
        level_labels.append(fine)

    # leaf propensity over the hierarchical labels
    uniq = sorted(set(names))
    lut = {nm: i for i, nm in enumerate(uniq)}
    leaf = np.asarray([lut[nm] for nm in names])
    prop = compute_node_membership(edges, leaf, n, len(uniq))

    return CascadeResult(
        edge_labels=names,
        levels=level_labels,
        propensity=prop.astype(np.float32),
        leaf_names=uniq,
        edges=edges,
        traces=traces,
    )


def annotate_communities(
    data,
    result,
    marker_sets: dict,
    *,
    edge_labels: np.ndarray | None = None,
) -> dict:
    """`pinto annotate`: label communities by marker enrichment of the
    mean expression of their member CELLS (both endpoints of member
    edges)."""
    from ..ops.enrichment import annotate_by_markers

    labels = (
        np.asarray(edge_labels)
        if edge_labels is not None
        else np.asarray(
            [result.leaf_names.index(nm) for nm in result.edge_labels]
        )
    )
    edges = result.edges
    uniq = np.unique(labels)
    profiles = np.zeros((len(uniq), data.num_rows))
    for i, c in enumerate(uniq):
        cells = np.unique(edges[labels == c].ravel())
        profiles[i] = np.log1p(
            np.asarray(data.read_columns_csc(cells).mean(axis=1)).ravel()
        )
    names, scores = annotate_by_markers(profiles, data.row_names(), marker_sets)
    key = (
        [result.leaf_names[c] for c in uniq]
        if edge_labels is None
        else [str(c) for c in uniq]
    )
    return {"community": key, "annotation": names, "scores": scores}
