"""Velocity-oriented lineage (the port of the JAX package's
`embedding/lineage.py`; `graph-embedding-util/lift.rs` + `faba lineage`
equivalents, `senna pseudotime --velocity`).

Given cell embeddings, per-cell velocity vectors in the SAME space
(gem's `cell_velocity`), and a principal tree over the embedding:
orient the tree so edges point WITH the velocity flow, pick the root
as the most upstream leaf, and emit directed pseudotime + per-cell
flow consistency (cosine of velocity with the local tree direction).
The tree is the port's `fit_principal_tree` (on the device); the rest is
host numpy and scipy, the reference's arithmetic in the reference's order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import shortest_path

from ..ops.principal_graph import fit_principal_tree, nearest_node


@dataclass
class Lineage:
    pseudotime: np.ndarray  # [N] directed by velocity
    root_node: int
    consistency: np.ndarray  # [N] cosine(velocity, local flow direction)
    nodes: np.ndarray
    edges: np.ndarray


def velocity_oriented_lineage(
    embedding: np.ndarray,  # [N, H]
    velocity: np.ndarray,  # [N, H]
    *,
    n_nodes: int = 30,
    lam: float = 1.0,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> Lineage:
    """`timings` (if given) receives the tree's `kmeans_s` and
    `iterations_s` and the seconds of the orientation (`orient_s`)."""
    embedding = np.asarray(embedding, np.float32)
    velocity = np.asarray(velocity, np.float32)
    if velocity.shape != embedding.shape:
        raise ValueError(
            f"velocity shape {velocity.shape} must match embedding shape "
            f"{embedding.shape} (same cells, same latent dims)"
        )
    nodes, adj = fit_principal_tree(embedding, n_nodes, lam=lam, seed=seed, device=device,
                                    timings=timings)
    t0 = time.perf_counter()
    cell_node = nearest_node(embedding, nodes, device)

    # per-edge net flow: mean projection of member-cell velocities onto
    # the edge direction (lift.rs velocity lift)
    edges = np.transpose(np.nonzero(np.triu(adj)))
    flow = np.zeros(len(edges))
    for ei, (a, b) in enumerate(edges):
        direction = nodes[b] - nodes[a]
        nrm = np.linalg.norm(direction)
        if nrm < 1e-9:
            continue
        direction = direction / nrm
        members = np.isin(cell_node, [a, b])
        if members.any():
            flow[ei] = float((velocity[members] @ direction).mean())

    # root: leaf maximizing downstream-pointing flow = the node whose
    # tree-paths agree best with velocity. Score each leaf by total
    # signed flow along edges oriented AWAY from it.
    w = np.sqrt(((nodes[:, None] - nodes[None]) ** 2).sum(-1)) * adj
    dist_nodes = shortest_path(sp.csr_matrix(w))
    leaves = np.nonzero(adj.sum(1) <= 1)[0]
    if len(leaves) == 0:
        leaves = np.asarray([0])

    def root_score(r):
        s = 0.0
        for ei, (a, b) in enumerate(edges):
            # oriented away from r: from the closer node to the farther
            sign = 1.0 if dist_nodes[r, a] <= dist_nodes[r, b] else -1.0
            s += sign * flow[ei]
        return s

    root = int(leaves[np.argmax([root_score(r) for r in leaves])])
    pt_nodes = dist_nodes[root]
    pt = pt_nodes[cell_node]
    finite = np.isfinite(pt)
    pt[~finite] = np.nanmax(np.where(finite, pt, np.nan)) if finite.any() else 0.0
    pt = pt / max(pt.max(), 1e-12)

    # per-cell consistency: cosine of velocity with the local direction
    # of increasing pseudotime (gradient along the nearest edge); each
    # node's direction and its norm are formed once
    step = []
    for a in range(len(nodes)):
        nbrs = np.nonzero(adj[a])[0]
        if len(nbrs) == 0:
            step.append(None)
            continue
        direction = nodes[nbrs[np.argmax(pt_nodes[nbrs])]] - nodes[a]
        step.append((direction, np.linalg.norm(direction)))
    consistency = np.zeros(len(embedding))
    for i in range(len(embedding)):
        if step[cell_node[i]] is None:
            continue
        direction, nd = step[cell_node[i]]
        nv = nd * np.linalg.norm(velocity[i])
        if nv > 1e-9:
            consistency[i] = float(velocity[i] @ direction / nv)
    if timings is not None:
        timings["orient_s"] = time.perf_counter() - t0

    return Lineage(
        pseudotime=pt.astype(np.float32),
        root_node=root,
        consistency=consistency.astype(np.float32),
        nodes=nodes,
        edges=edges,
    )
