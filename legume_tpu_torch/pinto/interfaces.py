"""High-entropy "interface" cell report (the port of the JAX package's
`pinto/interfaces.py`; host only).

Interface cells sit between spatial communities: their propensity rows
are spread over several communities, so their entropy is high. The
report picks focal cells in the top entropy quantile, walks their 1-
and 2-hop spatial neighborhoods, and summarizes which communities each
focal cell touches. `pick_uncommitted_cells` is the simpler threshold
variant (drop cells whose top propensity exceeds `commit_threshold`;
interfaces.rs:108-121).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def propensity_entropy(prop: np.ndarray) -> np.ndarray:
    """Per-cell Shannon entropy of the normalized propensity rows."""
    p = np.maximum(np.asarray(prop, np.float64), 0.0)
    p = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-30)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.where(p > 0, p * np.log(p), 0.0).sum(axis=1)
    return h.astype(np.float32)


def pick_focal_cells(
    entropy: np.ndarray, quantile: float = 0.9, max_cells: int = 200
) -> np.ndarray:
    """Top-(1-quantile) entropy cells, capped at max_cells (highest first)."""
    thr = np.quantile(entropy, quantile)
    idx = np.flatnonzero(entropy >= thr)
    order = idx[np.argsort(-entropy[idx], kind="stable")]
    return order[:max_cells]


def pick_uncommitted_cells(
    prop: np.ndarray, commit_threshold: float = 0.8
) -> np.ndarray:
    """Cells whose top normalized propensity stays under the threshold."""
    p = np.maximum(np.asarray(prop, np.float64), 0.0)
    p = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-30)
    return np.flatnonzero(p.max(axis=1) < np.clip(commit_threshold, 0.0, 1.0))


def _adjacency(
    n: int, edges: Optional[np.ndarray], coords: Optional[np.ndarray], knn: int
) -> list:
    adj = [[] for _ in range(n)]
    if edges is not None and len(edges):
        for s, d in np.asarray(edges, np.int64):
            if s != d:
                adj[s].append(int(d))
                adj[d].append(int(s))
        return [sorted(set(a)) for a in adj]
    from scipy.spatial import cKDTree

    tree = cKDTree(coords)
    _, nn = tree.query(coords, k=min(knn + 1, n))
    for i in range(n):
        adj[i] = [int(j) for j in nn[i, 1:] if j != i]
    return adj


@dataclass
class InterfaceReport:
    focal: np.ndarray  # [F] focal cell indices
    entropy: np.ndarray  # [N]
    dominant: np.ndarray  # [N] argmax community per cell
    rows: list = field(default_factory=list)  # per-focal summary dicts


def interface_report(
    prop: np.ndarray,
    coords: Optional[np.ndarray] = None,
    edges: Optional[np.ndarray] = None,
    *,
    community_names: Optional[list] = None,
    entropy_quantile: float = 0.9,
    max_cells: int = 200,
    hops: int = 2,
    knn: int = 8,
) -> InterfaceReport:
    """Focal interface cells + neighborhood community composition.

    Each row records the focal cell, its entropy, dominant community,
    1-/2-hop neighbor counts, and the distinct neighbor communities in
    descending frequency (interfaces.rs:66-95 neighborhood walk +
    write_interface_tsv).
    """
    prop = np.asarray(prop)
    n, k = prop.shape
    names = community_names or [f"c{j}" for j in range(k)]
    ent = propensity_entropy(prop)
    dom = prop.argmax(axis=1)
    focal = pick_focal_cells(ent, entropy_quantile, max_cells)
    adj = _adjacency(n, edges, coords, knn)

    rows = []
    for fi in focal:
        one = set(adj[fi])
        two = set()
        if hops >= 2:
            for j in one:
                two.update(adj[j])
            two -= one | {int(fi)}
        hood = sorted(one | two)
        comms, counts = np.unique(dom[hood], return_counts=True) if hood else ([], [])
        order = np.argsort(-np.asarray(counts), kind="stable")
        rows.append({
            "cell": int(fi),
            "entropy": float(ent[fi]),
            "dominant": names[dom[fi]],
            "n_one_hop": len(one),
            "n_two_hop": len(two),
            "neighbor_communities": ",".join(
                f"{names[comms[o]]}:{counts[o]}" for o in order
            ),
        })
    return InterfaceReport(focal=focal, entropy=ent, dominant=dom, rows=rows)
