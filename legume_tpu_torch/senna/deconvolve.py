"""Leiden at a target community count (the port of the JAX package's
`senna/deconvolve.py::leiden_at_count`; `senna bge --num-topics` uses it
to seed the ETM layout). The rest of `senna deconvolve` is not ported
yet."""

from __future__ import annotations

import numpy as np

from ..ops.leiden import knn_adjacency, leiden_clustering


def leiden_at_count(
    embedding: np.ndarray, target: int, *, knn: int = 30, seed: int = 0,
    max_bisect: int = 8, device="cuda",
) -> np.ndarray:
    """Leiden membership with ~`target` communities: binary search on
    the resolution from 1.0 (archetypes.rs LEIDEN_RESOLUTION binary
    search)."""
    adj = knn_adjacency(embedding, k=min(knn, len(embedding) - 1), device=device)
    lo, hi = 0.01, 100.0
    res = 1.0
    best = None
    for _ in range(max_bisect):
        memb = leiden_clustering(adj, resolution=res, seed=seed).membership
        k = int(memb.max()) + 1
        if best is None or abs(k - target) < abs(int(best.max()) + 1 - target):
            best = memb
        if k == target:
            break
        if k < target:
            lo = res
        else:
            hi = res
        res = float(np.sqrt(lo * hi))
    return best
