"""`pinto cage`: cell-activity-graph embedding (the port of the JAX
package's `pinto/cage.py`).

Cells embed by NCE over the spatial kNN graph with
edge weights gated by expression-program agreement (the "activity
gate": an edge contributes in proportion to the cosine similarity of
its endpoints' NB-Fisher-weighted expression profiles in the JL
sketch, K1). The embedding is `senna fne`'s fit (K4, full form, tied
weights).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..ops import random_projection as rp
from ..senna.fne import FneResult, fit_fne
from ..utils.prng import DEFAULT_PROJECTION_SEED

log = logging.getLogger(__name__)


@dataclass
class CageResult:
    embedding: np.ndarray  # [N, H]
    edges: np.ndarray
    edge_weights: np.ndarray
    losses: list


def fit_cage(
    data,
    coords: np.ndarray,
    *,
    embedding_dim: int = 16,
    knn: int = 8,
    proj_dim: int = 30,
    epochs: int = 500,
    gene_weights: np.ndarray | None = None,
    min_gate: float = 0.0,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
) -> CageResult:
    from .lc import spatial_knn_edges

    edges = spatial_knn_edges(coords, knn, device=device)
    _, proj_kn = rp.project_columns(
        data, proj_dim, row_weights=gene_weights, seed=seed, device=device
    )
    z = proj_kn.T  # [N, K] standardized sketch
    zn = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-9)

    # activity gate: cosine agreement of endpoint programs, floored at 0
    gate = np.maximum((zn[edges[:, 0]] * zn[edges[:, 1]]).sum(1), min_gate)
    keep = gate > 0
    edges_k, gate_k = edges[keep], gate[keep]
    log.info(
        "cage: %d spatial edges, %d pass the activity gate", len(edges), keep.sum()
    )

    res: FneResult = fit_fne(
        [(int(a), int(b), float(w)) for (a, b), w in zip(edges_k, gate_k)],
        embedding_dim=embedding_dim,
        epochs=epochs,
        seed=seed & 0x7FFFFFFF,
        device=device,
    )
    # fne interns node names in first-seen order; re-map to positions
    n = data.num_columns
    emb = np.zeros((n, embedding_dim), np.float32)
    for name, row in zip(res.names, res.embedding):
        emb[int(name)] = row
    return CageResult(
        embedding=emb, edges=edges_k, edge_weights=gate_k, losses=res.losses
    )
