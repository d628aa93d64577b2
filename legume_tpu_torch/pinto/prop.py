"""`pinto prop` (re-cluster edge latents) and `pinto dsvd` (cell-pair
shared / difference SVD): the port of the JAX package's `pinto/prop.py`.

- `edge_prop_clustering`: the spatial edges' expression profiles through
  the projection basis (the basis and the per-cell sketch from
  `project_columns`, K1), clustered by k-means or Leiden, and per-cell
  propensities.
- `pair_dsvd`: rSVD of the concatenated [shared | difference] profile
  ((x_i + x_j) / 2 | |x_i - x_j|) of the spatial cell pairs.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.kmeans import kmeans
from ..ops.leiden import knn_adjacency, leiden_clustering
from ..ops.rsvd import rsvd
from ..utils.prng import DEFAULT_PROJECTION_SEED, key_from_seed
from .lc import compute_node_membership, edge_profiles, spatial_knn_edges

log = logging.getLogger(__name__)


def edge_prop_clustering(
    data,
    coords: np.ndarray,
    *,
    method: str = "kmeans",
    n_clusters: int = 10,
    proj_dim: int = 30,
    knn: int = 8,
    resolution: float = 1.0,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
):
    """Returns (edge_labels, edges, propensity [N, K])."""
    from ..ops.random_projection import project_columns

    edges = spatial_knn_edges(coords, knn, device=device)
    profiles = edge_profiles(data, edges)  # [E, D]
    basis, _ = project_columns(data, proj_dim, seed=seed, device=device)
    z = np.log1p(np.asarray(profiles.todense())) @ np.asarray(basis)  # [E, K]
    z = (z - z.mean(0)) / np.maximum(z.std(0), 1e-8)

    if method == "kmeans":
        _, labels = kmeans(z.astype(np.float32), n_clusters, seed=seed & 0x7FFFFFFF,
                           device=device)
        k = n_clusters
    else:
        adj = knn_adjacency(z.astype(np.float32), k=15, device=device)
        res = leiden_clustering(adj, resolution=resolution, seed=seed & 0x7FFFFFFF)
        labels = res.membership
        k = res.n_communities
    prop = compute_node_membership(edges, np.asarray(labels), data.num_columns, k)
    return labels, edges, prop.astype(np.float32)


def pair_dsvd(
    data,
    coords: np.ndarray,
    *,
    rank: int = 16,
    knn: int = 8,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
):
    """Shared / difference SVD over spatial pairs: returns
    (pair_factors [E, rank], shared_basis, diff_basis, edges)."""
    edges = spatial_knn_edges(coords, knn, device=device)
    x = data.read_columns_csc(np.arange(data.num_columns)).T.tocsr()  # [N, D]
    xi = np.log1p(np.asarray(x[edges[:, 0]].todense()))
    xj = np.log1p(np.asarray(x[edges[:, 1]].todense()))
    shared = (xi + xj) / 2.0
    diff = np.abs(xi - xj)
    both = np.concatenate([shared, diff], axis=1)  # [E, 2D]
    both = both - both.mean(0, keepdims=True)
    x_dev = torch.from_numpy(both.astype(np.float32)).to(device)
    u, s, vt = rsvd(x_dev, rank, key=key_from_seed(seed, 31))
    d = x.shape[1]
    return u * np.asarray(s), vt[:, :d], vt[:, d:], edges
