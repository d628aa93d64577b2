"""Leiden community detection (`leiden` crate equivalent — itself a port
of the CWTS Java implementation; `leiden/src/lib.rs`). The port's copy
of the JAX package's `ops/leiden.py`, line for line, so that equal
adjacencies give equal memberships; only `knn_adjacency` takes the
torch `device` of its kNN search.

Host-side numpy implementation of the Leiden algorithm (Traag et al.
2019): queue-based fast local moving -> **refinement within
communities** (randomized merge of well-connected singletons, the step
that distinguishes Leiden from Louvain and guarantees well-connected —
hence internally connected — communities) -> aggregation on the
*refined* partition with the local-move partition as the aggregate
graph's initial assignment, iterated until stable. Supports the CPM and
modularity quality functions the reference exposes; `refine=False`
recovers plain Louvain. Deterministic under `seed`.

Both objectives share one move rule: modularity is CPM on effective
node weights (degrees) with resolution `gamma / (2m)` — the standard
equivalence used by the CWTS implementation, exact for move decisions.

The device side builds the kNN graph (`ops.knn` + `knn_graph`); the
irregular greedy sweeps stay on host — the same split the survey
prescribes for irregular graph work (SURVEY.md section 2.6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class LeidenResult:
    membership: np.ndarray  # [N] community ids, dense
    quality: float
    n_communities: int


def _quality(adj, membership, resolution, total_w, objective):
    """CPM or modularity quality of a partition."""
    comm = membership
    # sum of edge weights inside communities
    rows, cols = adj.nonzero()
    internal = adj.data[comm[rows] == comm[cols]].sum() / 2.0
    sizes = np.bincount(comm)
    if objective == "cpm":
        return internal - resolution * (sizes * (sizes - 1) / 2.0).sum()
    deg = np.asarray(adj.sum(axis=1)).ravel()
    comm_deg = np.bincount(comm, weights=deg)
    m = total_w
    return internal / m - resolution * ((comm_deg / (2.0 * m)) ** 2).sum()


def _effective(adj, node_w, resolution, objective, total_w):
    """Map (objective, node_w, resolution) to the CPM-equivalent move
    weights: modularity == CPM over degree weights at gamma/(2m)."""
    if objective == "cpm":
        return node_w.astype(np.float64), float(resolution)
    deg = np.asarray(adj.sum(axis=1)).ravel().astype(np.float64)
    return deg, float(resolution) / max(2.0 * total_w, 1e-30)


def _local_move(adj: sp.csr_matrix, membership, eff_w, eff_res, rng):
    """Queue-based fast local moving under the CPM-equivalent rule;
    mutates `membership` in place, returns True if anything moved."""
    n = adj.shape[0]
    comm_w = np.bincount(membership, weights=eff_w, minlength=n).astype(np.float64)

    order = rng.permutation(n)
    in_queue = np.ones(n, bool)
    queue = list(order)
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    moved_any = False

    while queue:
        v = queue.pop(0)
        in_queue[v] = False
        c_old = membership[v]
        # edge weight from v to each neighboring community (self loops
        # cancel in the move gain — they stay internal wherever v goes)
        nbr = indices[indptr[v] : indptr[v + 1]]
        wts = data[indptr[v] : indptr[v + 1]]
        self_mask = nbr != v
        nbr, wts = nbr[self_mask], wts[self_mask]
        if len(nbr) == 0:
            continue
        cand = membership[nbr]
        uniq, inv = np.unique(cand, return_inverse=True)
        w_to = np.bincount(inv, weights=wts)

        comm_w[c_old] -= eff_w[v]
        w_to_old = w_to[uniq == c_old].sum()

        gains = w_to - eff_res * eff_w[v] * comm_w[uniq]
        gain_old = w_to_old - eff_res * eff_w[v] * comm_w[c_old]

        best = int(np.argmax(gains))
        if gains[best] > gain_old + 1e-12 and uniq[best] != c_old:
            c_new = int(uniq[best])
            membership[v] = c_new
            comm_w[c_new] += eff_w[v]
            moved_any = True
            # re-enqueue neighbors not in c_new
            for u in nbr[membership[nbr] != c_new]:
                if not in_queue[u]:
                    in_queue[u] = True
                    queue.append(u)
        else:
            comm_w[c_old] += eff_w[v]
    return moved_any


def _refine(adj: sp.csr_matrix, membership, eff_w, eff_res, rng, theta):
    """Leiden refinement: start from singletons; a node may merge only
    with a refined cluster inside its own local-move community, only if
    both the node and the target cluster are well-connected within that
    community (E(v, S-v) >= gamma * w_v * (w_S - w_v), Traag 2019 eq. 4),
    and only while it is still a singleton. Merge target drawn with
    probability ~ exp(gain / theta) over positive-gain candidates
    (theta <= 0 -> greedy argmax).

    Returns (refined, agg_init): `refined` maps level nodes to compacted
    refined-cluster ids; `agg_init[c]` is the local-move community the
    refined cluster c lies in (the aggregate graph's initial partition).
    """
    n = adj.shape[0]
    refined = np.arange(n)
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    comm_tot = np.bincount(membership, weights=eff_w, minlength=n).astype(np.float64)

    # E(cluster, S \ cluster) for singleton clusters: weight to the rest
    # of the node's own community (self loops excluded)
    ext = np.zeros(n)
    for v in range(n):
        nbr = indices[indptr[v] : indptr[v + 1]]
        wts = data[indptr[v] : indptr[v + 1]]
        m = (membership[nbr] == membership[v]) & (nbr != v)
        ext[v] = wts[m].sum()

    ref_w = eff_w.astype(np.float64).copy()
    cluster_size = np.ones(n, np.int64)

    for v in rng.permutation(n):
        if cluster_size[refined[v]] > 1:
            continue  # only singletons are candidates to move
        s = membership[v]
        if ext[v] < eff_res * eff_w[v] * (comm_tot[s] - eff_w[v]) - 1e-12:
            continue  # v itself is not well-connected within S
        nbr = indices[indptr[v] : indptr[v + 1]]
        wts = data[indptr[v] : indptr[v + 1]]
        m = (membership[nbr] == s) & (nbr != v)
        nbr, wts = nbr[m], wts[m]
        if nbr.size == 0:
            continue
        cand = refined[nbr]
        uniq, inv = np.unique(cand, return_inverse=True)
        w_to = np.bincount(inv, weights=wts)
        ok = uniq != refined[v]
        # target cluster well-connectedness within S
        ok &= ext[uniq] >= eff_res * ref_w[uniq] * (comm_tot[s] - ref_w[uniq]) - 1e-12
        gains = w_to - eff_res * eff_w[v] * ref_w[uniq]
        ok &= gains > 1e-12
        if not ok.any():
            continue
        g, u, wt = gains[ok], uniq[ok], w_to[ok]
        if theta > 0 and len(u) > 1:
            p = np.exp((g - g.max()) / theta)
            pick = int(rng.choice(len(u), p=p / p.sum()))
        else:
            pick = int(np.argmax(g))
        c_old, c_new = refined[v], int(u[pick])
        refined[v] = c_new
        cluster_size[c_new] += 1
        cluster_size[c_old] -= 1
        ref_w[c_new] += eff_w[v]
        ref_w[c_old] -= eff_w[v]
        # E(c_new + {v}, S - ...) = ext[c_new] + ext[v] - 2 w(v, c_new)
        ext[c_new] = ext[c_new] + ext[v] - 2.0 * wt[pick]

    uniq, dense = np.unique(refined, return_inverse=True)
    agg_init = membership[uniq]  # representative node's community
    return dense.astype(np.int64), agg_init.astype(np.int64)


def _compact(membership):
    _, dense = np.unique(membership, return_inverse=True)
    return dense.astype(np.int64)


def _aggregate(adj: sp.csr_matrix, membership, node_w):
    k = membership.max() + 1
    n = adj.shape[0]
    proj = sp.csr_matrix(
        (np.ones(n), (np.arange(n), membership)), shape=(n, k)
    )
    agg = (proj.T @ adj @ proj).tocsr()
    agg_w = np.bincount(membership, weights=node_w, minlength=k)
    return agg, agg_w


def leiden_clustering(
    adjacency: sp.spmatrix,
    *,
    resolution: float = 1.0,
    objective: str = "modularity",
    max_iter: int = 10,
    seed: int = 0,
    refine: bool = True,
    theta: float = 0.01,
) -> LeidenResult:
    """Cluster a symmetric weighted adjacency (no self loops needed).

    `refine=True` (default) runs the full Leiden algorithm — refinement
    guarantees every returned community is internally connected.
    `refine=False` skips refinement (plain Louvain)."""
    adj = sp.csr_matrix(adjacency, dtype=np.float64)
    adj = (adj + adj.T) / 2.0  # symmetrize
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    total_w = adj.sum() / 2.0
    if total_w <= 0:
        return LeidenResult(np.zeros(n, np.int64), 0.0, 1)

    cur_adj = adj
    cur_w = np.ones(n)
    node_to_agg = np.arange(n)  # original node -> current level node
    init = np.arange(n)
    final_memb = init
    for it in range(max_iter):
        eff_w, eff_res = _effective(cur_adj, cur_w, resolution, objective, total_w)
        memb = init.copy()
        moved = _local_move(cur_adj, memb, eff_w, eff_res, rng)
        memb = _compact(memb)
        final_memb = memb[node_to_agg]
        k = int(memb.max()) + 1
        if k == cur_adj.shape[0] or not moved:
            break
        if refine:
            refined, agg_init = _refine(cur_adj, memb, eff_w, eff_res, rng, theta)
        else:
            refined = memb
            agg_init = np.arange(k)
        node_to_agg = refined[node_to_agg]
        cur_adj, cur_w = _aggregate(cur_adj, refined, cur_w)
        init = agg_init

    membership = _compact(final_memb)
    q = _quality(adj, membership, resolution, total_w, objective)
    return LeidenResult(
        membership=membership, quality=float(q), n_communities=int(membership.max() + 1)
    )


def knn_adjacency(
    coords: np.ndarray, k: int = 15, *, mode: str = "fuzzy", chunk: int = 4096,
    device="cuda",
) -> sp.csr_matrix:
    """Symmetric kNN graph over latent coordinates with exponential /
    fuzzy kernels (`matrix-util/src/knn_graph.rs` equivalent; kNN on
    device)."""
    from .knn import knn_within

    n = coords.shape[0]
    d, i = knn_within(coords, min(k, n - 1), chunk=chunk, device=device)
    rows = np.repeat(np.arange(n), d.shape[1])
    cols = i.ravel()
    if mode == "binary":
        vals = np.ones(len(rows))
    else:
        # exp kernel scaled by per-point median distance
        sigma = np.maximum(np.median(d, axis=1, keepdims=True), 1e-12)
        vals = np.exp(-d / sigma).ravel()
    adj = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return ((adj + adj.T) / 2.0).tocsr()
