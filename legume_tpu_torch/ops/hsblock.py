"""Hierarchical stochastic block model clustering (the port of the JAX
package's `ops/hsblock.py`): a fixed binary tree of K = 2^(depth-1)
leaves, Gamma-Poisson collapsed Gibbs with degree correction.

Each leaf-cluster pair (ci, cj) has a Poisson rate with a Gamma(a0, b0)
prior from the pair's lowest common ancestor; the collapsed marginal of
one pair is

    S(a0, b0, edge, total) = a0 ln b0 + lgamma(a0 + edge) - lgamma(a0)
                             - (a0 + edge) ln(b0 + total)

with edge the block's edge mass and total = vol_ci * vol_cj (degree
corrected; halved on the diagonal).

The sweep is a blocked Jacobi sweep on the device: with the block
statistics frozen, the move delta of every (vertex, target) pair follows
from e_vc (vertex -> cluster edge mass, one segment sum) as dense
[N, K, K] lgamma algebra; labels then take a Gumbel draw (Gibbs) or the
argmax (greedy) in parallel. A bottom-up sibling-merge pass on the host
then merges the children of a tree node where the collapsed tree score
improves. The draws are the JAX package's (`utils/prng.py`); labels equal
the reference's where no two deltas tie to float rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import prng
from ..utils.precision import full_f32_matmul
from ..utils.prng import DEFAULT_PROJECTION_SEED


def lca_nodes(k: int) -> np.ndarray:
    """[K, K] heap index of the LCA tree node of each leaf pair (leaf c
    has heap index K + c)."""
    out = np.zeros((k, k), np.int64)
    for i in range(k):
        for j in range(k):
            a, b = k + i, k + j
            while a != b:
                if a > b:
                    a >>= 1
                else:
                    b >>= 1
            out[i, j] = a
    return out


def _score(a0, b0, edge, total):
    return (a0 * torch.log(b0) + torch.lgamma(a0 + edge) - torch.lgamma(a0)
            - (a0 + edge) * torch.log(b0 + total))


@torch.no_grad()
def sweep_delta(src, dst, w, deg, labels, a0_kk, b0_kk, *, k: int, dc: bool):
    """[N, K] change of the collapsed score when each vertex moves to each
    target cluster (0 for its own), and the [K, K] edge and total planes
    of the current labels."""
    n = labels.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=labels.device)

    def totals(vol_i, vol_j, size_i, size_j, diag_mask):
        t = vol_i * vol_j if dc else size_i * size_j
        return torch.where(diag_mask, t / 2.0, t)

    with full_f32_matmul():
        onehot = torch.nn.functional.one_hot(labels, k).to(w.dtype)  # [N, K]
        # e[v, c] = edge mass from v into cluster c
        e = torch.zeros(n * k, dtype=w.dtype, device=labels.device)
        e = e.index_add_(0, src * k + labels[dst], w).view(n, k)
        vol = deg @ onehot  # [K]
        size = onehot.sum(0)
        edge = onehot.T @ e  # within-block mass counted twice
        edge = edge - torch.diag(torch.diag(edge) / 2.0)
    tot_old = totals(vol[:, None], vol[None, :], size[:, None], size[None, :], eye)
    s_old = _score(a0_kk, b0_kk, edge, tot_old)

    oh_s = onehot
    # t-rows: pairs (t, c) for every candidate t; v's edges to t leave the
    # (s, t) pair, and the c side loses v at c == s and gains it at c == t
    new_t = edge[None] + e[:, None, :] - e[:, :, None] * oh_s[:, None, :]  # [N, K_t, K_c]
    vol_t_new = vol[None, :] + deg[:, None]
    size_t_new = size[None, :] + 1.0
    vol_c3 = vol[None, None, :] - deg[:, None, None] * oh_s[:, None, :] + deg[:, None, None] * eye[None]
    size_c3 = size[None, None, :] - oh_s[:, None, :] + eye[None].to(w.dtype)
    tot_t = totals(vol_t_new[:, :, None], vol_c3, size_t_new[:, :, None], size_c3, eye[None])
    d_t = (_score(a0_kk[None], b0_kk[None], new_t, tot_t) - s_old[None]).sum(2)  # [N, K_t]

    # s-rows: pairs (s, c), independent of t; the naive c == t term is
    # taken out below (the (s, t) pair lives in the t-row's c == s column)
    edge_s = edge[labels]  # [N, K_c]
    new_s = edge_s - e
    vol_s_new = vol[labels] - deg
    size_s_new = size[labels] - 1.0
    diag_s = oh_s.bool()
    tot_s = totals(vol_s_new[:, None], vol[None, :].expand(n, k), size_s_new[:, None],
                   size[None, :].expand(n, k), diag_s)
    own = vol_s_new if dc else size_s_new
    tot_s = torch.where(diag_s, (own[:, None] ** 2) / 2.0, tot_s)
    a_s, b_s = a0_kk[labels], b0_kk[labels]
    ds_terms = _score(a_s, b_s, new_s, tot_s) - _score(a_s, b_s, edge_s, tot_old[labels])
    delta = d_t + ds_terms.sum(1)[:, None] - ds_terms
    return torch.where(diag_s, 0.0, delta), edge, tot_old


def _tree_score(edge, tot, a0_kk, b0_kk, lca_kk, n_nodes):
    """Pair statistics aggregated to tree nodes, scored."""
    from scipy.special import gammaln

    k = edge.shape[0]
    iu = np.triu_indices(k)
    node_edge = np.zeros(n_nodes + 1)
    node_tot = np.zeros(n_nodes + 1)
    np.add.at(node_edge, lca_kk[iu], edge[iu])
    np.add.at(node_tot, lca_kk[iu], tot[iu])
    a0 = np.zeros(n_nodes + 1)
    b0 = np.zeros(n_nodes + 1)
    a0[lca_kk[iu]] = a0_kk[iu]
    b0[lca_kk[iu]] = b0_kk[iu]
    live = a0 > 0
    return float(np.sum(
        a0[live] * np.log(b0[live]) + gammaln(a0[live] + node_edge[live]) - gammaln(a0[live])
        - (a0[live] + node_edge[live]) * np.log(b0[live] + node_tot[live])
    ))


@dataclass
class HsblockResult:
    membership: np.ndarray  # [N] dense community labels
    tree_paths: list  # per community, the bit-path from the root
    loglik: float


def hsblock_clustering(
    adjacency: sp.spmatrix,
    *,
    max_depth: int = 4,
    num_gibbs: int = 20,
    num_greedy: int = 10,
    degree_corrected: bool = True,
    a0: float = 1.0,
    b0: float = 1.0,
    edge_scale: float = 1.0,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
) -> HsblockResult:
    """Collapsed Gibbs HSBM over K = 2^(max_depth-1) tree leaves (sweeps
    on `device`), then the bottom-up sibling-merge pass on the host."""
    adj = sp.csr_matrix(adjacency, dtype=np.float64)
    adj = (adj + adj.T) / 2.0
    n = adj.shape[0]
    k = 1 << (max_depth - 1)
    lca_kk = lca_nodes(k)
    a0_kk = np.full((k, k), a0)
    b0_kk = np.full((k, k), b0)

    coo = sp.coo_matrix(sp.triu(adj, 1))
    # both directions, so e_vc covers every vertex's incident mass
    src = np.concatenate([coo.row, coo.col]).astype(np.int64)
    dst = np.concatenate([coo.col, coo.row]).astype(np.int64)
    w = np.concatenate([coo.data, coo.data]).astype(np.float32) * edge_scale
    deg = np.asarray(adj.sum(1)).ravel().astype(np.float32) * edge_scale

    key = prng.key(seed & 0x7FFFFFFF)
    key, k_init = prng.split(key)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    labels = to(prng.randint(k_init, (n,), 0, k).astype(np.int64))
    # the sweep's algebra runs in float64: each delta is a difference of
    # pair scores in the thousands, which float32 resolves to ~1e-3 only
    src_t, dst_t = to(src), to(dst)
    w_t, deg_t = to(w.astype(np.float64)), to(deg.astype(np.float64))
    a_t, b_t = to(a0_kk), to(b0_kk)

    prev = None
    for sweep in range(num_gibbs + num_greedy):
        key, ks = prng.split(key)
        delta, _, _ = sweep_delta(src_t, dst_t, w_t, deg_t, labels, a_t, b_t,
                                  k=k, dc=degree_corrected)
        if sweep < num_gibbs:
            labels = torch.argmax(delta + to(prng.gumbel(ks, (n, k)).astype(np.float64)), dim=1)
        else:
            labels = torch.argmax(delta, dim=1)
            lab_np = labels.cpu().numpy()
            if prev is not None and np.array_equal(prev, lab_np):
                break
            prev = lab_np
    lab = labels.cpu().numpy().astype(np.int64)

    # ---- bottom-up sibling merges (Occam pass) ------------------------
    def stats_of(lab_arr, leaf_of):
        onehot = np.zeros((n, k))
        onehot[np.arange(n), leaf_of[lab_arr]] = 1.0
        edge = onehot.T @ (adj @ onehot)
        edge -= np.diag(np.diag(edge) / 2.0)
        vol = deg.astype(np.float64) @ onehot
        size = onehot.sum(0)
        tot = np.outer(vol, vol) if degree_corrected else np.outer(size, size)
        np.fill_diagonal(tot, np.diag(tot) / 2.0)
        return edge, tot

    n_nodes = 2 * k - 1
    leaf_of = np.arange(k)
    for level in range(max_depth - 1):
        stride = 1 << (level + 1)
        for left in range(0, k, stride):
            right = left + (stride >> 1)
            la, lb = leaf_of[left], leaf_of[right]
            if la == lb:
                continue
            s_split = _tree_score(*stats_of(lab, leaf_of), a0_kk, b0_kk, lca_kk, n_nodes)
            merged = leaf_of.copy()
            merged[merged == lb] = la
            s_merge = _tree_score(*stats_of(lab, merged), a0_kk, b0_kk, lca_kk, n_nodes)
            if s_merge >= s_split:
                leaf_of = merged
    lab = leaf_of[lab]

    uniq, dense = np.unique(lab, return_inverse=True)
    paths = [format(int(u), f"0{max(max_depth - 1, 1)}b") for u in uniq]
    edge_f, tot_f = stats_of(dense, np.arange(k))
    return HsblockResult(
        membership=dense, tree_paths=paths,
        loglik=_tree_score(edge_f, tot_f, a0_kk, b0_kk, lca_kk, n_nodes),
    )
