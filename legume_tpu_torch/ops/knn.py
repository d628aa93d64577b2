"""Exact chunked kNN over projected coordinates (the port of the JAX
package's `ops/knn.py`): one [chunk, K] x [K, N] matmul per query chunk
and a top-k on the negated squared distances that breaks exact ties by
the lower index, as `lax.top_k` does."""

from __future__ import annotations

import numpy as np
import torch


def _topk_lower_index_first(neg_d, k: int):
    """`torch.topk` of each row, ordered as `lax.top_k` orders it: larger
    values first and, among exactly equal values, the lower index first.
    `torch.topk` gives no order among equal values, so where the values
    tied with the k-th reach past the k chosen, the row is taken from a
    stable sort instead; then the k chosen are ordered by (value, index)."""
    val, idx = torch.topk(neg_d, k, dim=1)
    spill = (neg_d >= val[:, -1:]).sum(dim=1) > k
    if bool(spill.any()):
        rows = spill.nonzero()[:, 0]
        v2, i2 = torch.sort(neg_d[rows], dim=1, descending=True, stable=True)
        val[rows], idx[rows] = v2[:, :k], i2[:, :k]
    by_index = torch.argsort(idx, dim=1)
    val, idx = torch.gather(val, 1, by_index), torch.gather(idx, 1, by_index)
    by_value = torch.sort(val, dim=1, descending=True, stable=True).indices
    return torch.gather(val, 1, by_value), torch.gather(idx, 1, by_value)


def _topk_chunk(q, r, r_sq, mask_n, k: int, self_ids=None):
    """(sq_distances [C, k] float64, indices [C, k]). The neighbours are
    ranked by 2 q.r - ||r||^2 in float64; the squared distance of each one
    chosen is then formed from the coordinates, sum_j (q_j - r_j)^2 with
    elementwise float64 operations in coordinate order. So the distances
    depend on neither the matmul's nor a reduction's order nor on the
    ranked values: they are the same on every device and in every run
    (the expansion ||q||^2 - 2 q.r + ||r||^2 cancels to the distance of
    near neighbours, and the weights exp(-d) carry its error)."""
    q = q.double()
    neg_d = 2.0 * (q @ r.T) - r_sq[None, :]
    neg_d = neg_d.masked_fill(~mask_n[None, :], -torch.inf)
    if self_ids is not None:
        rows = torch.arange(q.shape[0], device=q.device)
        ok = self_ids < r.shape[0]
        neg_d[rows[ok], self_ids[ok]] = -torch.inf
    val, idx = _topk_lower_index_first(neg_d, k)
    diff = q[:, None, :] - r[idx]  # [C, k, K]
    d2 = diff[..., 0] * diff[..., 0]
    for j in range(1, diff.shape[-1]):
        d2 = d2 + diff[..., j] * diff[..., j]
    return d2.masked_fill(val == -torch.inf, torch.inf), idx  # no candidate left


def knn_search(
    queries: np.ndarray,  # [M, K]
    points: np.ndarray,  # [N, K]
    k: int,
    *,
    chunk: int = 4096,
    mask: np.ndarray | None = None,
    exclude_self_offset: int | None = None,
    mesh=None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN: (L2 distances [M, k], indices [M, k]). `mask` restricts
    the candidates; with `exclude_self_offset` the queries are
    points[offset:offset + M] and each query's own point is removed.

    `mesh` shards the query rows over the ranks as the JAX package's
    placement does: the chunk rounds up to a multiple of the world, each
    rank searches its equal share of every chunk padded to that length
    (the points on every rank), and the shares are gathered once, in rank
    order. Each row's search is its own, so the indices are the plain
    run's."""
    from ..parallel.mesh import live, padded_share
    from ..parallel.multihost import gather_padded

    mesh = live(mesh)
    m = queries.shape[0]
    n = points.shape[0]
    k = min(k, n)
    r = torch.as_tensor(np.asarray(points, np.float32), device=device).double()
    r_sq = (r * r).sum(dim=-1)
    mask_n = (
        torch.ones(n, dtype=torch.bool, device=device)
        if mask is None
        else torch.as_tensor(np.asarray(mask, bool), device=device)
    )
    q_all = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    # this rank's share [a, b) of every padded chunk, one [share, n_chunks, k]
    # plane a rank, gathered once (the whole chunk without a mesh)
    chunk, a, b = padded_share(mesh, chunk)
    starts = range(0, m, chunk)
    dists = np.full((b - a, len(starts), k), np.inf, np.float32)
    idxs = np.zeros((b - a, len(starts), k), np.int64)
    for c, lb in enumerate(starts):
        lo, hi = min(lb + a, m), min(lb + b, m)
        if hi <= lo:
            continue
        self_ids = None
        if exclude_self_offset is not None:
            self_ids = torch.arange(lo, hi, device=device) + exclude_self_offset
        d2, idx = _topk_chunk(q_all[lo:hi], r, r_sq, mask_n, k, self_ids)
        dists[: hi - lo, c] = torch.sqrt(d2).float().cpu().numpy()
        idxs[: hi - lo, c] = idx.cpu().numpy()
    # [rank * share + row, chunk, k] -> rows in query order
    dists = gather_padded(mesh, dists, chunk).transpose(1, 0, 2).reshape(-1, k)[:m]
    idxs = gather_padded(mesh, idxs, chunk).transpose(1, 0, 2).reshape(-1, k)[:m]
    return np.ascontiguousarray(dists), np.ascontiguousarray(idxs)


def knn_within(points: np.ndarray, k: int, *, chunk: int = 4096, device="cuda"):
    """kNN of a set against itself, self-matches excluded."""
    return knn_search(points, points, k, chunk=chunk, exclude_self_offset=0, device=device)


def matched_neighbors_across_batches(
    proj_nk: np.ndarray,  # [N, K]
    batches: np.ndarray,  # [N] batch codes in [0, B)
    num_batches: int,
    k: int,
    *,
    chunk: int = 4096,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For every cell, its k nearest cells in each OTHER batch:
    (indices [N, (B-1)k], distances [N, (B-1)k], valid [N, (B-1)k])."""
    n = proj_nk.shape[0]
    fill = max(num_batches - 1, 1) * k
    out_idx = np.zeros((n, fill), np.int64)
    out_dist = np.full((n, fill), np.inf, np.float32)
    out_valid = np.zeros((n, fill), bool)
    for b in range(num_batches):
        in_b = batches == b
        nb = int(in_b.sum())
        if nb == 0:
            continue
        d, i = knn_search(proj_nk, proj_nk, min(k, nb), chunk=chunk, mask=in_b, device=device)
        kk = d.shape[1]
        for q_b in range(num_batches):
            if q_b == b:
                continue
            rows = batches == q_b
            slot = b - 1 if b > q_b else b
            out_idx[rows, slot * k : slot * k + kk] = i[rows]
            out_dist[rows, slot * k : slot * k + kk] = d[rows]
            out_valid[rows, slot * k : slot * k + kk] = True
    return out_idx, out_dist, out_valid
