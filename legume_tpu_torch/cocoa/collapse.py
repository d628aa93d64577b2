"""Topic-weighted counterfactual matched statistics (the port of the JAX
package's `cocoa/collapse.py`).

For each cell j (individual i(j), exposure x_i, pseudobulk sample p(j))
and topic k with z_jk >= 1e-8:

    weights over the matched set M_j (kNN cells of opposite-exposure
    individuals): w_a = exp(-dist_a) z_matched[a, k], normalised
    y0[g,k,p] += z_jk sum_a w_a y[g, a] / sum_a w_a
    y1[g,k,p] += z_jk y[g, j];   y1_di[g,k,i] += z_jk y[g, j]
    size[k,p] += z_jk;           size_ip[k,i,p] += z_jk

The match cache holds every cell's k nearest cells in each other
individual (exact kNN, exposure-agnostic), so a permutation replay only
re-filters by exposure. `collect_cocoa_stat` gathers each query block's
matched columns (the JAX package's direct form). The replay collector
`collect_cocoa_stat_multi` reads each column once for all exposure rows:
pass A scatters every row's normalised coefficients into a weight plane
W[t, matched cell, sample, topic] and an active plane A[t, cell, topic];
pass B forms y0 = Y W and the y1 planes from A, one dense column slab at
a time. Both run on the device in torch ops (the JAX package's XLA
segment sums; no Pallas kernel on this path). Every segment sum goes
through `ops/sparse.py::segment_add`, whose order of addition is fixed.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..data.visitors import csc_to_coo_block, visit_columns_by_block
from ..ops.knn import knn_search
from ..ops.random_projection import block_to_device
from ..ops.sparse import col_ids_from_ptr, densify_block, segment_add
from .stat import CocoaStat

# bytes of the W plane one chunk of exposure rows may hold (the JAX
# package's default budget)
W_BUDGET = 5e8


@dataclass
class MatchCache:
    """Per-cell kNN matches in every other individual."""

    idx: np.ndarray  # [N, M] global matched cell ids
    dist: np.ndarray  # [N, M] L2 distances
    valid: np.ndarray  # [N, M]
    matched_indv: np.ndarray  # [N, M] individual of each matched cell


def build_match_cache(
    proj_nk: np.ndarray, cell_indv: np.ndarray, n_indv: int, knn: int, *,
    chunk: int = 4096, mesh=None, device="cuda",
) -> MatchCache:
    """The k nearest cells of every individual for every cell of the
    others. Each individual's search runs against its own cells only
    (the JAX package masks the other cells out of a search over all N:
    the same neighbours, without the I x N^2 distance plane). `mesh`
    shards each search's queries over the ranks (`knn_search`); every
    rank ends with the whole cache."""
    n = proj_nk.shape[0]
    m = max(n_indv - 1, 1) * knn
    idx = np.zeros((n, m), np.int32)
    dist = np.full((n, m), np.inf, np.float32)
    valid = np.zeros((n, m), bool)
    for i in range(n_indv):
        members = np.flatnonzero(cell_indv == i)
        if members.size == 0:
            continue
        kk = min(knn, members.size)
        d, ix = knn_search(proj_nk, proj_nk[members], kk, chunk=chunk, mesh=mesh, device=device)
        ix = members[ix]
        for q_i in range(n_indv):
            if q_i == i:
                continue
            rows = cell_indv == q_i
            s = i - 1 if i > q_i else i
            idx[rows, s * knn : s * knn + kk] = ix[rows]
            dist[rows, s * knn : s * knn + kk] = d[rows]
            valid[rows, s * knn : s * knn + kk] = True
    return MatchCache(idx=idx, dist=dist, valid=valid, matched_indv=cell_indv[idx])


# ---- match-cache persistence (files shared with the JAX package) -----------


def match_cache_key(n: int, knn: int, n_indv: int, proj_dim: int, seed: int,
                    cell_indv: np.ndarray) -> str:
    """Fingerprint of what the cache depends on: the projection (its seed
    and dimension), the individual of each cell and knn."""
    h = hashlib.sha1()
    h.update(np.asarray([n, knn, n_indv, proj_dim, seed], np.int64).tobytes())
    h.update(np.ascontiguousarray(cell_indv, np.int64).tobytes())
    return h.hexdigest()[:16]


def match_cache_file(backend_path: str, key: str) -> str:
    if os.path.isdir(backend_path):
        return os.path.join(backend_path, "match_cache", f"{key}.npz")
    return f"{backend_path}.match_cache.{key}.npz"


def save_match_cache(cache: MatchCache, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    # uncompressed: the JAX package's loader reads it as it reads its own
    # compressed file, and compressing costs more than the search it saves
    np.savez(tmp, idx=cache.idx, dist=cache.dist, valid=cache.valid,
                        matched_indv=cache.matched_indv)
    os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""), path)


def load_match_cache(path: str) -> MatchCache | None:
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
        return MatchCache(idx=z["idx"], dist=z["dist"], valid=z["valid"],
                          matched_indv=z["matched_indv"])
    except (OSError, KeyError, ValueError):
        return None


# ---- the statistics ----------------------------------------------------------


def _pair_coeffs(dist, valid, z_query_k, z_matched_k):
    """Per-(cell, pair, topic) normalised weights
    c[j,a,k] = z_jk exp(-d_a) z0[a,k] / sum_a' exp(-d_a') z0[a',k], zero
    where z_jk < 1e-8 or the denominator < 1e-8; and the z-active plane
    [.., C, K]. Leading dims of `dist`/`valid` ([.., C, M]) broadcast."""
    ed = torch.where(valid, torch.exp(-dist), 0.0)
    w = ed[..., None] * z_matched_k  # [.., C, M, K]
    denom = w.sum(dim=-2, keepdim=True)
    w = torch.where(denom > 1e-8, w / torch.clamp_min(denom, 1e-30), 0.0)
    zq = torch.where(z_query_k >= 1e-8, z_query_k, 0.0)
    active = (denom[..., 0, :] > 1e-8).to(zq.dtype) * zq
    return w * zq[..., None, :], active


def _sizes(z_active: np.ndarray, cell_indv, pb_sample, n_indv, n_samples):
    """(size_kp [K, P], size_kip [K, I, P]) from the z-active plane [N, K]."""
    k = z_active.shape[1]
    kp = np.zeros((n_samples, k), np.float32)
    np.add.at(kp, pb_sample, z_active)
    ip = np.zeros((n_indv, n_samples, k), np.float32)
    np.add.at(ip, (cell_indv, pb_sample), z_active)
    return kp.T.copy(), ip.transpose(2, 0, 1).copy()


def collect_cocoa_stat(
    data,
    cell_topic_nk: np.ndarray,  # [N, K] proportions
    cell_indv: np.ndarray,  # [N]
    pb_sample: np.ndarray,  # [N]
    n_samples: int,
    exposure: np.ndarray,  # [I]
    cache: MatchCache,
    *,
    gene_weights: np.ndarray | None = None,
    cell_block: int = 1024,
    device="cuda",
) -> CocoaStat:
    """One pass over query blocks, each reading its matched columns."""
    n, k = cell_topic_nk.shape
    d = data.num_rows
    n_indv = len(exposure)
    exposure = np.asarray(exposure)
    m = cache.idx.shape[1]
    z_all = torch.from_numpy(np.ascontiguousarray(cell_topic_nk, np.float32)).to(device)
    y0 = torch.zeros(d * n_samples, k, device=device)
    y1 = torch.zeros(d * n_samples, k, device=device)
    y1i = torch.zeros(d * n_indv, k, device=device)
    active_all = np.zeros((n, k), np.float32)
    for lb in range(0, n, cell_block):
        ub = min(lb + cell_block, n)
        c = ub - lb
        valid = cache.valid[lb:ub] & (
            exposure[cache.matched_indv[lb:ub]] != exposure[cell_indv[lb:ub]][:, None])
        idx_t = torch.from_numpy(cache.idx[lb:ub].reshape(-1).astype(np.int64)).to(device)
        coeffs, z_active = _pair_coeffs(
            torch.from_numpy(cache.dist[lb:ub]).to(device), torch.from_numpy(valid).to(device),
            z_all[lb:ub], z_all[idx_t].reshape(c, m, k),
        )
        active_all[lb:ub] = z_active.cpu().numpy()
        # y0: the matched columns, one per pair
        pair = csc_to_coo_block(data.read_columns_csc(cache.idx[lb:ub].reshape(-1)))
        rows, ptr, vals = block_to_device(pair, device)
        cols = col_ids_from_ptr(ptr)
        sample = torch.from_numpy(np.repeat(pb_sample[lb:ub], m).astype(np.int64)).to(device)
        segment_add(y0, 0, rows.long() * n_samples + sample[cols],
                    vals[:, None] * coeffs.reshape(c * m, k)[cols])
        # y1: the query columns
        blk = csc_to_coo_block(data.read_columns_csc(np.arange(lb, ub)))
        rows, ptr, vals = block_to_device(blk, device)
        cols = col_ids_from_ptr(ptr)
        contrib = vals[:, None] * z_active[cols]
        q_s = torch.from_numpy(pb_sample[lb:ub].astype(np.int64)).to(device)
        q_i = torch.from_numpy(cell_indv[lb:ub].astype(np.int64)).to(device)
        segment_add(y1, 0, rows.long() * n_samples + q_s[cols], contrib)
        segment_add(y1i, 0, rows.long() * n_indv + q_i[cols], contrib)
    stat = CocoaStat.zeros(k, d, n_indv, n_samples)
    stat.y0_sum_kdp = y0.reshape(d, n_samples, k).permute(2, 0, 1).cpu().numpy()
    stat.y1_sum_kdp = y1.reshape(d, n_samples, k).permute(2, 0, 1).cpu().numpy()
    stat.y1_sum_kdi = y1i.reshape(d, n_indv, k).permute(2, 0, 1).cpu().numpy()
    stat.size_kp, stat.size_kip = _sizes(active_all, cell_indv, pb_sample, n_indv, n_samples)
    if gene_weights is not None:
        stat.apply_gene_weights(gene_weights)
    return stat


def accumulate_match_weights(w_acc, a_acc, exposures_ti, q_indv, m_indv, dist, valid_base,
                             zq, zm, pair_cols, pb_blk, q_ids, *, n_samples: int):
    """Pass A for one query block: the coefficients under every exposure
    row, scattered into W [T, N * P, K] (by matched cell and query sample)
    and A [T, N, K] (by query cell). No count data is read."""
    t, _ = exposures_ti.shape
    c, m = dist.shape
    k = zq.shape[1]
    rows = torch.arange(t, device=dist.device)[:, None, None]
    valid = valid_base[None] & (exposures_ti[rows, m_indv[None]]
                                != exposures_ti[rows[..., 0], q_indv[None]][..., None])
    coeffs, z_active = _pair_coeffs(dist[None], valid, zq[None], zm[None])
    flat = pair_cols * n_samples + pb_blk.repeat_interleave(m)
    segment_add(w_acc, 1, flat, coeffs.reshape(t, c * m, k))
    a_acc[:, q_ids] += z_active
    return w_acc, a_acc


def apply_weights_block(y0_acc, y1_acc, y1i_acc, w_blk, a_blk, x_cd, pb_blk, indv_blk, *,
                        n_samples: int, n_indv: int):
    """Pass B for one column slab: x_cd [C, D] dense counts (every column
    read once for all T rows); y0 += Y W, y1 += Y (A placed at each
    column's sample), y1i += Y (A placed at each column's individual)."""
    t, c, k = a_blk.shape
    d = x_cd.shape[1]
    y0_acc += (x_cd.T @ w_blk.permute(1, 0, 2, 3).reshape(c, -1)).reshape(d, t, n_samples, k)
    a_cs = a_blk.permute(1, 0, 2)  # [C, T, K]
    place = torch.zeros(c, t, n_samples, k, device=a_blk.device)
    place[torch.arange(c, device=a_blk.device), :, pb_blk] = a_cs
    y1_acc += (x_cd.T @ place.reshape(c, -1)).reshape(d, t, n_samples, k)
    place = torch.zeros(c, t, n_indv, k, device=a_blk.device)
    place[torch.arange(c, device=a_blk.device), :, indv_blk] = a_cs
    y1i_acc += (x_cd.T @ place.reshape(c, -1)).reshape(d, t, n_indv, k)
    return y0_acc, y1_acc, y1i_acc


def collect_cocoa_stat_multi(
    data,
    cell_topic_nk: np.ndarray,  # [N, K]
    cell_indv: np.ndarray,  # [N]
    pb_sample: np.ndarray,  # [N]
    n_samples: int,
    exposures_ti: np.ndarray,  # [T, I]; row 0 usually the observed exposure
    cache: MatchCache,
    *,
    gene_weights: np.ndarray | None = None,
    cell_block: int = 1024,
    t_chunk: int | None = None,
    mesh=None,
    device="cuda",
) -> list[CocoaStat]:
    """The replay collector: one CocoaStat per exposure row, row t equal
    to `collect_cocoa_stat` under that exposure to float rounding. W holds
    T N P K floats, so T runs in chunks of `t_chunk` rows (default: what
    fits in `W_BUDGET` bytes), each re-reading the data once.

    `mesh` shards the exposure rows over the ranks, as the JAX package's
    `shard_map` over its devices does: the budget scales by the world,
    `t_chunk` rounds down to a multiple of it, each chunk pads to a
    multiple with rows of exposure 0, each rank replays its equal share
    of the chunk (W and A for its rows only), and the planes are gathered
    in exposure order with the pad rows dropped."""
    from ..parallel.mesh import live, padded_share
    from ..parallel.multihost import gather_padded

    mesh = live(mesh)
    world = 1 if mesh is None else mesh.size
    n, k = cell_topic_nk.shape
    d = data.num_rows
    t_total, n_indv = exposures_ti.shape
    m = cache.idx.shape[1]
    if t_chunk is None:
        t_chunk = max(int(W_BUDGET * world // max(n * (n_samples + 1) * k * 4, 1)), world)
    t_chunk = min(t_chunk, t_total)
    if mesh is not None:
        t_chunk = max(t_chunk - t_chunk % world, world)
    as_long = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)  # noqa: E731
    z_all = torch.from_numpy(np.ascontiguousarray(cell_topic_nk, np.float32)).to(device)
    indv_t, pb_t = as_long(cell_indv), as_long(pb_sample)
    stats: list[CocoaStat] = []
    for t_lo in range(0, t_total, t_chunk):
        t_hi = min(t_lo + t_chunk, t_total)
        tc_real = t_hi - t_lo
        exp_chunk = exposures_ti[t_lo:t_hi]
        tc_pad, a, b = padded_share(mesh, tc_real)
        if tc_pad > tc_real:  # pad rows replay exposure 0
            exp_chunk = np.concatenate([exp_chunk, np.repeat(exposures_ti[:1], tc_pad - tc_real, 0)])
        tc = b - a
        exp_t = as_long(exp_chunk[a:b])
        w_acc = torch.zeros(tc, n * n_samples, k, device=device)
        a_acc = torch.zeros(tc, n, k, device=device)
        for lb in range(0, n, cell_block):
            ub = min(lb + cell_block, n)
            c = ub - lb
            pair_cols = as_long(cache.idx[lb:ub].reshape(-1))
            accumulate_match_weights(
                w_acc, a_acc, exp_t, indv_t[lb:ub], as_long(cache.matched_indv[lb:ub]),
                torch.from_numpy(cache.dist[lb:ub]).to(device),
                torch.from_numpy(cache.valid[lb:ub]).to(device),
                z_all[lb:ub], z_all[pair_cols].reshape(c, m, k), pair_cols, pb_t[lb:ub],
                torch.arange(lb, ub, device=device), n_samples=n_samples,
            )
        w4 = w_acc.reshape(tc, n, n_samples, k)
        y0 = torch.zeros(d, tc, n_samples, k, device=device)
        y1 = torch.zeros(d, tc, n_samples, k, device=device)
        y1i = torch.zeros(d, tc, n_indv, k, device=device)
        for blk in visit_columns_by_block(data, block_size=cell_block):
            lb, ub = blk.lb, blk.lb + blk.ncols
            rows, ptr, vals = block_to_device(blk, device)
            x = densify_block(rows, col_ids_from_ptr(ptr), vals, ncols=blk.ncols, num_genes=d)
            apply_weights_block(y0, y1, y1i, w4[:, lb:ub], a_acc[:, lb:ub], x, pb_t[lb:ub],
                                indv_t[lb:ub], n_samples=n_samples, n_indv=n_indv)
        szkp = segment_add(torch.zeros(tc, n_samples, k, device=device), 1, pb_t, a_acc)
        szkip = segment_add(torch.zeros(tc, n_indv * n_samples, k, device=device), 1,
                            indv_t * n_samples + pb_t, a_acc)
        # [T, ...] planes; under a mesh every rank's rows in exposure order
        y0_np, y1_np, y1i_np = (gather_padded(mesh, v.permute(1, 3, 0, 2).contiguous(), tc_real)
                                for v in (y0, y1, y1i))
        szkp_np = gather_padded(mesh, szkp, tc_real)
        szkip_np = gather_padded(mesh, szkip.reshape(tc, n_indv, n_samples, k), tc_real)
        for t in range(tc_real):
            stat = CocoaStat.zeros(k, d, n_indv, n_samples)
            stat.y0_sum_kdp, stat.y1_sum_kdp, stat.y1_sum_kdi = y0_np[t], y1_np[t], y1i_np[t]
            stat.size_kp = szkp_np[t].T.copy()
            stat.size_kip = szkip_np[t].transpose(2, 0, 1).copy()
            if gene_weights is not None:
                stat.apply_gene_weights(gene_weights)
            stats.append(stat)
    return stats
