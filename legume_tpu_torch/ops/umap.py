"""UMAP layout by edge-sampled SGD on the device (the port of the JAX
package's `ops/umap.py`; used by `senna layout`).

Each step samples a fixed-size batch of positive edges (probability ~
fuzzy weight) plus uniform negatives, computes the UMAP attractive and
repulsive gradients and scatter-adds the updates. The draws are the JAX
package's threefry stream (`key(seed)` split into one key per step, each
split again for the edges and the negatives), generated on the device
for every step before the loop (`utils/prng.py`, `*_rows`). The descent
is chaotic, so every operation rounds as in the reference's compiled CPU
step (`ops/rounding.py`), the scatter-adds of repeated indices included:
a rerun with the same seed, on the card or on the CPU, gives the same
layout bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import prng
from . import rounding as R

INIT_SCALE = 10.0  # pca.rs INIT_SCALE: UMAP SGD clamps steps at +-4
_JITTER_FRAC = 1e-4  # uwot scale_and_jitter
_DRAW_CHUNK = 256  # steps whose draws are generated at once


def pc_scores(x: np.ndarray, rank: int, skip: int = 1) -> np.ndarray:
    """Principal-component scores with the `skip` leading axes dropped
    (matrix-util pca.rs:47 `pc_scores`). No centering pass: on the
    nonnegative rows this pipeline lays out (topic simplices,
    unit-normalized latents) every row loads positively on the first
    singular vector, so that axis IS the mean profile — dropping it
    de-means without materializing a centered copy. Pass skip=0 for
    already-centered data. numpy's SVD, as the reference takes it: another
    SVD picks other signs and flips the layout."""
    x = np.asarray(x, np.float32)
    want = min(rank + skip, min(x.shape))
    if rank <= 0 or want <= skip:
        raise ValueError(
            f"no components left: {x.shape} data, rank={rank}, skip={skip}"
        )
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    keep = min(u.shape[1] - skip, rank)
    return u[:, skip : skip + keep] * s[skip : skip + keep]


def init_2d_from_scores(scores: np.ndarray, seed: int = 0) -> np.ndarray:
    """[N, 2] SGD init from the leading two PC scores, rescaled so the
    largest |coordinate| is INIT_SCALE, plus a small jitter
    (pca.rs `init_2d_from_scores`). The jitter matters: two points at
    identical scores sit at exactly zero distance where the attractive
    gradient vanishes and the repulsive one has no direction — the
    pair could never separate."""
    rng = np.random.default_rng(seed)
    if scores.shape[1] < 2:
        return rng.uniform(-INIT_SCALE, INIT_SCALE, (scores.shape[0], 2)).astype(
            np.float32
        )
    emb = np.asarray(scores[:, :2], np.float32)
    m = np.abs(emb).max()
    if m < 1e-8:
        return rng.uniform(-INIT_SCALE, INIT_SCALE, (scores.shape[0], 2)).astype(
            np.float32
        )
    emb = emb / m * INIT_SCALE
    emb += rng.normal(0.0, _JITTER_FRAC * INIT_SCALE, emb.shape)
    return emb.astype(np.float32)


def _fit_ab(min_dist: float, spread: float) -> tuple[float, float]:
    """Least-squares fit of the (a, b) rational curve to the target
    membership function (standard UMAP procedure)."""
    from scipy.optimize import curve_fit

    x = np.linspace(0, 3 * spread, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))
    f = lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b))
    (a, b), _ = curve_fit(f, x, y, p0=[1.0, 1.0], maxfev=10000)
    return float(a), float(b)


def fuzzy_edges(
    coords: np.ndarray, k: int = 15, *, chunk: int = 4096, device="cuda",
    timings: dict | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """kNN (on the device) -> smoothed exponential membership weights;
    returns (src [E], dst [E], weight [E]) symmetrized by fuzzy union.
    `timings` (if given) receives the seconds of the kNN (`knn_s`) and of
    the graph (`fuzzy_s`)."""
    import scipy.sparse as sp

    from .knn import knn_within

    t0 = time.perf_counter()
    n = coords.shape[0]
    d, idx = knn_within(coords.astype(np.float32), min(k, n - 1), chunk=chunk, device=device)
    t1 = time.perf_counter()
    rho = d[:, :1]  # distance to nearest neighbor
    sigma = np.maximum(d.mean(axis=1, keepdims=True) - rho, 1e-3)
    w = np.exp(-np.maximum(d - rho, 0.0) / sigma)
    src = np.repeat(np.arange(n), idx.shape[1])
    dst = idx.ravel()
    g = sp.csr_matrix((w.ravel(), (src, dst)), shape=(n, n))
    g = g + g.T - g.multiply(g.T)  # fuzzy union
    coo = g.tocoo()
    keep = coo.row < coo.col
    out = coo.row[keep], coo.col[keep], coo.data[keep].astype(np.float32)
    if timings is not None:
        timings["knn_s"] = t1 - t0
        timings["fuzzy_s"] = time.perf_counter() - t1
    return out


def sgd_draws(seed: int, probs: np.ndarray, *, n_steps: int, batch: int, n_points: int,
              neg_per_pos: int = 5, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The edge indices `[n_steps, batch]` and negatives `[n_steps, batch,
    neg_per_pos]` of every step, on `device`: `choice(k1, E, (batch,),
    p=probs)` and `randint(k2, (batch, neg_per_pos), 0, n_points)` under
    `k1, k2 = split(split(key(seed), n_steps)[i])`, as the JAX package
    draws them. The float32 cumsum of `probs` is the same in every step,
    so it is formed once."""
    step_keys = prng.key_rows(prng.split(prng.key(seed), n_steps), device)
    cum = torch.from_numpy(prng.cumsum_f32(probs)).to(device)
    eidx, neg = [], []
    for lb in range(0, n_steps, _DRAW_CHUNK):
        k12 = prng.split_rows(step_keys[lb : lb + _DRAW_CHUNK])
        eidx.append(prng.choice_rows(k12[:, 0], cum, batch))
        neg.append(prng.randint_rows(k12[:, 1], batch * neg_per_pos, 0, n_points)
                   .view(-1, batch, neg_per_pos))
    return torch.cat(eidx), torch.cat(neg)


@torch.no_grad()
def _umap_sgd(
    seed: int,
    emb0: np.ndarray,  # [N, 2]
    src: np.ndarray,
    dst: np.ndarray,
    probs: np.ndarray,
    *,
    n_steps: int,
    batch: int,
    n_points: int,
    a: float,
    b: float,
    lr0: float = 1.0,
    neg_per_pos: int = 5,
    device="cuda",
    timings: dict | None = None,
) -> np.ndarray:
    """`n_steps` SGD steps from `emb0`; `timings` (if given) receives the
    seconds of the draws (`rng_s`) and of the steps (`sgd_s`)."""
    t0 = time.perf_counter()
    eidx, negs = sgd_draws(seed, probs, n_steps=n_steps, batch=batch, n_points=n_points,
                           neg_per_pos=neg_per_pos, device=device)
    _sync(device)
    t1 = time.perf_counter()
    # one spare row past the points takes the scatters' free slots
    emb = torch.zeros(n_points + 1, 2, device=device)
    emb[:n_points] = torch.as_tensor(np.asarray(emb0, np.float32)).to(device)
    src_t = torch.as_tensor(np.asarray(src, np.int64)).to(device)
    dst_t = torch.as_tensor(np.asarray(dst, np.int64)).to(device)
    src_i, dst_i = src_t[eidx], dst_t[eidx]
    plan_s, plan_t = R.scatter_plan(src_i, n_points), R.scatter_plan(dst_i, n_points)
    # lr = lr0 * (1 - i / n_steps), which XLA computes as fma(-i, 1 / n_steps, 1)
    recip = np.float64(np.float32(1.0) / np.float32(n_steps))
    lrs = np.float32(lr0) * (1.0 - np.arange(n_steps) * recip).astype(np.float32)
    # a and b enter the reference's step as float32 arguments: its
    # constants are products and differences in float32
    a32, b32 = np.float32(a), np.float32(b)
    att = float(np.float32(-2.0) * a32 * b32)
    e_att, e_rep, two_b = float(b32 - np.float32(1.0)), float(b32), float(np.float32(2.0) * b32)
    a32 = float(a32)
    # Each float32 operation rounds as in the reference's compiled CPU step
    # (`ops/rounding.py`): XLA contracts the squared distances to the
    # negatives, the attractive denominator and the repulsive denominator of
    # the last negative (its vector loop takes the first four without
    # contraction) into fused multiply-adds, and sums the negatives in order.
    for i in range(n_steps):
        lr = float(lrs[i])
        s, t = src_i[i], dst_i[i]
        on_s = [plan_s[0][i], plan_s[1][i], plan_s[2][i], plan_s[3][i]]
        on_t = [plan_t[0][i], plan_t[1][i], plan_t[2][i], plan_t[3][i]]
        # attractive
        diff = emb[s] - emb[t]
        d2 = diff[:, 0:1] * diff[:, 0:1] + diff[:, 1:2] * diff[:, 1:2]
        grad_coef = (att * R.pow(d2, e_att)) / R.fma(a32, R.pow(d2, e_rep), 1.0)
        g = torch.clamp(grad_coef * diff, -4.0, 4.0)
        R.scatter_add(emb, lr * g, *on_s)
        R.scatter_add(emb, -lr * g, *on_t)
        # repulsive: uniform negatives for each positive's source
        diff_n = emb[s][:, None, :] - emb[negs[i]]
        d2n = R.fma(diff_n[..., 1:2], diff_n[..., 1:2], (diff_n[..., 0:1] * diff_n[..., 0:1]).double())
        pn = R.pow(d2n, e_rep)
        den = torch.cat([1.0 + a32 * pn[:, :-1], R.fma(a32, pn[:, -1:], 1.0)], 1)
        rep = torch.full_like(d2n, two_b) / ((0.001 + d2n) * den)  # not `two_b / x`, a reciprocal
        gn = torch.clamp(rep * diff_n, -4.0, 4.0)
        total = gn[:, 0]
        for j in range(1, neg_per_pos):
            total = total + gn[:, j]
        R.scatter_add(emb, lr * total, *on_s)
    out = emb[:n_points].cpu().numpy()
    if timings is not None:
        timings["rng_s"] = t1 - t0
        timings["sgd_s"] = time.perf_counter() - t1
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def umap(
    x: np.ndarray,
    *,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    spread: float = 1.0,
    n_epochs: int = 200,
    batch: int = 4096,
    seed: int = 0,
    kernel: str = "umap",
    pcs: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> np.ndarray:
    """2D UMAP embedding of [N, D] points.

    kernel="tumap" uses the uwot::tumap a=b=1 kernel 1/(1+d^2)
    (umap.rs:54): more spread, and the layout faba's lineage view runs
    (lineage/layout.rs:126). pcs>0 builds BOTH the kNN graph and the
    SGD init on `pc_scores(x, pcs, skip=1)` — neighbours on X_pca and
    a PCA seed, with the nonnegative mean axis dropped
    (lineage/layout.rs:94-99). `timings` (if given) receives the seconds
    of the init (`init_s`), the kNN (`knn_s`), the fuzzy graph
    (`fuzzy_s`), the draws (`rng_s`) and the steps (`sgd_s`)."""
    t = timings if timings is not None else {}
    t0 = time.perf_counter()
    n = x.shape[0]
    if pcs > 0:
        graph_feats = pc_scores(x, pcs, 1)
        emb0 = init_2d_from_scores(graph_feats, seed)
    else:
        graph_feats = x
        xc = x - x.mean(0)
        u, s, vt = np.linalg.svd(xc, full_matrices=False)
        emb0 = init_2d_from_scores(u[:, :2] * s[:2], seed)
    t["init_s"] = time.perf_counter() - t0
    src, dst, w = fuzzy_edges(np.asarray(graph_feats, np.float32), n_neighbors,
                              device=device, timings=t)
    a, b = (1.0, 1.0) if kernel == "tumap" else _fit_ab(min_dist, spread)

    probs = w / w.sum()
    n_steps = max(1, n_epochs * max(len(src) // batch, 1))
    return _umap_sgd(
        seed, emb0, src, dst, probs,
        n_steps=min(n_steps, 2000),
        batch=min(batch, max(len(src), 8)),
        n_points=n,
        a=a,
        b=b,
        device=device,
        timings=t,
    )
