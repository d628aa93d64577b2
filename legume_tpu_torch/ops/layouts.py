"""t-SNE and PHATE 2-D layouts (the port of the JAX package's
`ops/layouts.py`; UMAP lives in `ops/umap.py`).

The reference runs layouts over pseudobulk coordinates (hundreds to a
few thousand points), so both are exact O(N^2) dense [N, N] programs on
the device: softmax rows, products and a descent loop. Both descents are
chaotic, so every sum, product and exponential is formed by
`ops/rounding.py` in an order and rounding that are the same on the card
and on the CPU: a layout drawn on either is the same layout. PHATE's
diffusion, potential distances and classical MDS stay on the host in
float64, as in the reference; only its squared distances and its stress
descent run on the device.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..utils import prng
from . import rounding as R

__all__ = ["tsne", "phate"]


def _calibrate_p(d2: torch.Tensor, perplexity: float, n_iter: int = 40) -> torch.Tensor:
    """Per-row binary search for the Gaussian bandwidth matching the
    target perplexity, all rows at once; returns the symmetrized,
    normalized P."""
    n = d2.shape[0]
    target = R.log(torch.tensor(perplexity, dtype=torch.float32, device=d2.device))
    d2 = d2.clone()
    d2.fill_diagonal_(math.inf)
    finite = torch.isfinite(d2)

    def entropy(beta):
        p = R.exp(-d2 * beta)
        sum_p = torch.clamp(R.tree_sum(p, 1)[:, None], min=1e-12)
        # the diagonal carries d2 = inf, p = 0: select before multiplying
        # so inf * 0 never materializes as NaN
        rp = torch.where(finite, d2 * p, 0.0)
        h = R.log(sum_p) + beta * R.tree_sum(rp, 1)[:, None] / sum_p
        return h, p / sum_p

    lo = torch.zeros(n, 1, device=d2.device)
    hi = torch.full((n, 1), math.inf, device=d2.device)
    beta = torch.ones(n, 1, device=d2.device)
    for _ in range(n_iter):
        h, _ = entropy(beta)
        too_high = h > target  # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    _, p = entropy(beta)
    p = torch.where(torch.isfinite(p), p, 0.0)
    p = R.scale(p + p.T, 2.0 * n)
    return torch.clamp(p, min=1e-12)


@torch.no_grad()
def tsne(
    x: np.ndarray,
    *,
    perplexity: float = 30.0,
    n_iter: int = 500,
    exaggeration: float = 12.0,
    exaggerate_for: int = 120,
    learning_rate: float | None = None,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> np.ndarray:
    """Exact t-SNE to 2-D (van der Maaten & Hinton 2008): KL(P || Q)
    descent with momentum and early exaggeration. `timings` (if given)
    receives the seconds of the bandwidth search (`calibrate_s`) and of
    the descent (`descent_s`)."""
    t0 = time.perf_counter()
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    n = x.shape[0]
    perplexity = min(perplexity, max((n - 1) / 3.0, 2.0))
    eta = learning_rate if learning_rate is not None else max(n / exaggeration, 50.0)
    y = torch.from_numpy(prng.normal(prng.key(seed), (n, 2))).to(device) * 1e-2
    p = _calibrate_p(R.sq_dists(x, fused=False), perplexity)
    _sync(device)
    t1 = time.perf_counter()
    vel = torch.zeros_like(y)
    gains = torch.ones_like(y)
    for t in range(n_iter):
        early = t < exaggerate_for
        p_eff = p * exaggeration if early else p
        w = 1.0 / (1.0 + R.sq_dists(y, fused=True))
        w.fill_diagonal_(0.0)
        q = torch.clamp(w / torch.clamp(R.tree_sum(w.reshape(-1), 0), min=1e-12), min=1e-12)
        g = 4.0 * R.laplacian_product((p_eff - q) * w, y)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01, 10.0)
        vel = (0.5 if early else 0.8) * vel - eta * gains * g
        y = y + vel
        y = y - R.scale(R.tree_sum(y, 0)[None, :], n)
    out = y.cpu().numpy()
    if timings is not None:
        timings["calibrate_s"] = t1 - t0
        timings["descent_s"] = time.perf_counter() - t1
    return out


def phate_init(
    x: np.ndarray, *, knn: int = 5, decay: float = 40.0, t: int | str = "auto", device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """PHATE's host part: alpha-decay kernel on adaptive kNN bandwidths ->
    t-step diffusion -> log-potential distances -> classical MDS. Returns
    the normalized potential distances `[N, N]` float32 and the MDS init
    `[N, 2]` float32. Only the squared distances are formed on the device."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    knn = min(knn, n - 1)

    d2 = R.sq_dists(torch.as_tensor(x).to(device), fused=False).cpu().numpy()
    d = np.sqrt(d2)
    # adaptive bandwidth: distance to the knn-th neighbor
    sigma = np.maximum(np.sort(d, axis=1)[:, knn], 1e-8)
    # (d/sigma)^decay spans hundreds of orders of magnitude for far
    # pairs; compute in float64 with a clamp so the kernel underflows
    # to exactly 0 instead of overflowing
    ratio = np.minimum((d / sigma[:, None]).astype(np.float64), 50.0)
    k = np.exp(-(ratio**decay))
    k = 0.5 * (k + k.T)
    p = k / np.maximum(k.sum(1, keepdims=True), 1e-12)

    if t == "auto":
        # von Neumann entropy knee: pick the first t where the entropy
        # drop flattens (cheap proxy scan over powers)
        evals = np.abs(np.linalg.eigvals(p))
        evals = np.sort(evals)[::-1]
        ent = []
        ts = list(range(1, 31))
        for tt in ts:
            lam = evals**tt
            lam = lam / max(lam.sum(), 1e-12)
            ent.append(float(-(lam * np.log(np.maximum(lam, 1e-30))).sum()))
        drops = -np.diff(ent)
        t_pick = int(ts[int(np.argmax(drops < 0.05 * max(drops.max(), 1e-12)))])
        t = max(t_pick, 2)

    pt = np.linalg.matrix_power(p, int(t))
    pot = -np.log(np.maximum(pt, 1e-12))  # potential coordinates
    pd = pot @ pot.T
    s = np.diag(pd)
    pd = np.sqrt(np.maximum(s[:, None] + s[None, :] - 2.0 * pd, 0.0))
    # normalize to O(1) so the float32 refinement below stays well-conditioned
    pd = (pd / max(pd.mean(), 1e-12)).astype(np.float32)

    # classical MDS init
    j = np.eye(n) - 1.0 / n
    b = -0.5 * j @ (pd**2) @ j
    w, v = np.linalg.eigh(b)
    idx = np.argsort(w)[::-1][:2]
    y0 = (v[:, idx] * np.sqrt(np.maximum(w[idx], 0.0))).astype(np.float32)
    return pd, y0


@torch.no_grad()
def phate_refine(pd: np.ndarray, y0: np.ndarray, *, n_iter: int = 300, device="cuda") -> np.ndarray:
    """Metric MDS refinement of `y0` against the target distances `pd`:
    stress majorization by gradient descent, on the device."""
    n = pd.shape[0]
    target = torch.as_tensor(pd).to(device)
    y = torch.as_tensor(y0).to(device)
    lr = float(np.float32(n * 0.5))
    for _ in range(n_iter):
        dy = R.sqrt(torch.clamp(R.sq_dists(y, fused=True), min=1e-12))
        coef = (dy - target) / dy
        coef.fill_diagonal_(0.0)
        g = R.scale(4.0 * R.laplacian_product(coef, y), n * n)
        y = y - lr * g
    return y.cpu().numpy()


def phate(
    x: np.ndarray,
    *,
    knn: int = 5,
    decay: float = 40.0,
    t: int | str = "auto",
    n_iter: int = 300,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> np.ndarray:
    """PHATE to 2-D (Moon et al. 2019): alpha-decay kernel on adaptive
    kNN bandwidths -> t-step diffusion -> log-potential distances ->
    classical MDS init + metric-MDS (SGD) refinement. `timings` (if
    given) receives the seconds of the host part (`host_s`) and of the
    refinement (`refine_s`)."""
    t0 = time.perf_counter()
    pd, y0 = phate_init(x, knn=knn, decay=decay, t=t, device=device)
    t1 = time.perf_counter()
    y = phate_refine(pd, y0, n_iter=n_iter, device=device)
    if timings is not None:
        timings["host_s"] = t1 - t0
        timings["refine_s"] = time.perf_counter() - t1
    return y


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
