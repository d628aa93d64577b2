"""Archetypal analysis (the port of the JAX package's `ops/archetypal.py`;
matrix-util `archetypal.rs` equivalent).

X ~ A Z with Z = B X: archetypes are convex combinations of data points,
and each point a convex combination of archetypes (Cutler & Breiman 1994).
Fitted by alternating projected-gradient steps on the two
simplex-constrained factors, all dense products on `device`. The
Dirichlet starts come from numpy's generator in the JAX package's order,
so both packages start from the same A and B.
"""

from __future__ import annotations

import numpy as np
import torch


def _project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row onto the probability simplex."""
    k = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    ind = torch.arange(1, k + 1, device=v.device, dtype=v.dtype)
    rho = torch.sum(u - css / ind > 0, dim=-1, keepdim=True)
    theta = torch.gather(css, -1, rho - 1) / rho
    return torch.clamp(v - theta, min=0.0)


def fit_archetypes(
    x: np.ndarray, k: int, *, n_iter: int = 200, seed: int = 0, device="cuda"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (archetypes Z [K, D], weights A [N, K], B [K, N])."""
    rng = np.random.default_rng(seed)
    n, _ = x.shape
    x_t = torch.as_tensor(np.asarray(x, np.float32), device=device)
    a = torch.as_tensor(rng.dirichlet(np.ones(k), size=n).astype(np.float32), device=device)
    b = torch.as_tensor(rng.dirichlet(np.ones(n), size=k).astype(np.float32), device=device)
    xx = torch.sum(x_t * x_t)
    for _ in range(n_iter):
        z = b @ x_t
        # A-step: projected gradient on ||A Z - X||
        ga = (a @ z - x_t) @ z.T
        a = _project_simplex(a - ga / torch.clamp(torch.sum(z * z), min=1e-8))
        # B-step: projected gradient on ||A (B X) - X||
        z = b @ x_t
        gb = a.T @ (a @ z - x_t) @ x_t.T
        b = _project_simplex(b - gb / torch.clamp(xx * torch.sum(a * a), min=1e-8))
    z = b @ x_t
    return z.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy()
