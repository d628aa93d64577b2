"""Randomized SVD (the port of the JAX package's `ops/rsvd.py`).

Halko-Martinsson-Tropp range finder with power iterations on the device;
the small [k, N] SVD runs on the host with `np.linalg.svd`, as the JAX
package does. The Gaussian test matrix is the threefry draw of the JAX
package for the same key, so the sketch is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import prng


def _rsvd_project(x: torch.Tensor, rank: int, *, key: np.ndarray, oversample: int = 10,
                  power_iters: int = 2):
    m, n = x.shape
    k = min(rank + oversample, min(m, n))
    omega = torch.from_numpy(prng.normal(key, (n, k))).to(x.device)
    q, _ = torch.linalg.qr(x @ omega)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(x @ (x.T @ q))
    return q, q.T @ x


def rsvd(x: torch.Tensor, rank: int, *, key: np.ndarray, oversample: int = 10,
         power_iters: int = 2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated SVD of `x` [M, N]: (U [M, r], S [r], Vt [r, N]) as numpy."""
    q, b = _rsvd_project(x, rank, key=key, oversample=oversample, power_iters=power_iters)
    ub, s, vt = np.linalg.svd(b.cpu().numpy(), full_matrices=False)
    u = q.cpu().numpy() @ ub
    return u[:, :rank], s[:rank], vt[:rank, :]
