"""k-means on the device (the port of the JAX package's `ops/kmeans.py`).

kmeans++ seeding, then Lloyd iterations: the assignment step is one
[N, K] distance product and an argmin, the update step a segment sum.
The draws are the JAX package's (`utils/prng.py`: `randint` for the first
centre, `choice(p=...)` for the others, under the threefry key of
`seed`), so on well-separated data the labels equal the reference's;
where two distances or cumulative probabilities tie to float rounding
the orders of the sums may split them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import prng
from ..utils.precision import full_f32_matmul


def _plus_plus_init(key: np.ndarray, x: torch.Tensor, k: int) -> torch.Tensor:
    """kmeans++ seeding: each next centre drawn with probability
    proportional to the squared distance to the nearest centre so far."""
    n = x.shape[0]
    k0, key = prng.split(key)
    first = int(prng.randint(k0, (), 0, n))
    centers = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    d2 = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, ((x - centers[i - 1]) ** 2).sum(1))
        key, kc = prng.split(key)
        probs = d2 / torch.clamp(d2.sum(), min=1e-30)
        centers[i] = x[int(prng.choice(kc, probs.cpu().numpy()))]
    return centers


@torch.no_grad()
def kmeans_fit(key: np.ndarray, x: torch.Tensor, *, k: int, iters: int = 50):
    """(centers [k, D], labels [N]) of float32 `x` [N, D], on its device."""
    centers = _plus_plus_init(key, x, k)
    x_sq = (x * x).sum(1, keepdim=True)

    def assign(c):
        with full_f32_matmul():
            d2 = x_sq - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]
        return torch.argmin(d2, dim=1)

    for _ in range(iters):
        labels = assign(centers)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)  # empty clusters stay
    return centers, assign(centers)


def kmeans(x: np.ndarray, k: int, *, iters: int = 50, seed: int = 0, device="cuda"):
    """(centers [k, D], labels [N]) as numpy arrays."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    centers, labels = kmeans_fit(prng.key(seed), xt, k=k, iters=iters)
    return centers.cpu().numpy(), labels.cpu().numpy()
