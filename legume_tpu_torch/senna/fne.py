"""`senna fne` — feature-network embedding from an edge list (the port of
the JAX package's `senna/fne.py`; `senna/src/fne.rs` equivalent).

Embeds graph nodes from weighted edges with bge's expected-NCE
objective: the "counts" plane is the symmetrised adjacency, and both
sides share one embedding table and one bias. Each epoch is one K4
launch in its full form (`embedding/nce_kernel.py::nce_epoch_grads`) with
tied weights, `e_axis = e_feat = e` and `b_axis = b_feat = b`, so the
gradient of `e` is `g_e_axis + g_e_feat` and that of `b` is
`g_b_axis + g_b_feat`; then one Adam step (optax's, `embedding/nce.py::
_Adam`). The init is the JAX package's threefry draw,
`0.1 * normal(key(seed), (n, d))`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..embedding.nce import _Adam
from ..embedding.nce_kernel import nce_epoch_grads
from ..utils import prng

log = logging.getLogger(__name__)


@dataclass
class FneResult:
    embedding: np.ndarray  # [N, H]
    bias: np.ndarray
    names: list
    losses: list  # every 50th epoch's loss


def fne_plane(edges: Sequence[tuple], neg_alpha: float):
    """(node names, dense symmetric adjacency [N, N] f32, negative
    marginal q [N] f32) of an edge list `(src, dst[, weight])`."""
    names: dict = {}
    src, dst, w = [], [], []
    for e in edges:
        a, b = e[0], e[1]
        wt = float(e[2]) if len(e) > 2 else 1.0
        src.append(names.setdefault(a, len(names)))
        dst.append(names.setdefault(b, len(names)))
        w.append(wt)
    n = len(names)
    adj = sp.coo_matrix((w, (src, dst)), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    q = np.asarray(adj.sum(0)).ravel() ** neg_alpha
    q = (q / max(q.sum(), 1e-30)).astype(np.float32)
    inv = [None] * n
    for k, v in names.items():
        inv[v] = k
    return inv, np.asarray(adj.todense(), np.float32), q


def fit_fne(
    edges: Sequence[tuple],  # (src, dst[, weight]) node names or indices
    *,
    embedding_dim: int = 32,
    epochs: int = 500,
    learning_rate: float = 0.05,
    n_negatives: float = 5.0,
    neg_alpha: float = 0.75,
    seed: int = 0,
    device="cuda",
) -> FneResult:
    names, plane, q_np = fne_plane(edges, neg_alpha)
    n = len(names)
    c = torch.from_numpy(plane).to(device)
    q = torch.from_numpy(q_np).to(device)
    m = c.sum(dim=1)
    total = torch.clamp_min(c.sum(), 1.0)

    e0 = np.float32(0.1) * prng.normal(prng.key(seed), (n, embedding_dim))
    theta = torch.from_numpy(
        np.concatenate([e0.ravel(), np.zeros(n, np.float32)])).to(device)
    e = theta[: n * embedding_dim].view(n, embedding_dim)
    b = theta[n * embedding_dim :]
    opt = _Adam(theta, learning_rate)
    losses = torch.empty(epochs, dtype=torch.float32, device=device)
    for ep in range(epochs):
        loss, g_ef, g_bf, g_ea, g_ba = nce_epoch_grads(
            e, b, e, b, c, q, m, k_neg=n_negatives, total=total)
        losses[ep] = loss
        opt.step(torch.cat([(g_ea + g_ef).reshape(-1), g_ba + g_bf]))
    return FneResult(
        embedding=e.cpu().numpy(),
        bias=b.cpu().numpy(),
        names=names,
        losses=losses[::50].cpu().numpy().astype(np.float64).tolist(),
    )
