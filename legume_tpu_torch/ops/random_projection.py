"""Streaming Johnson-Lindenstrauss projection of all cells and the
binary sort (the port of the JAX package's `ops/random_projection.py`).

1. per block: log1p, per-cell L2 normalisation and the basis product in
   one pass — kernel K1 (`kernels.project(normed=True)`) on the card;
2. optional batch centering of every projection dim within each batch;
3. per-cell standardisation over the K dims, clamp to [-4, 4], and a
   second standardisation if the clamp fired.

Binary sort: rSVD of the projection, z-score of the right vectors per
dim, sign bits, group codes in [0, 2^kk). The basis and the rSVD sketch
are the JAX package's threefry draws for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.visitors import visit_columns_by_block
from ..utils import prng
from ..utils.prng import DEFAULT_PROJECTION_SEED
from . import kernels
from .rsvd import rsvd


def block_to_device(blk, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row_ids int32, col_ptr int32, vals f32) of a block on `device`."""
    return (
        torch.from_numpy(blk.row_ids).to(device, non_blocking=True),
        torch.from_numpy(blk.col_ptr).to(device, non_blocking=True),
        torch.from_numpy(blk.vals).to(device, non_blocking=True),
    )


def projection_basis(d: int, target_dim: int, seed: int, row_weights=None) -> np.ndarray:
    """The seeded standard-normal basis [D, K], rows gated by weights."""
    basis = prng.normal(prng.key_from_seed(seed), (d, target_dim))
    if row_weights is not None:
        basis = basis * np.asarray(row_weights, np.float32)[:, None]
    return basis


def _standardize_cells(proj_nk: torch.Tensor) -> torch.Tensor:
    """Per-cell z-score over the K dims, clamp to [-4, 4], and z-score
    again when the clamp fired."""

    def zscore(p):
        mu = p.mean(dim=1, keepdim=True)
        sig = torch.sqrt(torch.clamp((p * p).mean(dim=1, keepdim=True) - mu * mu, min=0.0))
        return torch.where(sig > 0, (p - mu) / torch.where(sig > 0, sig, 1.0), p - mu)

    z = zscore(proj_nk)
    if bool((z.max() > 4.0) | (z.min() < -4.0)):
        z = zscore(torch.clamp(z, -4.0, 4.0))
    return z


def project_columns(
    data,
    target_dim: int,
    *,
    block_size: int = 8192,
    batch_membership: np.ndarray | None = None,
    row_weights: np.ndarray | None = None,
    seed: int = DEFAULT_PROJECTION_SEED,
    raw: bool = False,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Returns `(basis_dk [D, K], proj_kn [K, N])` as numpy. `raw=True`
    returns `(basis_dk, proj_nk [N, K])` before the batch centering and
    the standardisation: a rank projects its own cells raw, and
    `finish_projection` runs on the cells of every rank gathered."""
    basis_np = projection_basis(data.num_rows, target_dim, seed, row_weights)
    basis = torch.from_numpy(basis_np).to(device)
    pieces = [
        kernels.project(basis, *block_to_device(blk, device), normed=True)
        for blk in visit_columns_by_block(data, block_size=block_size)
    ]
    proj_nk = (
        torch.cat(pieces).cpu().numpy()
        if pieces
        else np.zeros((0, target_dim), np.float32)
    )
    if raw:
        return basis_np, proj_nk
    return finish_projection(basis_np, proj_nk, batch_membership, device=device)


def finish_projection(basis_dk, proj_nk, batch_membership=None, *, device="cuda"):
    """Batch centering (host, as the JAX package does) and per-cell
    standardisation (device) of the raw [N, K] projection."""
    proj_nk = np.array(proj_nk, np.float32)
    if batch_membership is not None and len(batch_membership) == proj_nk.shape[0]:
        codes = np.asarray(batch_membership)
        for b in np.unique(codes):
            m = codes == b
            proj_nk[m] -= proj_nk[m].mean(axis=0, keepdims=True)
    z = _standardize_cells(torch.from_numpy(proj_nk).to(device)).cpu().numpy()
    return np.asarray(basis_dk), z.T.copy()


def binary_sort_columns(
    proj_kn: np.ndarray, kk: int, *, seed: int = DEFAULT_PROJECTION_SEED, device="cuda"
) -> np.ndarray:
    """Group codes in [0, 2^kk) from rSVD sign bits."""
    kk = min(kk, proj_kn.shape[0], proj_kn.shape[1])
    x = torch.from_numpy(np.ascontiguousarray(proj_kn, np.float32)).to(device)
    _, _, vt = rsvd(x, kk, key=prng.key_from_seed(seed, 17))
    q_nk = vt.T  # [N, kk] right singular vectors
    q_nk = (q_nk - q_nk.mean(axis=0)) / np.maximum(q_nk.std(axis=0), 1e-12)
    bits = (q_nk > 0).astype(np.int64)
    return (bits << np.arange(kk)[None, :]).sum(axis=1)


def compact_group_codes(codes: np.ndarray) -> tuple[np.ndarray, int]:
    """Relabel arbitrary codes to dense [0, S) group ids."""
    uniq, groups = np.unique(codes, return_inverse=True)
    return groups.astype(np.int32), len(uniq)
