"""Degree-corrected Poisson cluster refinement (the port of the JAX
package's `ops/dc_poisson.py`).

Score of placing entity e in block k:

    s(e, k) = sum_g y_eg log(gene_sum[k, g] + eps)
              - size_e log(size_sum[k] + M eps)

Each Jacobi sweep refreshes the block statistics from the current
labels, scores every entity against every block, and Gumbel-samples
(Gibbs) or takes the argmax (greedy) among the entity's candidate
blocks. The Gumbel draws are the JAX package's threefry draws for the
same seed, so the refined labels match.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import prng

LOG_EPS = 1e-8


def _dc_sweep(
    gumbel: torch.Tensor | None,  # [E, K] noise, None = greedy
    row_e: torch.Tensor,  # [nnz] entity of each nonzero
    col_g: torch.Tensor,  # [nnz] feature
    vals: torch.Tensor,
    size_e: torch.Tensor,  # [E]
    labels: torch.Tensor,  # [E]
    cand_mask: torch.Tensor,  # [E, K] bool
    *,
    k: int,
    n_features: int,
):
    dev = vals.device
    flat = labels[row_e] * n_features + col_g
    gene_sum = torch.zeros(k * n_features, dtype=torch.float32, device=dev)
    gene_sum = gene_sum.index_add_(0, flat, vals).view(k, n_features)
    size_sum = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(0, labels, size_e)

    log_gene = torch.log(gene_sum + LOG_EPS)  # [K, M]
    log_size = -torch.log(size_sum + n_features * LOG_EPS)  # [K]

    contrib = log_gene.T[col_g] * vals[:, None]  # [nnz, K]
    scores = torch.zeros(size_e.shape[0], k, dtype=torch.float32, device=dev)
    scores = scores.index_add_(0, row_e, contrib)
    scores = scores + size_e[:, None] * log_size[None, :]
    scores = scores.masked_fill(~cand_mask, -torch.inf)
    new = torch.argmax(scores if gumbel is None else scores + gumbel, dim=1)
    return new, scores


@dataclass
class RefineResult:
    labels: np.ndarray
    n_moves_per_sweep: list
    score_trace: list


def refine_with_candidates(
    profiles: sp.spmatrix,  # [E, M] entity x feature counts
    labels: np.ndarray,
    k: int,
    *,
    candidates: np.ndarray | None = None,  # [E, K] bool, None = all
    size_factors: np.ndarray | None = None,
    num_gibbs: int = 10,
    num_greedy: int = 5,
    seed: int = 0,
    device="cuda",
) -> RefineResult:
    """Refine entity block labels (Jacobi schedule)."""
    coo = sp.coo_matrix(profiles)
    e, m = coo.shape
    row = torch.as_tensor(coo.row.astype(np.int64), device=device)
    col = torch.as_tensor(coo.col.astype(np.int64), device=device)
    vals = torch.as_tensor(coo.data.astype(np.float32), device=device)
    if size_factors is None:
        size_factors = np.asarray(profiles.sum(1)).ravel()
    size = torch.as_tensor(np.asarray(size_factors, np.float32), device=device)
    cand = (
        torch.as_tensor(np.asarray(candidates, bool), device=device)
        if candidates is not None
        else torch.ones(e, k, dtype=torch.bool, device=device)
    )
    lab = torch.as_tensor(np.asarray(labels, np.int64), device=device)
    key = prng.key(seed)
    moves, trace = [], []
    for sweep in range(num_gibbs + num_greedy):
        key, ks = prng.split(key)
        noise = None
        if sweep < num_gibbs:
            noise = torch.from_numpy(prng.gumbel(ks, (e, k))).to(device)
        new, scores = _dc_sweep(
            noise, row, col, vals, size, lab, cand, k=k, n_features=m
        )
        moves.append(int((new != lab).sum()))
        chosen = torch.gather(scores, 1, new[:, None])
        trace.append(float(torch.where(torch.isfinite(chosen), chosen, 0.0).sum()))
        lab = new
        if sweep >= num_gibbs and moves[-1] == 0:
            break
    return RefineResult(
        labels=lab.cpu().numpy().astype(np.int32), n_moves_per_sweep=moves, score_trace=trace
    )
