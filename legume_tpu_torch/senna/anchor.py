"""Data-driven anchor-based beta prior for topic models (the port's copy
of the JAX package's `senna/anchor.py`, numpy only).

Archetypal pseudobulks ("anchors") are picked by greedy Gram-Schmidt
vertex selection on z-scored log1p pseudobulk profiles (Arora-style);
each anchor PB becomes a `[D, 1]` gene-simplex column used (a) to
initialize the decoder dictionary logits and (b) as an optional
cross-entropy penalty target during training (cmd.rs:468-476).

The Gram-Schmidt pass is a handful of [P, D] matvecs, tiny at
pseudobulk resolution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def zscore_columns(x_pg: np.ndarray) -> np.ndarray:
    """Per-column (feature) z-score across rows (anchor_common.rs:42)."""
    x = np.asarray(x_pg, np.float64)
    if x.shape[0] < 2:
        return x.copy()
    mean = x.mean(0, keepdims=True)
    sd = x.std(0, keepdims=True)
    out = np.where(sd > 1e-8, (x - mean) / np.maximum(sd, 1e-8), 0.0)
    return out


def gram_schmidt_anchors(x_pg: np.ndarray, k: int) -> list[int]:
    """Greedy Gram-Schmidt vertex selection: k row indices maximizing
    residual norm at each pick, with picked rows projected out of all
    remaining rows (anchor_common.rs:71)."""
    x = np.asarray(x_pg, np.float64)
    n = x.shape[0]
    k = min(k, n)
    residual = x.copy()
    picked: list[int] = []
    taken = np.zeros(n, bool)
    for _ in range(k):
        norms = np.einsum("pg,pg->p", residual, residual)
        norms[taken] = -np.inf
        best = int(np.argmax(norms))
        picked.append(best)
        taken[best] = True
        v = residual[best]
        nv = np.linalg.norm(v)
        if nv <= 1e-12:
            # remaining rows are in the picked span; fill with unpicked
            for j in range(n):
                if not taken[j] and len(picked) < k:
                    picked.append(j)
                    taken[j] = True
            break
        v = v / nv
        residual = residual - np.outer(residual @ v, v)
    return picked


def _softmax_col(v: np.ndarray) -> np.ndarray:
    e = np.exp(v - v.max())
    return e / max(e.sum(), 1e-30)


@dataclass
class AnchorPrior:
    """[D_full, K] prior, each column on the gene simplex."""

    anchor_weight_gk: np.ndarray
    anchor_pb_idx: np.ndarray

    @classmethod
    def from_pseudobulk(
        cls,
        mu_gp: np.ndarray,  # [D_full, P] preferred posterior mean
        n_topics: int,
        finest_coarsening=None,
    ) -> "AnchorPrior":
        """Anchor SELECTION runs in the (possibly coarsened) feature
        space the encoder sees; the stored prior stays at D_full so
        every level's own coarsening can aggregate it independently
        (anchor_prior.rs:46-57)."""
        mu_gp = np.asarray(mu_gp, np.float64)
        d_full, n_pb = mu_gp.shape
        if n_pb < 2:
            raise ValueError(f"anchor prior needs >=2 pseudobulks, got {n_pb}")
        x_gp = np.log1p(np.maximum(mu_gp, 0.0))
        x_sel_pd = (
            finest_coarsening.aggregate_rows_ds(x_gp).T
            if finest_coarsening is not None
            else x_gp.T
        )
        idx = gram_schmidt_anchors(zscore_columns(x_sel_pd), min(n_topics, n_pb))
        weight = np.stack([_softmax_col(x_gp[:, pb]) for pb in idx], axis=1)
        return cls(
            anchor_weight_gk=weight.astype(np.float32),
            anchor_pb_idx=np.asarray(idx, np.int64),
        )

    def per_level_weights(self, level_coarsenings) -> list[np.ndarray]:
        """Per-level [K, D_l] anchor simplex targets, pre-transposed for
        element-wise use against decoder log beta [K, D_l]
        (anchor_prior.rs per_level_device_tensors)."""
        out = []
        for fc in level_coarsenings:
            w = (
                fc.aggregate_rows_ds(self.anchor_weight_gk)
                if fc is not None
                else self.anchor_weight_gk
            )
            # renormalize columns after aggregation (sums preserved but
            # numeric drift possible), then transpose to [K, D_l]
            w = w / np.maximum(w.sum(0, keepdims=True), 1e-30)
            out.append(w.T.astype(np.float32))
        return out

    def init_logits(self, level_coarsening=None, eps: float = 1e-8) -> np.ndarray:
        """[K, D_l] dictionary-logit initialization: log of the anchor
        simplex (softmax of these logits reproduces the prior)."""
        w = (
            level_coarsening.aggregate_rows_ds(self.anchor_weight_gk)
            if level_coarsening is not None
            else self.anchor_weight_gk
        )
        w = w / np.maximum(w.sum(0, keepdims=True), 1e-30)
        return np.log(w.T + eps).astype(np.float32)
