"""`senna impute` + `senna probe --train-latent` (the port of the JAX
package's `senna/impute.py`).

- impute: kNN-over-latent count imputation (`senna/src/main.rs` Apply
  group): each cell's imputed profile is the distance-weighted average
  of its latent-space neighbours' observed counts (self mode), or of its
  nearest reference cells' counts (`impute_from_reference`).
- probe: drift/novelty verdict for held-out data against a trained
  model's latent — the held-out latent distribution against the
  training reference.

The kNN and the self-mode averages run on `device` (default `cuda`); the
kNN is float64 (`ops/knn.py`), where the JAX package's is float32.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..data.visitors import csc_to_coo_block
from ..ops import sparse as sparse_ops
from ..ops.knn import knn_search

log = logging.getLogger(__name__)


@torch.no_grad()
def impute_counts(
    data,
    latent: np.ndarray,  # [N, K]
    *,
    knn: int = 15,
    cell_block: int = 2048,
    device="cuda",
) -> np.ndarray:
    """[N, D] imputed profiles: softmax(-distance)-weighted neighbour
    averages of observed counts, self excluded."""
    n, d = data.num_columns, data.num_rows
    dist, idx = knn_search(latent, latent, knn, exclude_self_offset=0, device=device)
    knn = idx.shape[1]
    w = np.exp(-(dist - dist.min(1, keepdims=True)))
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-30)
    w_t = torch.from_numpy(w.astype(np.float32)).to(device)

    out = np.zeros((n, d), np.float32)
    for lb in range(0, n, cell_block):
        ub = min(lb + cell_block, n)
        c = ub - lb
        blk = csc_to_coo_block(data.read_columns_csc(idx[lb:ub].reshape(-1)))
        dense = sparse_ops.densify_block(
            torch.from_numpy(blk.row_ids).to(device), torch.from_numpy(blk.col_ids).to(device),
            torch.from_numpy(blk.vals).to(device), ncols=c * knn, num_genes=d,
        ).reshape(c, knn, d)
        out[lb:ub] = torch.einsum("ck,ckd->cd", w_t[lb:ub], dense).cpu().numpy()
    return out


def dist_to_softmax_weights(dist: np.ndarray, temperature: float) -> np.ndarray:
    """kNN L2 distances [N, K] -> per-row weight simplex
    w ~ exp(-d^2 / (2 tau^2)) (impute.rs:289 dist_to_softmax_weights)."""
    tau = max(float(temperature), 1e-6)
    v = -(dist.astype(np.float64) ** 2) / (2.0 * tau * tau)
    v -= v.max(1, keepdims=True)
    w = np.exp(v)
    return (w / np.maximum(w.sum(1, keepdims=True), 1e-300)).astype(np.float32)


def impute_from_reference(
    query_latent: np.ndarray,  # [N_new, K] (linear or log; exp'd if log)
    reference_latent: np.ndarray,  # [N_ref, K]
    reference_data,  # backend/vec with the reference's FULL features
    *,
    knn: int = 10,
    knn_temperature: float = 1.0,
    cell_block: int = 4096,
    device="cuda",
) -> np.ndarray:
    """Reference-based kNN imputation (impute.rs:1-22 pipeline): each
    query cell finds its K nearest REFERENCE cells in latent space,
    converts L2 distances to exp(-d^2/2tau^2) softmax weights, and
    averages the neighbours' full-feature counts. Returns
    [N_new, D_ref]. Streamed as imputed += W[:, chunk] @ chunk_counts^T
    over reference column chunks (chunks no query consumes are
    skipped, impute.rs:244-249)."""
    n_ref = reference_data.num_columns
    d_ref = reference_data.num_rows
    if reference_latent.shape[0] != n_ref:
        raise ValueError(
            f"reference latent rows ({reference_latent.shape[0]}) != "
            f"reference data columns ({n_ref})"
        )
    dist, idx = knn_search(query_latent, reference_latent, knn, device=device)
    knn = idx.shape[1]
    w = dist_to_softmax_weights(dist, knn_temperature)

    n_new = query_latent.shape[0]
    rows = np.repeat(np.arange(n_new, dtype=np.int64), knn)
    w_mat = sp.csc_matrix(
        (w.reshape(-1), (rows, idx.reshape(-1).astype(np.int64))),
        shape=(n_new, n_ref),
    )
    touched = np.diff(w_mat.indptr) > 0  # per-ref-cell consumer flag

    imputed = np.zeros((n_new, d_ref), np.float32)
    for lb in range(0, n_ref, cell_block):
        ub = min(lb + cell_block, n_ref)
        if not touched[lb:ub].any():
            continue
        chunk = reference_data.read_columns_csc(np.arange(lb, ub))  # [D, c]
        imputed += np.asarray((w_mat[:, lb:ub] @ chunk.T.tocsr()).todense(), np.float32)
    return imputed


@dataclass
class ProbeVerdict:
    drift_score: float  # mean shift of latent centroid (z-units)
    novelty_frac: float  # fraction of cells beyond the training envelope
    verdict: str  # ok | drift | novel


def probe_latent(
    train_latent: np.ndarray, heldout_latent: np.ndarray, *, novelty_q: float = 0.99
) -> ProbeVerdict:
    """Drift/novelty verdict (`senna probe`)."""
    mu = train_latent.mean(0)
    sd = np.maximum(train_latent.std(0), 1e-8)
    drift = float(np.abs((heldout_latent.mean(0) - mu) / sd).mean())

    d_train = np.linalg.norm((train_latent - mu) / sd, axis=1)
    thr = np.quantile(d_train, novelty_q)
    d_new = np.linalg.norm((heldout_latent - mu) / sd, axis=1)
    novelty = float((d_new > thr).mean())

    verdict = "ok"
    if drift > 1.0:
        verdict = "drift"
    if novelty > 0.25:
        verdict = "novel"
    return ProbeVerdict(drift_score=drift, novelty_frac=novelty, verdict=verdict)
