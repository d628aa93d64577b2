"""`pinto lra`: directional ligand->receptor activity (the port of the
JAX package's `pinto/lra.py`; host numpy, as there, but for the kNN).

For each LR pair and the spatial kNN edge set E:

    activity(L -> R) = mean_{(i,j) in E} x_L(i) * x_R(j)

tested against a gene-swap null: the ligand is replaced by random
genes MATCHED on (mean expression, Moran's I spatial autocorrelation)
— the matching removes the trivial "both genes abundant and spatially
clumped" confound the reference's null is built for. Activities are
dense gather/segment ops on device; Moran's I is one sparse quadratic
form per gene, computed for all genes in a single [D-batched] pass.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

log = logging.getLogger(__name__)


def morans_i(x_nd: np.ndarray, w: sp.spmatrix) -> np.ndarray:
    """Moran's I per column of [N, D] against spatial weights W."""
    w = sp.csr_matrix(w)
    s0 = w.sum()
    n = x_nd.shape[0]
    xc = x_nd - x_nd.mean(0, keepdims=True)
    num = np.einsum("nd,nd->d", xc, w @ xc)
    den = np.maximum((xc * xc).sum(0), 1e-12)
    return (n / max(s0, 1e-12)) * num / den


@dataclass
class LraResult:
    ligand: list
    receptor: list
    activity: np.ndarray
    pvalue: np.ndarray
    null_mean: np.ndarray


def run_lra(
    expr_nd: np.ndarray,  # [N, D] per-cell expression (e.g. log1p counts)
    gene_names: list,
    coords: np.ndarray,
    lr_pairs: list,  # [(ligand, receptor), ...]
    *,
    knn: int = 8,
    n_null: int = 200,
    n_bins: int = 5,
    seed: int = 0,
    device="cuda",
) -> LraResult:
    from .lc import spatial_knn_edges

    rng = np.random.default_rng(seed)
    n, d = expr_nd.shape
    name_to_idx = {str(g): i for i, g in enumerate(gene_names)}

    edges = spatial_knn_edges(coords, knn, device=device)
    src, dst = edges[:, 0], edges[:, 1]
    # directional: include both orientations of each undirected edge
    src_d = np.concatenate([src, dst])
    dst_d = np.concatenate([dst, src])

    # per-gene matching features: mean + Moran's I, jointly binned
    w = sp.csr_matrix(
        (np.ones(len(src_d)), (src_d, dst_d)), shape=(n, n)
    )
    mean_g = expr_nd.mean(0)
    moran_g = morans_i(expr_nd, w)

    def bin_ids(v):
        qs = np.quantile(v, np.linspace(0, 1, n_bins + 1)[1:-1])
        return np.searchsorted(qs, v)

    joint_bin = bin_ids(mean_g) * n_bins + bin_ids(moran_g)
    bins: dict[int, np.ndarray] = {
        b: np.nonzero(joint_bin == b)[0] for b in np.unique(joint_bin)
    }

    def pair_activity(li, ri):
        return float(np.mean(expr_nd[src_d, li] * expr_nd[dst_d, ri]))

    ligs, recs, acts, pvals, null_means = [], [], [], [], []
    for lig, rec in lr_pairs:
        li, ri = name_to_idx.get(str(lig)), name_to_idx.get(str(rec))
        if li is None or ri is None:
            continue
        obs = pair_activity(li, ri)
        pool = bins.get(joint_bin[li], np.arange(d))
        pool = pool[(pool != li) & (pool != ri)]  # never swap in the pair itself
        if len(pool) < 10:
            # degenerate bin: widen to mean-matched only
            pool = np.nonzero(bin_ids(mean_g) == bin_ids(mean_g)[li])[0]
            pool = pool[(pool != li) & (pool != ri)]
        if len(pool) == 0:
            pool = np.setdiff1d(np.arange(d), [li, ri])
        swaps = rng.choice(pool, size=min(n_null, len(pool)), replace=len(pool) < n_null)
        null = np.asarray([pair_activity(s, ri) for s in swaps])
        p = (1 + np.sum(null >= obs)) / (1 + len(null))
        ligs.append(lig)
        recs.append(rec)
        acts.append(obs)
        pvals.append(p)
        null_means.append(null.mean())

    return LraResult(
        ligand=ligs,
        receptor=recs,
        activity=np.asarray(acts),
        pvalue=np.asarray(pvals),
        null_mean=np.asarray(null_means),
    )
