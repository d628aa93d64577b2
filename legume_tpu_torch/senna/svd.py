"""`senna svd` and `senna joint-svd`: streaming Nyström randomized SVD
embeddings (the port of the JAX package's `senna/svd.py`).

The spectral basis is fitted on the (batch-adjusted) pseudobulk matrix,
small and dense on the device; then every cell streams through it:
`f_cell = U^T log1p(x_cell)`, one block at a time through kernel K2
(`kernels.project(normed=False)`) on the card. The JAX package forms
that product outside Pallas (`ops/sparse.py::project_block`); it is
exactly K2's. Runs on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..data.visitors import visit_columns_by_block
from ..ops import collapse as clp
from ..ops import kernels
from ..ops import random_projection as rp
from ..ops import sparse as sparse_ops
from ..ops.rsvd import rsvd
from ..utils.manifest import RunManifest
from ..utils.output import matrix_columns, write_table
from ..utils.prng import DEFAULT_PROJECTION_SEED, key_from_seed
from .topic import TopicArgs, load_and_collapse, load_data_vec

log = logging.getLogger(__name__)


@dataclass
class SvdArgs:
    """The JAX package's `SvdArgs`, same names and defaults."""

    data_files: Sequence[str] = ()
    out: str = "svd"
    batch_files: Optional[Sequence[str]] = None
    n_factors: int = 20
    proj_dim: int = 50
    sort_dim: int = 10
    knn_cells: int = 10
    iter_opt: int = 30
    block_size: int = 8192
    # normalise each cell to this total before log1p (0 = off)
    column_sum_norm: float = 0.0
    # write the batch-adjusted counts to {out}.adjusted.zarr
    save_adjusted: bool = False
    qc: bool = False
    qc_min_total: float = 0.0
    qc_min_genes: int = 0
    qc_max_mito_frac: float = 1.0
    # the basis on the top-N HVGs only (0 = all genes)
    hvg_genes: int = 0
    cnv: bool = False
    cnv_genes_per_bin: int = 25
    seed: int = DEFAULT_PROJECTION_SEED
    data_parallel: bool = False


def project_cells(vec, basis_dk: np.ndarray, *, block_size: int, column_sum_norm: float = 0.0,
                  device="cuda") -> np.ndarray:
    """[N, K] per-cell factors `U^T log1p(x)` through K2, each cell scaled
    to `column_sum_norm` total first when that is positive."""
    basis = torch.from_numpy(np.ascontiguousarray(basis_dk, np.float32)).to(device)
    pieces = []
    for blk in visit_columns_by_block(vec, block_size=block_size):
        rows, ptr, vals = rp.block_to_device(blk, device)
        if column_sum_norm > 0:
            cols = sparse_ops.col_ids_from_ptr(ptr)
            csums = sparse_ops.block_col_sums(cols, vals, ncols=blk.ncols)
            vals = vals * (column_sum_norm / torch.clamp(csums, min=1e-12))[cols]
        pieces.append(kernels.project(basis, rows, ptr, torch.log1p(vals), normed=False))
    if not pieces:
        return np.zeros((0, basis_dk.shape[1]), np.float32)
    return torch.cat(pieces).cpu().numpy()


def adjusted_csc(vec, plane_dp: np.ndarray, groups: np.ndarray, *, block_size: int = 8192,
                 device="cuda") -> sp.csc_matrix:
    """Batch-adjusted counts: per cell j in pseudobulk group p,
    x_dj / (plane[d, p] l_j) with l_j = sum x / sum plane over x's support
    (1 where that plane sum is 0); entries whose denominator is 0 pass
    through."""
    plane = torch.from_numpy(np.ascontiguousarray(plane_dp, np.float32)).to(device)
    grp = torch.from_numpy(np.asarray(groups, np.int64)).to(device)
    n = vec.num_columns
    blocks = []
    for lb in range(0, n, block_size):
        ub = min(lb + block_size, n)
        csc = sp.csc_matrix(vec.read_columns_csc(np.arange(lb, ub)))
        x = torch.from_numpy(csc.data.astype(np.float32)).to(device)
        cols = torch.from_numpy(np.repeat(np.arange(ub - lb), np.diff(csc.indptr))).to(device)
        mu = plane[torch.from_numpy(csc.indices.astype(np.int64)).to(device), grp[lb + cols]]
        mu_sum = torch.zeros(ub - lb, dtype=torch.float64, device=device).index_add_(0, cols, mu.double())
        x_sum = torch.zeros_like(mu_sum).index_add_(0, cols, x.double())
        lam = torch.where(mu_sum > 0, x_sum / torch.where(mu_sum > 0, mu_sum, 1.0), 1.0).float()
        denom = mu * lam[cols]
        data = torch.where(denom > 0, x / torch.clamp(denom, min=1e-30), x)
        blocks.append(sp.csc_matrix((data.cpu().numpy(), csc.indices.copy(), csc.indptr.copy()),
                                    shape=csc.shape))
    return sp.hstack(blocks, format="csc") if blocks else sp.csc_matrix((vec.num_rows, 0))


def fit_svd(args: SvdArgs, *, vec=None, device="cuda") -> dict:
    """End-to-end `senna svd`; `vec` overrides `args.data_files`."""
    if args.data_parallel:
        raise NotImplementedError("senna svd port does not support --data-parallel yet")
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if vec is None:
        vec = load_data_vec(args.data_files, args.batch_files)
    if args.qc:
        from ..data.qc import compute_cell_qc

        stats = compute_cell_qc(vec, block_size=args.block_size, device=device)
        keep = stats.keep_mask(min_total=args.qc_min_total, min_genes=args.qc_min_genes,
                               max_mito_frac=args.qc_max_mito_frac)
        log.info("svd qc: keeping %d/%d cells", int(keep.sum()), vec.num_columns)
        vec = vec.subset_columns(keep)
    targs = TopicArgs(
        data_files=args.data_files, proj_dim=args.proj_dim, sort_dim=args.sort_dim,
        knn_cells=args.knn_cells, num_levels=1, iter_opt=args.iter_opt,
        block_size=args.block_size, seed=args.seed,
    )
    levels = load_and_collapse(vec, targs, timings=timings, device=device)
    finest = levels.collapsed[0]
    groups = levels.groups_per_level[0]
    mu = finest.mu_adjusted if finest.mu_adjusted is not None else finest.mu_observed
    pb_dp = mu.mean().cpu().numpy()  # [D, P]

    t0 = time.time()
    hvg_mask = None
    if args.hvg_genes and args.hvg_genes < vec.num_rows:
        from ..ops.gene_stats import hvg_row_weights

        hvg_mask = hvg_row_weights(vec, args.hvg_genes, block_size=args.block_size,
                                   device=device) > 0
    pb_basis = pb_dp if hvg_mask is None else pb_dp[hvg_mask]
    if args.column_sum_norm > 0:
        csum = pb_basis.sum(0, keepdims=True)
        pb_basis = pb_basis * (np.float32(args.column_sum_norm) / np.maximum(csum, np.float32(1e-12)))
    x = torch.log1p(torch.from_numpy(np.ascontiguousarray(pb_basis, np.float32)).to(device))
    k = min(args.n_factors, min(x.shape) - 1)
    u_h, s, _ = rsvd(x, k, key=key_from_seed(args.seed, 23))
    if hvg_mask is None:
        u = np.asarray(u_h, np.float32)
    else:
        u = np.zeros((vec.num_rows, k), np.float32)
        u[hvg_mask] = u_h
    timings["basis_s"] = time.time() - t0

    t0 = time.time()
    factors = project_cells(vec, u, block_size=args.block_size,
                            column_sum_norm=args.column_sum_norm, device=device)
    timings["project_s"] = time.time() - t0

    outputs = {}
    if args.save_adjusted:
        from ..data.sparse_io import create_sparse_from_csc

        t0 = time.time()
        plane = finest.mu_residual if finest.mu_residual is not None else finest.mu_observed
        adjusted = adjusted_csc(vec, plane.mean().cpu().numpy(), groups,
                                block_size=args.block_size, device=device)
        outputs["adjusted"] = f"{args.out}.adjusted.zarr"
        create_sparse_from_csc(adjusted, outputs["adjusted"], vec.row_names(), vec.column_names())
        log.info("wrote adjusted backend %s (%d nnz)", outputs["adjusted"], adjusted.nnz)
        timings["adjusted_s"] = time.time() - t0
    if args.cnv:
        from ..cocoa.cnv_call import call_cnv_on_residuals

        t0 = time.time()
        cnv = call_cnv_on_residuals(pb_dp, pb_dp.mean(1), genes_per_bin=args.cnv_genes_per_bin,
                                    device=device)
        n_pb, n_bins = cnv.states.shape
        outputs["cnv"] = write_table(f"{args.out}.cnv", {
            "pseudobulk": np.repeat(np.arange(n_pb), n_bins),
            "bin": np.tile(np.arange(n_bins), n_pb),
            "state": cnv.states.ravel(),
            "log_ratio": cnv.log_ratio.ravel(),
        })
        timings["cnv_s"] = time.time() - t0

    t0 = time.time()
    outputs["latent"] = write_table(f"{args.out}.latent",
                                    matrix_columns(factors, "f", "cell", vec.column_names()))
    outputs["dictionary"] = write_table(f"{args.out}.dictionary",
                                        matrix_columns(u, "f", "gene", np.asarray(vec.row_names())))
    outputs["singular_values"] = write_table(f"{args.out}.singular_values",
                                             {"singular_value": np.asarray(s, np.float32)})
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    RunManifest(
        command="svd", inputs={"data_files": list(args.data_files)},
        outputs={key: outputs[key] for key in ("latent", "dictionary")},
        params=dataclasses.asdict(args), timings=timings, engine="legume-tpu-torch",
    ).save(args.out)
    return {"factors": factors, "basis": u, "singular_values": np.asarray(s), "levels": levels,
            "pb_dp": pb_dp, "timings": timings}


def fit_joint_svd(
    modality_files: Sequence[Sequence[str]],
    out: str,
    *,
    n_factors: int = 20,
    proj_dim: int = 50,
    sort_dim: int = 10,
    iter_opt: int = 30,
    block_size: int = 8192,
    seed: int = DEFAULT_PROJECTION_SEED,
    vecs=None,
    device="cuda",
) -> dict:
    """`senna joint-svd`: modalities sharing cells -> shared pseudobulk
    groups from the first modality's projection (K1) -> per modality the
    collapse (K3) and log1p pseudobulk means, concatenated on the feature
    axis -> one rSVD; each cell's factors sum its modalities' slices of
    the basis through K2. `vecs` overrides `modality_files`."""
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if vecs is None:
        vecs = [load_data_vec(list(files)) for files in modality_files]
    n = vecs[0].num_columns
    if any(v.num_columns != n for v in vecs[1:]):
        raise ValueError("joint-svd modalities must share cells")

    t0 = time.time()
    _, proj = rp.project_columns(vecs[0], proj_dim, block_size=block_size, seed=seed, device=device)
    codes = rp.binary_sort_columns(proj, sort_dim, seed=seed, device=device)
    groups, s_groups = rp.compact_group_codes(codes)
    timings["projection_sort_s"] = time.time() - t0

    t0 = time.time()
    pbs = []
    for v in vecs:
        stat = clp.collect_basic_stats(v, groups, s_groups, block_size=block_size, device=device)
        o = clp.optimize(stat, num_iter=iter_opt, device=device)
        pbs.append(torch.log1p(o.mu_observed.mean()))  # [D_m, P]
    concat = torch.cat(pbs, dim=0)
    timings["collapse_s"] = time.time() - t0

    t0 = time.time()
    k = min(n_factors, min(concat.shape) - 1)
    u, s, _ = rsvd(concat.float(), k, key=key_from_seed(seed, 29))
    u = np.asarray(u, np.float32)  # [sum D, k]
    timings["basis_s"] = time.time() - t0

    t0 = time.time()
    factors = np.zeros((n, k), np.float32)
    off = 0
    for v in vecs:
        factors += project_cells(v, u[off : off + v.num_rows], block_size=block_size, device=device)
        off += v.num_rows
    timings["project_s"] = time.time() - t0

    feature = [f"m{m}:{g}" for m, v in enumerate(vecs) for g in v.row_names()]
    outputs = {
        "latent": write_table(f"{out}.latent",
                              matrix_columns(factors, "f", "cell", vecs[0].column_names())),
        "dictionary": write_table(f"{out}.dictionary",
                                  matrix_columns(u, "f", "feature", np.asarray(feature))),
    }
    timings["total_s"] = time.time() - t_all
    RunManifest(
        command="joint-svd", inputs={"modalities": [list(f) for f in modality_files]},
        outputs={"latent": outputs["latent"]}, timings=timings, engine="legume-tpu-torch",
    ).save(out)
    return {"factors": factors, "basis": u, "singular_values": np.asarray(s), "timings": timings}
