"""`senna bge`: the count-NCE joint embedding end to end (the port of the
JAX package's `cli/senna_cmds/embed_cmds.py::_cmd_bge`).

1. load backends into a `SparseIoVec`;
2. streaming JL projection (kernel K1 on the card) and the binary sort
   into pseudobulk groups (split by batch when there is more than one);
3. pseudobulk sums (kernel K3 on the card);
4. `fit_bge`: phase 1 on the pseudobulk plane and phase 2 per cell
   (kernel K4 on the card for a dense, unstratified marginal);
5. unless `skip_etm`: one Leiden clustering of the cell embedding (host)
   seeds the SIMBA co-embed of the genes and the cluster-seeded ETM
   layout (device);
6. outputs: latent, feature embedding, dictionary and topic latent
   tables, and a `{out}.gem.json` manifest.

`--posterior`, `--multiome` and `--data-parallel` are not ported and
raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ...embedding.nce import NceConfig, fit_bge
from ...ops import collapse as clp
from ...ops import random_projection as rp
from ...ops.leiden import knn_adjacency, leiden_clustering
from ...senna.deconvolve import leiden_at_count
from ...senna.topic import load_data_vec
from ...utils.manifest import RunManifest
from ...utils.output import matrix_columns, write_table

log = logging.getLogger(__name__)


@dataclass
class BgeArgs:
    """The flags of the JAX package's `senna bge`, same names and
    defaults."""

    data_files: Sequence[str] = ()
    out: str = "bge"
    posterior: int = 0
    embed_dim: int = 16
    epochs: int = 1000
    sort_dim: int = 8
    proj_dim: int = 50
    batch_files: Optional[Sequence[str]] = None
    feature_qc: bool = False
    hvg_min_excess: float = 0.0
    min_nnz_rows: float = 0.0
    multiome: bool = False
    bridge_weight: float = 1.0
    num_topics: int = 0
    phase1_cells_per_pb: int = 0
    skip_etm: bool = False
    compute_dtype: str = "float32"
    data_parallel: bool = False


def check_supported(args: BgeArgs):
    """Options the port does not carry yet raise instead of running
    something else."""
    off = {"--posterior": args.posterior > 0, "--multiome": args.multiome,
           "--data-parallel": args.data_parallel}
    missing = [name for name, on in off.items() if on]
    if missing:
        raise NotImplementedError(f"senna bge port does not support {', '.join(missing)} yet")


def etm_layout(e_cell: np.ndarray, e_feat: np.ndarray, labels: np.ndarray, device):
    """SIMBA co-embed and cluster-seeded ETM layout on `device`:
    `(feature embedding [D, H], log_theta [N, K], log_beta [K, D])`.
    The co-embed of a gene is the softmax-over-cells average of the cell
    embeddings; topic k is cluster k's mean cell embedding."""
    ec = torch.from_numpy(np.ascontiguousarray(e_cell, np.float32)).to(device)
    ef = torch.from_numpy(np.ascontiguousarray(e_feat, np.float32)).to(device)
    s_gc = ef @ ec.T  # [D, N]
    w = torch.exp(s_gc - s_gc.max(dim=1, keepdim=True).values)
    del s_gc
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-30)
    co_embed = w @ ec
    del w
    k_top = int(labels.max()) + 1
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    sums = torch.zeros(k_top, ec.shape[1], dtype=torch.float32, device=device).index_add_(0, lab, ec)
    sizes = torch.bincount(lab, minlength=k_top).to(torch.float32)
    cent = sums / sizes[:, None]  # [K, H]
    s_nk = ec @ cent.T
    log_theta = torch.log(torch.clamp_min(torch.exp(s_nk - s_nk.max(dim=1, keepdim=True).values), 1e-30))
    log_theta = log_theta - torch.log(torch.exp(log_theta).sum(dim=1, keepdim=True))
    s_kd = cent @ ef.T  # [K, D]
    log_beta = s_kd - s_kd.max(dim=1, keepdim=True).values
    log_beta = log_beta - torch.log(torch.exp(log_beta).sum(dim=1, keepdim=True))
    return co_embed.cpu().numpy(), log_theta.cpu().numpy(), log_beta.cpu().numpy()


def run_bge(args: BgeArgs, *, vec=None, device="cuda") -> dict:
    """End-to-end `senna bge`. `vec` overrides `args.data_files`."""
    check_supported(args)
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if vec is None:
        vec = load_data_vec(args.data_files, batch_files=args.batch_files)
    sort_dim = args.sort_dim
    if args.phase1_cells_per_pb > 0:
        # 2^d groups averaging about the target cells
        sort_dim = max(1, int(math.ceil(math.log2(max(vec.num_columns / args.phase1_cells_per_pb, 2)))))
        log.info("phase1: sort-dim %d (~%d cells/pb)", sort_dim, vec.num_columns // (1 << sort_dim))

    t0 = time.time()
    _, proj = rp.project_columns(vec, args.proj_dim, device=device)
    timings["projection_s"] = time.time() - t0
    t0 = time.time()
    codes = rp.binary_sort_columns(proj, sort_dim, device=device)
    groups, num_groups = rp.compact_group_codes(codes)
    timings["sort_s"] = time.time() - t0

    t0 = time.time()
    pb_batches = cell_batches = None
    if vec.num_batches > 1:
        # stratified negatives need pure-batch pb rows: split every group
        # by batch so each row carries its batch's marginal
        memb = vec.batch_membership()
        gb = groups.astype(np.int64) * vec.num_batches + memb
        gb_u, gb_c = np.unique(gb, return_inverse=True)
        stat = clp.collect_basic_stats(vec, gb_c, gb_u.size, device=device)
        pb_batches = [(gb_u % vec.num_batches).astype(np.int32)]
        cell_batches = memb
    else:
        stat = clp.collect_basic_stats(vec, groups, num_groups, device=device)
    pb = stat.observed_sum_ds.T  # [P, D]
    timings["collapse_s"] = time.time() - t0

    res = fit_bge(
        [pb], data=vec,
        config=NceConfig(
            embedding_dim=args.embed_dim, epochs=args.epochs, feature_qc=args.feature_qc,
            hvg_min_excess=args.hvg_min_excess, min_nnz_rows=args.min_nnz_rows,
            compute_dtype=args.compute_dtype,
        ),
        pb_batches=pb_batches, cell_batches=cell_batches, device=device,
    )
    timings.update(res.timings)

    e_feat_out = res.e_feat
    labels = log_theta = log_beta = None
    timings["leiden_s"] = timings["etm_s"] = 0.0
    if not args.skip_etm:
        # one Leiden clustering of the cell embedding seeds both the
        # co-embed (which replaces the raw feature embedding, as in the
        # reference) and the ETM layout
        t0 = time.time()
        if args.num_topics > 0:
            labels = leiden_at_count(res.e_cell, args.num_topics, knn=15, device=device)
        else:
            adj = knn_adjacency(res.e_cell, k=15, device=device)
            labels = leiden_clustering(adj, resolution=1.0, seed=0).membership
        timings["leiden_s"] = time.time() - t0
        t0 = time.time()
        e_feat_out, log_theta, log_beta = etm_layout(res.e_cell, res.e_feat, labels, device)
        timings["etm_s"] = time.time() - t0
        log.info("ETM layout: %d cluster-seeded topics", log_beta.shape[0])

    t0 = time.time()
    genes, cells = vec.row_names(), vec.column_names()
    written = {
        "latent": write_table(f"{args.out}.latent", matrix_columns(res.e_cell, "h", "cell", cells)),
        "feature_embedding": write_table(
            f"{args.out}.feature_embedding", matrix_columns(e_feat_out, "h", "gene", genes)
        ),
    }
    if not args.skip_etm:
        written["dictionary"] = write_table(
            f"{args.out}.dictionary", matrix_columns(log_beta.T, "topic", "gene", genes)
        )
        written["topic_latent"] = write_table(
            f"{args.out}.topic_latent", matrix_columns(log_theta, "topic", "cell", cells)
        )
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    RunManifest(
        command="bge",
        inputs={"data_files": list(args.data_files)},
        outputs=written,
        params=dataclasses.asdict(args),
        timings=timings,
        engine="legume-tpu-torch",
    ).save(args.out, "gem.json")
    log.info("wrote %s", written["latent"])
    return {
        "latent": res.e_cell,
        "feature_embedding": e_feat_out,
        "groups": groups,
        "num_groups": num_groups,
        "pb": pb,
        "labels": labels,
        "topic_latent": log_theta,
        "dictionary": None if log_beta is None else log_beta.T,
        "phase1_losses": res.phase1_losses,
        "phase2_losses": res.phase2_losses,
        "result": res,
        "outputs": written,
        "timings": timings,
    }
