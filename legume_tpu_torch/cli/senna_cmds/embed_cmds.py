"""`senna bge` and `senna resolve-embedding-space` (`rest`) end to end
(the port of the JAX package's `cli/senna_cmds/embed_cmds.py::_cmd_bge`
and `_cmd_rest`).

`senna bge`:

1. load backends into a `SparseIoVec` (with `--multiome`, the RNA and
   ATAC files' feature axes stacked on their shared cells, the second
   scaled by `--bridge-weight`);
2. streaming JL projection (kernel K1 on the card) and the binary sort
   into pseudobulk groups (split by batch when there is more than one);
3. pseudobulk sums (kernel K3 on the card);
4. `fit_bge`: phase 1 on the pseudobulk plane and phase 2 per cell
   (kernel K4 on the card for a dense, unstratified marginal);
5. unless `skip_etm`: one Leiden clustering of the cell embedding (host)
   seeds the SIMBA co-embed of the genes and the cluster-seeded ETM
   layout (device);
6. with `--posterior N`: `pb_gibbs` (`embedding/posterior.py`) on the
   pseudobulk plane from the phase-1 fit, N sweeps after max(N / 4, 2)
   of burn-in, written to `{out}.feature_posterior`;
7. outputs: latent, feature embedding, dictionary and topic latent
   tables, and a `{out}.gem.json` manifest.

`senna rest --from RUN` fits the shared cell + gene space with RUN's
cell proportions frozen (`embedding/resolve.py::rest_fit`); `senna rest
--runs A B ...` Procrustes-aligns the feature (and cell) embeddings of
finished runs. `--data-parallel` is not ported and raises
`NotImplementedError`.
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

from ...data import MemoryBackend, SparseIoVec, open_sparse_matrix
from ...embedding.nce import NceConfig, fit_bge
from ...ops import collapse as clp
from ...ops import random_projection as rp
from ...ops.leiden import knn_adjacency, leiden_clustering
from ...senna.deconvolve import leiden_at_count
from ...senna.topic import load_data_vec, read_batch_labels
from ...utils.manifest import RunManifest
from ...utils.output import matrix_columns, read_table, table_path, write_table

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
    if args.data_parallel:
        raise NotImplementedError("senna bge port does not support --data-parallel yet")


def multiome_vec(backends, bridge_weight: float = 1.0, batch_files=None) -> SparseIoVec:
    """Paired RNA and ATAC backends stacked on their shared cells: one
    vec whose features are `rna:<gene>` then `atac:<peak>`, the ATAC
    counts scaled by `bridge_weight`."""
    if len(backends) != 2:
        raise SystemExit("--multiome needs exactly 2 data files (rna atac)")
    rna, atac = backends
    if rna.num_columns != atac.num_columns:
        raise SystemExit("multiome modalities must share cells")
    import scipy.sparse as sp

    cols = np.arange(rna.num_columns)
    stacked = sp.vstack([rna.read_columns_csc(cols),
                         atac.read_columns_csc(cols) * bridge_weight]).tocsc()
    names = [f"rna:{g}" for g in rna.row_names()] + [f"atac:{p}" for p in atac.row_names()]
    vec = SparseIoVec()
    vec.push(MemoryBackend(stacked, names, rna.column_names()))
    if batch_files:
        vec.register_batches(read_batch_labels(batch_files))
    log.info("multiome: %d genes + %d peaks (bridge %s)", rna.num_rows, atac.num_rows,
             bridge_weight)
    return vec


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


def run_bge(args: BgeArgs, *, vec=None, backends=None, device="cuda") -> dict:
    """End-to-end `senna bge`. `vec` overrides `args.data_files`; with
    `--multiome`, `backends` (the two modalities, open) does."""
    check_supported(args)
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if args.multiome:
        backends = backends or [open_sparse_matrix(f) for f in args.data_files]
        vec = multiome_vec(backends, args.bridge_weight, args.batch_files)
    elif vec is None:
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
    post = None
    if args.posterior > 0:
        from ...embedding.posterior import pb_gibbs

        t0 = time.time()
        post = pb_gibbs(
            pb, res.e_feat, res.b_feat, res.pb_embeddings[0], np.zeros(pb.shape[0]),
            n_sweeps=args.posterior, burnin=max(args.posterior // 4, 2), device=device,
        )
        written["feature_posterior"] = write_table(f"{args.out}.feature_posterior", {
            "gene": np.asarray(genes), "pip": post.pip.max(axis=1),
            "posterior_norm": np.linalg.norm(post.e_feat_mean, axis=1),
        })
        timings["posterior_s"] = time.time() - t0
        log.info("posterior: %d sweeps, rhat max %.2f", args.posterior, post.rhat.max())
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
        "posterior": post,
        "outputs": written,
        "timings": timings,
    }


@dataclass
class RestArgs:
    """The flags of the JAX package's `senna resolve-embedding-space`."""

    out: str = "rest"
    from_run: Optional[str] = None
    data_files: Optional[Sequence[str]] = None
    embedding_dim: Optional[int] = None
    epochs: int = 400
    learning_rate: float = 0.05
    num_negatives: float = 5.0
    runs: Optional[Sequence[str]] = None
    reference: int = 0
    no_scale: bool = False
    seed: int = 0


def _matrix_table(path: str) -> tuple[list[str], np.ndarray]:
    """(first column as strings, the other columns as a float64 matrix)."""
    cols = read_table(path)
    names = list(cols)
    return ([str(x) for x in cols[names[0]]],
            np.stack([np.asarray(cols[c], np.float64) for c in names[1:]], axis=1))


def run_rest(args: RestArgs, *, vec=None, device="cuda") -> dict:
    """`senna rest --from RUN` (frozen-theta co-embedding) or `senna rest
    --runs A B ...` (Procrustes alignment). `vec` overrides the data
    files of `--from`."""
    from ...embedding.resolve import resolve_embedding_spaces, rest_fit
    from ...utils.manifest import manifest_path

    if args.from_run:
        prev = RunManifest.load(manifest_path(args.from_run))
        lat = prev.outputs.get("latent")
        if lat is None:
            raise SystemExit("rest --from: source run has no latent")
        cells, theta = _matrix_table(lat)
        theta = theta.astype(np.float32)
        if np.all(theta <= 0):
            theta = np.exp(theta)
        theta = theta / np.maximum(theta.sum(1, keepdims=True), 1e-30)
        files = args.data_files or prev.inputs.get("data_files")
        if vec is None:
            if not files:
                raise SystemExit("rest --from: no data files found")
            vec = load_data_vec(files)
        t0 = time.time()
        res = rest_fit(theta, vec, embedding_dim=args.embedding_dim, epochs=args.epochs,
                       learning_rate=args.learning_rate, n_negatives=args.num_negatives,
                       seed=args.seed, device=device)
        fit_s = time.time() - t0
        out = {
            "latent": write_table(f"{args.out}.latent",
                                  matrix_columns(res["cell_embedding"], "h", "cell", cells)),
            "feature_embedding": write_table(
                f"{args.out}.feature_embedding",
                matrix_columns(res["feature_embedding"], "h", "gene", vec.row_names())),
        }
        topic = write_table(f"{args.out}.topic_embedding",
                            matrix_columns(res["topic_embedding"], "h"))
        RunManifest(
            command="resolve-embedding-space",
            inputs={"from": args.from_run, "data_files": list(files or [])},
            outputs=out, timings={"fit_s": fit_s}, engine="legume-tpu-torch",
        ).save(args.out)
        log.info("wrote %s, %s and %s", out["latent"], out["feature_embedding"], topic)
        return {**res, "outputs": {**out, "topic_embedding": topic}, "fit_s": fit_s}
    if not args.runs:
        raise SystemExit("rest: provide --from <run> or --runs <prefixes>")
    runs = []
    for prefix in args.runs:
        feats, e_feat = _matrix_table(table_path(f"{prefix}.feature_embedding"))
        run = {"feat_names": feats, "e_feat": e_feat, "e_cell": None, "cell_names": None}
        lat = table_path(f"{prefix}.latent")
        if lat is not None:
            run["cell_names"], run["e_cell"] = _matrix_table(lat)
        runs.append(run)
    aligned = resolve_embedding_spaces(runs, reference=args.reference,
                                       allow_scale=not args.no_scale)
    outputs = []
    for i, run in enumerate(aligned):
        paths = {"feature_embedding": write_table(
            f"{args.out}.run{i}.feature_embedding",
            matrix_columns(run["e_feat"], "h", "feature", run["feat_names"]))}
        if run.get("e_cell") is not None:
            paths["latent"] = write_table(
                f"{args.out}.run{i}.latent",
                matrix_columns(run["e_cell"], "h", "cell", run["cell_names"]))
        outputs.append(paths)
    log.info("wrote %d aligned runs under %s.run*", len(aligned), args.out)
    return {"aligned": aligned, "outputs": outputs}


def add_svd_parsers(sub) -> None:
    """`senna svd` and `senna joint-svd`, the JAX flags and defaults."""
    p = sub.add_parser("svd", help="streaming Nystrom rSVD embedding")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch-files", nargs="+", default=None)
    p.add_argument("--n-factors", type=int, default=20)
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--column-sum-norm", type=float, default=0.0)
    p.add_argument("--save-adjusted", action="store_true")
    p.add_argument("--qc", action="store_true")
    p.add_argument("--qc-min-total", type=float, default=0.0)
    p.add_argument("--qc-min-genes", type=int, default=0)
    p.add_argument("--qc-max-mito-frac", type=float, default=1.0)
    p.add_argument("--hvg-genes", type=int, default=0)
    p.add_argument("--cnv", action="store_true")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("joint-svd", help="multi-modality rSVD (shared cells)")
    p.add_argument("--data-files", nargs="+", required=True, action="append",
                   help="repeat once per modality")
    p.add_argument("--out", required=True)
    p.add_argument("--n-factors", type=int, default=20)
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--sort-dim", type=int, default=10)
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def run_svd(a, *, vec=None) -> dict:
    from ...senna.svd import SvdArgs, fit_svd
    from ...utils.prng import DEFAULT_PROJECTION_SEED

    fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device", "seed")}
    seed = a.seed if a.seed is not None else DEFAULT_PROJECTION_SEED
    return fit_svd(SvdArgs(**fields, seed=seed), vec=vec, device=a.device)


def run_joint_svd(a, *, vecs=None) -> dict:
    from ...senna.svd import fit_joint_svd
    from ...utils.prng import DEFAULT_PROJECTION_SEED

    return fit_joint_svd(
        a.data_files, a.out, n_factors=a.n_factors, proj_dim=a.proj_dim, sort_dim=a.sort_dim,
        block_size=a.block_size, seed=a.seed if a.seed is not None else DEFAULT_PROJECTION_SEED,
        vecs=vecs, device=a.device,
    )


def add_fne_parser(sub) -> None:
    """`senna fne`, the JAX flags and defaults."""
    p = sub.add_parser("fne", help="feature-network embedding from an edge list")
    p.add_argument("--edges", required=True, help="TSV: src dst [weight]")
    p.add_argument("--out", required=True)
    p.add_argument("-d", "--embedding-dim", type=int, default=32)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--learning-rate", "--lr", type=float, default=0.05)
    p.add_argument("--num-negatives", type=float, default=5.0,
                   help="expected negatives per positive edge unit (exact expectation)")
    p.add_argument("--neg-alpha", type=float, default=0.75,
                   help="marginal^alpha negative distribution")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def run_fne(a):
    """`senna fne`: `{out}.embedding` (node, h0..h{d-1})."""
    import pandas as pd

    from ...senna.fne import fit_fne
    from ...utils.output import matrix_columns, write_table

    df = pd.read_csv(a.edges, sep="\t", header=None)
    edges = [tuple(r) for r in df.itertuples(index=False)]
    res = fit_fne(
        edges, embedding_dim=a.embedding_dim, epochs=a.epochs, seed=a.seed,
        learning_rate=a.learning_rate, n_negatives=a.num_negatives, neg_alpha=a.neg_alpha,
        device=a.device,
    )
    path = write_table(f"{a.out}.embedding", matrix_columns(
        res.embedding, "h", "node", np.asarray([str(n) for n in res.names])))
    print(f"wrote {path} ({len(res.names)} nodes)")
    return res
