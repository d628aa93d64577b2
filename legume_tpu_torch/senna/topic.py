"""`senna topic`: the multilevel pseudobulk topic model (the port of the
JAX package's `senna/topic.py`).

Pipeline:

1. load backends into a `SparseIoVec`;
2. streaming JL projection (kernel K1 on the card) and batch centering;
3. binary sort of the cells into fine pseudobulk groups, the level
   ladder by masking sort bits, BBKNN + DC-Poisson refinement;
4. per level: sufficient statistics (kernel K3 on the card), the
   Poisson-Gamma `optimize`, one `CollapsedOut` each;
5. per-level training triples by posterior sampling of the planes;
6. shared `LogSoftmaxEncoder` + one `NbTopicDecoder` per level;
7. outputs: per-cell latent, pseudobulk latent, dictionary, batch
   effects, dispersion, llik/kl traces, model weights, partition and a
   `{out}.senna.json` manifest.

Every entry point runs on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..data import MemoryBackend, SparseIoVec, open_sparse_matrix
from ..data.visitors import visit_columns_by_block
from ..models.convert import params_from_jax, params_to_jax
from ..models.decoders import NbTopicDecoder
from ..models.encoders import LogSoftmaxEncoder
from ..models.train import LevelData, MixedTrainer, TrainConfig
from ..ops import collapse as clp
from ..ops import random_projection as rp
from ..ops import sparse as sparse_ops
from ..utils import prng
from ..utils.output import matrix_columns, write_table
from ..utils.prng import DEFAULT_PROJECTION_SEED

log = logging.getLogger(__name__)

DEFAULT_COARSEST_SORT_DIM = 7


@dataclass
class TopicArgs:
    """The JAX package's `TopicArgs`, same names and defaults."""

    data_files: Sequence[str] = ()
    out: str = "topic"
    batch_files: Optional[Sequence[str]] = None
    n_latent_topics: int = 10
    encoder_layers: Sequence[int] = (128, 1024, 128)
    epochs: int = 1000
    minibatch_size: int = 100
    learning_rate: float = 0.01
    grad_clip: float = 1.0
    decoder: str = "nb"
    decoder_weights: Optional[Sequence[float]] = None
    topic_smoothing: float = 1e-4
    proj_dim: int = 50
    sort_dim: int = 10
    knn_cells: int = 10
    num_levels: int = 3
    iter_opt: int = 30
    ignore_batch: bool = False
    block_size: int = 8192
    init_from: Optional[str] = None
    from_run: Optional[str] = None
    adj_method: str = "residual"
    rho_prior_weight: float = 0.0
    rho_prior_alpha: float = 2.0
    rho_prior_beta: float = 18.0
    amort_refine_steps: int = 0
    amort_refine_lr: float = 0.01
    amort_refine_reg: float = 1.0
    preload_data: bool = False
    qc: bool = False
    qc_min_total: float = 0.0
    qc_min_genes: int = 0
    qc_max_mito_frac: float = 1.0
    hvg_genes: int = 5000
    refine: bool = True
    refine_gibbs: int = 3
    refine_greedy: int = 3
    gene_weighting: str = "nb-fisher"
    anchor_penalty: float = 0.0
    max_coarse_features: int = 0
    cnv: bool = False
    cnv_genes_per_bin: int = 25
    data_parallel: bool = False
    seed: int = DEFAULT_PROJECTION_SEED


def check_supported(args: TopicArgs):
    """Options the port does not carry yet raise instead of running
    something else."""
    off = {
        "--qc": args.qc,
        "--max-coarse-features": args.max_coarse_features,
        "--cnv": args.cnv,
        "--init-from": args.init_from,
        "--from": args.from_run,
        "--amort-refine-steps > 0": args.amort_refine_steps > 0,
        "--data-parallel": args.data_parallel,
        "--decoder-weights": args.decoder_weights,
        "--decoder other than nb": args.decoder.strip() != "nb",
    }
    missing = [name for name, on in off.items() if on]
    if missing:
        raise NotImplementedError(f"senna topic port does not support {', '.join(missing)} yet")


def compute_level_sort_dims(finest: int, num_levels: int) -> list[int]:
    """Finest-first sort-dim ladder."""
    if num_levels <= 1:
        return [finest]
    coarsest = min(DEFAULT_COARSEST_SORT_DIM, finest)
    dims = []
    for level in range(num_levels):
        dim = round(finest - level / (num_levels - 1) * (finest - coarsest))
        if not dims or dims[-1] != dim:
            dims.append(dim)
    return dims


def load_data_vec(data_files: Sequence[str], batch_files=None) -> SparseIoVec:
    vec = SparseIoVec()
    backends = [open_sparse_matrix(f) for f in data_files]
    for b in backends:
        vec.push(b)
    if batch_files:
        import gzip

        labels = []
        for f in batch_files:
            opener = gzip.open if str(f).endswith(".gz") else open
            with opener(f, "rt") as fh:
                labels.extend(line.strip() for line in fh if line.strip())
        vec.register_batches(np.asarray(labels))
    elif len(backends) > 1:
        memb = np.concatenate([np.full(b.num_columns, i, np.int32) for i, b in enumerate(backends)])
        vec.register_batches(memb.astype(str))
    return vec


@dataclass
class CollapsedLevels:
    collapsed: list[clp.CollapsedOut]
    groups_per_level: list[np.ndarray]  # cell -> pb per level, finest first
    num_groups_per_level: list[int]
    proj_kn: np.ndarray
    basis_dk: np.ndarray
    fine_codes: np.ndarray
    level_maps: list[np.ndarray] = field(default_factory=list)  # fine-pb -> group


def refine_hierarchy_maps(
    proj_kn: np.ndarray,
    fine_groups: np.ndarray,
    uniq_codes: np.ndarray,
    level_dims: Sequence[int],
    args: TopicArgs,
    *,
    device="cuda",
) -> list[np.ndarray]:
    """BBKNN + DC-Poisson refinement of the pseudobulk hierarchy. The
    entities are the fine pseudobulks, scored on their projected
    centroids with negative dims dropped; each coarser level's fine ->
    coarse map starts from the masked sort codes and is refined coarsest
    to finest, among kNN-neighbour groups that share the parent.
    Returns the per-level fine -> coarse maps (level 0 = identity)."""
    from ..ops.dc_poisson import refine_with_candidates
    from ..ops.knn import knn_within

    s_fine = len(uniq_codes)
    cent = np.zeros((s_fine, proj_kn.shape[0]), np.float64)
    np.add.at(cent, fine_groups, proj_kn.T)
    profiles = np.maximum(cent, 0.0)
    size = profiles.sum(1).astype(np.float32)

    maps = []
    for dim in level_dims:
        _, f2c = np.unique(uniq_codes & ((1 << dim) - 1), return_inverse=True)
        maps.append(f2c.astype(np.int32))
    if s_fine < 3 or len(level_dims) < 2:
        return maps

    n_nbr = min(max(args.knn_cells, 2), s_fine - 1)
    _, nbr = knn_within(cent.astype(np.float32), n_nbr, device=device)
    prof_sp = sp.csr_matrix(profiles)

    for li in range(len(level_dims) - 1, 0, -1):
        if li + 1 < len(maps):
            # re-nest under the refined coarser level first
            parent_of_samp = maps[li + 1]
            pair = parent_of_samp.astype(np.int64) * (maps[li].max() + 1) + maps[li]
            _, renest = np.unique(pair, return_inverse=True)
            maps[li] = renest.astype(np.int32)
        else:
            parent_of_samp = np.zeros(s_fine, np.int32)
        labels = maps[li]
        n_groups = int(labels.max()) + 1
        if n_groups < 2:
            continue
        parent_of_group = np.zeros(n_groups, np.int32)
        parent_of_group[labels] = parent_of_samp
        cand = np.zeros((s_fine, n_groups), bool)
        sib_ok = parent_of_group[None, :] == parent_of_samp[:, None]
        cand[np.repeat(np.arange(s_fine), nbr.shape[1]), labels[nbr].ravel()] = True
        cand &= sib_ok
        cand[np.arange(s_fine), labels] = True
        empty = ~cand.any(1)
        if empty.any():  # sibling fallback
            cand[empty] = sib_ok[empty]
        res = refine_with_candidates(
            prof_sp, labels, n_groups, candidates=cand, size_factors=size,
            num_gibbs=args.refine_gibbs, num_greedy=args.refine_greedy,
            seed=args.seed & 0x7FFFFFFF, device=device,
        )
        log.info("refine level %d: moves per sweep %s", li, res.n_moves_per_sweep)
        _, new_c = np.unique(res.labels, return_inverse=True)
        maps[li] = new_c.astype(np.int32)
    return maps


def load_and_collapse(
    vec, args: TopicArgs, *, timings: dict | None = None, device="cuda"
) -> CollapsedLevels:
    """Projection + binary sort + partition refinement + multilevel
    collapse."""
    timings = timings if timings is not None else {}
    batches = vec.batch_membership()
    num_batches = vec.num_batches if not args.ignore_batch else 1
    d = vec.num_rows

    row_weights = None
    t0 = time.time()
    if args.hvg_genes and args.hvg_genes < d:
        from ..ops.gene_stats import hvg_row_weights

        row_weights = hvg_row_weights(vec, args.hvg_genes, block_size=args.block_size, device=device)
        log.info("hvg: projection sketch gated to %d genes", int(row_weights.sum()))
    timings["hvg_s"] = time.time() - t0

    t0 = time.time()
    basis, proj_kn = rp.project_columns(
        vec,
        max(args.proj_dim, args.n_latent_topics),
        block_size=args.block_size,
        batch_membership=batches if num_batches > 1 else None,
        row_weights=row_weights,
        seed=args.seed,
        device=device,
    )
    timings["projection_s"] = time.time() - t0

    level_dims = compute_level_sort_dims(args.sort_dim, args.num_levels)
    t0 = time.time()
    fine_codes = rp.binary_sort_columns(proj_kn, level_dims[0], seed=args.seed, device=device)
    uniq_codes, fine_groups = np.unique(fine_codes, return_inverse=True)
    fine_groups = fine_groups.astype(np.int32)
    s_fine = len(uniq_codes)
    if args.refine:
        level_maps = refine_hierarchy_maps(
            proj_kn, fine_groups, uniq_codes, level_dims, args, device=device
        )
    else:
        level_maps = []
        for dim in level_dims:
            _, f2c = np.unique(uniq_codes & ((1 << dim) - 1), return_inverse=True)
            level_maps.append(f2c.astype(np.int32))
    timings["sort_refine_s"] = time.time() - t0

    t0 = time.time()
    collapsed, groups_per_level, num_groups_per_level = [], [], []
    stats_fine: clp.CollapsedStat | None = None
    for li in range(len(level_dims)):
        if stats_fine is None:
            groups_l, s_l = fine_groups, s_fine
            stat_l = clp.collect_basic_stats(
                vec, groups_l, s_l, num_batches=num_batches, batches=batches,
                block_size=args.block_size, device=device,
            )
            if num_batches > 1:
                stat_l = clp.collect_matched_stats(
                    vec, groups_l, s_l, batches, num_batches, proj_kn.T.copy(),
                    knn=args.knn_cells, stat=stat_l, device=device,
                )
            stats_fine = stat_l
        else:
            f2c = level_maps[li]
            stat_l = clp.merge_stat(stats_fine, f2c, int(f2c.max()) + 1)
            groups_l = f2c[fine_groups]
            s_l = stat_l.num_groups
        collapsed.append(clp.optimize(stat_l, num_iter=args.iter_opt, device=device))
        groups_per_level.append(groups_l)
        num_groups_per_level.append(s_l)
    timings["collapse_s"] = time.time() - t0

    return CollapsedLevels(
        collapsed=collapsed,
        groups_per_level=groups_per_level,
        num_groups_per_level=num_groups_per_level,
        proj_kn=proj_kn,
        basis_dk=basis,
        fine_codes=fine_codes,
        level_maps=level_maps,
    )


def sample_collapsed_data(out: clp.CollapsedOut, key: np.ndarray, device="cuda") -> LevelData:
    """Posterior-sample the training triple: encoder input ~ mu_observed,
    batch null ~ mu_residual, target ~ mu_adjusted (each [P, D])."""
    k1, k2, k3 = prng.split(key, 3)
    draw = lambda g, k: g.sample(prng.generator_from_key(k, device)).T.cpu().numpy()  # noqa: E731
    mixed = draw(out.mu_observed, k1)
    null = draw(out.mu_residual, k2) if out.mu_residual is not None else None
    target = draw(out.mu_adjusted, k3) if out.mu_adjusted is not None else mixed
    return LevelData(input=mixed, input_null=null, output=target)


def _preload(vec: SparseIoVec) -> SparseIoVec:
    """All columns in one in-memory backend (`--preload-data`)."""
    mem = MemoryBackend(
        vec.read_columns_csc(np.arange(vec.num_columns)),
        row_names=vec.row_names(), column_names=vec.column_names(),
    )
    pre = SparseIoVec()
    pre.push(mem)
    if vec.num_batches > 1:
        pre.register_batches(np.asarray(vec.batch_names())[vec.batch_membership()])
    return pre


def fit_topic_model(args: TopicArgs, *, vec: SparseIoVec | None = None, device="cuda") -> dict:
    """End-to-end `senna topic`. `vec` overrides `args.data_files`."""
    check_supported(args)
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if vec is None:
        vec = load_data_vec(args.data_files, args.batch_files)
    if args.preload_data:
        vec = _preload(vec)
    d = vec.num_rows
    log.info("topic fit: D=%d genes, N=%d cells", d, vec.num_columns)

    levels = load_and_collapse(vec, args, timings=timings, device=device)
    n_levels = len(levels.collapsed)
    keys = prng.split(prng.key(args.seed & 0x7FFFFFFF), 1 + n_levels)
    key = keys[0]
    t0 = time.time()
    level_data = [
        sample_collapsed_data(out, k, device) for out, k in zip(levels.collapsed, keys[1:])
    ]
    timings["sample_s"] = time.time() - t0

    t0 = time.time()
    k_init, k_train = prng.split(key)
    init_gen = prng.generator_from_key(k_init)
    k = args.n_latent_topics
    encoder = LogSoftmaxEncoder(d, k, tuple(args.encoder_layers), generator=init_gen)
    decoders = [NbTopicDecoder(d, k, generator=init_gen) for _ in range(n_levels)]
    timings["model_init_s"] = time.time() - t0

    feature_weights = [None] * n_levels
    t0 = time.time()
    if args.gene_weighting == "nb-fisher":
        from ..ops.gene_stats import nb_fisher_weights

        fw = nb_fisher_weights(vec, block_size=args.block_size, device=device)
        feature_weights = [fw] * n_levels
    timings["gene_weights_s"] = time.time() - t0

    # anchor prior: archetypal finest pseudobulks initialise every level's
    # dictionary (and, with --anchor-penalty, add a CE penalty)
    t0 = time.time()
    finest = levels.collapsed[0]
    finest_plane = finest.mu_adjusted if finest.mu_adjusted is not None else finest.mu_observed
    finest_mean = finest_plane.mean().cpu().numpy()
    init_dictionaries = anchor_weights = None
    if finest_mean.shape[1] >= 2:
        from .anchor import AnchorPrior

        anchor = AnchorPrior.from_pseudobulk(finest_mean, k)
        init_dictionaries = [anchor.init_logits() for _ in range(n_levels)]
        if args.anchor_penalty > 0:
            anchor_weights = anchor.per_level_weights([None] * n_levels)
    timings["anchor_s"] = time.time() - t0

    t0 = time.time()
    cfg = TrainConfig(
        epochs=args.epochs,
        minibatch_size=args.minibatch_size,
        learning_rate=args.learning_rate,
        topic_smoothing=args.topic_smoothing,
        grad_clip=args.grad_clip,
    )
    trainer = MixedTrainer(
        encoder, decoders, cfg, feature_weights=feature_weights,
        anchor_weights=anchor_weights, anchor_penalty=args.anchor_penalty, device=device,
    )
    timings["train_setup_s"] = time.time() - t0
    t0 = time.time()
    scores = trainer.train(
        level_data, prng.generator_from_key(k_train, device), init_dictionaries=init_dictionaries
    )
    timings["train_s"] = time.time() - t0

    t0 = time.time()
    z = evaluate_latent_by_encoder(
        vec, trainer.encoder, finest, levels.groups_per_level[0],
        block_size=args.minibatch_size * 8, adj_method=args.adj_method, device=device,
    )
    timings["cell_eval_s"] = time.time() - t0

    # ---- outputs -------------------------------------------------------
    t0 = time.time()
    cell_names = vec.column_names()
    gene_names = vec.row_names()
    with torch.no_grad():
        log_beta = trainer.decoders[0].get_dictionary().cpu().numpy()
    written = {"dictionary": write_table(
        f"{args.out}.dictionary", matrix_columns(log_beta, "topic", "gene", gene_names)
    )}
    written["latent"] = write_table(
        f"{args.out}.latent", matrix_columns(z, "topic", "cell", cell_names)
    )

    pb_log_z = trainer.encode(level_data[0].input, level_data[0].input_null)
    written["pb_latent"] = write_table(f"{args.out}.pb_latent", matrix_columns(np.exp(pb_log_z), "topic"))
    if finest.delta is not None:
        delta = finest.delta.mean().cpu().numpy()
        written["delta"] = write_table(
            f"{args.out}.delta",
            {"gene": np.asarray(gene_names), **{b: delta[:, i] for i, b in enumerate(vec.batch_names())}},
        )
    phi = np.exp(trainer.decoders[0].log_phi.detach().cpu().numpy()).ravel()
    written["dispersion"] = write_table(
        f"{args.out}.dispersion", {"gene": np.asarray(gene_names), "dispersion": phi}
    )
    written["log_likelihood"] = write_table(
        f"{args.out}.log_likelihood",
        {"epoch": np.arange(len(scores.llik)), "llik": np.asarray(scores.llik), "kl": np.asarray(scores.kl)},
    )
    save_model(args.out, trainer, args, d, gene_names)
    part_path = f"{args.out}.partition.npz"
    np.savez(
        part_path,
        fine_groups=levels.groups_per_level[0].astype(np.int32),
        **{f"map{i:02d}": m.astype(np.int32) for i, m in enumerate(levels.level_maps)},
    )
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    manifest = {
        "command": "topic",
        "inputs": {
            "data_files": list(args.data_files),
            "batch_files": list(args.batch_files) if args.batch_files else [],
        },
        "outputs": {
            **written,
            "model": f"{args.out}.model.npz",
            "model_metadata": f"{args.out}.model.json",
            "partition": part_path,
        },
        "params": dataclasses.asdict(args),
        "timings": timings,
        "engine": "legume-tpu-torch",
    }
    with open(f"{args.out}.senna.json", "w") as f:
        json.dump(manifest, f, indent=2, default=str)

    return {
        "scores": scores,
        "trainer": trainer,
        "levels": levels,
        "level_data": level_data,
        "latent": z,
        "log_beta": log_beta,
        "timings": timings,
    }


@torch.no_grad()
def encode_block(encoder, row_ids, col_ptr, vals, null_sd, membership, *, num_genes: int):
    """Per-cell log topic proportions of one block at eval: densify
    [ncols, D] and encode with the null rows `null_sd[membership]`."""
    ncols = col_ptr.shape[0] - 1
    x = sparse_ops.densify_block(
        row_ids, sparse_ops.col_ids_from_ptr(col_ptr), vals, ncols=ncols, num_genes=num_genes
    )
    nu = None if null_sd is None else null_sd[membership]
    log_z, _ = encoder(x, nu, train=False)
    return log_z


def evaluate_latent_by_encoder(
    vec,
    encoder: LogSoftmaxEncoder,
    finest: clp.CollapsedOut,
    groups: np.ndarray,
    *,
    block_size: int = 800,
    adj_method: str = "residual",
    device="cuda",
) -> np.ndarray:
    """Per-cell latent: stream cell blocks through the eval encoder with
    each cell's null row. "residual" indexes mu_residual [D, S] by the
    pseudobulk group, "batch" indexes delta [D, B] by the batch label."""
    if adj_method == "batch" and finest.delta is not None:
        null_ds, membership = finest.delta.mean(), vec.batch_membership()
    else:
        null_ds = finest.mu_residual.mean() if finest.mu_residual is not None else None
        membership = groups
    null_sd = None if null_ds is None else null_ds.T.contiguous().to(device)
    memb = torch.as_tensor(np.asarray(membership, np.int64), device=device)
    encoder.eval()
    pieces = []
    for blk in visit_columns_by_block(vec, block_size=block_size):
        r, p, v = rp.block_to_device(blk, device)
        pieces.append(encode_block(
            encoder, r, p, v, null_sd, memb[blk.lb : blk.lb + blk.ncols], num_genes=vec.num_rows
        ))
    if not pieces:
        return np.zeros((0, encoder.n_topics), np.float32)
    return torch.cat(pieces).cpu().numpy()


def save_model(out: str, trainer: MixedTrainer, args, n_features: int, gene_names):
    """Weights in the JAX package's flat layout + the same metadata, so
    either package loads a model the other saved."""
    flat = params_to_jax(
        trainer.encoder.state_dict(), [dec.state_dict() for dec in trainer.decoders]
    )
    np.savez(f"{out}.model.npz", **flat)
    meta = {
        "model_type": "topic",
        "n_topics": args.n_latent_topics,
        "n_features": n_features,
        "encoder_layers": list(args.encoder_layers),
        "decoder": args.decoder,
        "num_levels": args.num_levels,
        "gene_names_file": f"{out}.genes.txt",
    }
    with open(f"{out}.model.json", "w") as f:
        json.dump(meta, f, indent=2)
    with open(f"{out}.genes.txt", "w") as f:
        f.write("\n".join(str(g) for g in gene_names) + "\n")


def load_model(out: str):
    """(metadata, flat weights `{"a/b/c": array}`, gene names)."""
    with open(f"{out}.model.json") as f:
        meta = json.load(f)
    with np.load(f"{out}.model.npz") as z:
        flat = {k: z[k] for k in z.files}
    with open(meta["gene_names_file"]) as f:
        gene_names = [line.strip() for line in f if line.strip()]
    if len(gene_names) != meta["n_features"]:
        raise ValueError("gene name count disagrees with metadata n_features")
    return meta, flat, gene_names


def build_model(meta: dict, flat: dict, device="cuda"):
    """(encoder, [decoder per level]) holding saved weights."""
    enc_state, dec_states = params_from_jax(flat)
    d, k = meta["n_features"], meta["n_topics"]
    encoder = LogSoftmaxEncoder(d, k, tuple(meta["encoder_layers"]))
    encoder.load_state_dict(enc_state)
    decoders = []
    for state in dec_states:
        dec = NbTopicDecoder(d, k)
        dec.load_state_dict(state)
        decoders.append(dec.to(device))
    return encoder.to(device).eval(), decoders
