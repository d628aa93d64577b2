"""`senna topic`: the multilevel pseudobulk topic model (the port of the
JAX package's `senna/topic.py`).

Pipeline:

1. load backends into a `SparseIoVec` (`--from`: the inputs and the
   cell -> pseudobulk partition of a prior run); `--qc` keeps the cells
   inside its floors and MAD fences;
2. streaming JL projection (kernel K1 on the card) and batch centering;
3. binary sort of the cells into fine pseudobulk groups, the level
   ladder by masking sort bits, BBKNN + DC-Poisson refinement (skipped
   when `--from` supplies the partition);
4. per level: sufficient statistics (kernel K3 on the card), the
   Poisson-Gamma `optimize`, one `CollapsedOut` each;
5. per-level training triples by posterior sampling of the planes, the
   decoder targets coarsened per level under `--max-coarse-features`;
6. shared `LogSoftmaxEncoder` + per level one decoder, or one per family
   of `--decoder a,b`; the anchor prior or `--init-from` starts them;
7. outputs: per-cell latent, pseudobulk latent, dictionary (per family
   too), batch effects, the decoders' nuisance tables, llik/kl traces,
   model weights, partition and a `{out}.senna.json` manifest.

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
from ..models.decoders import DECODERS
from ..models.encoders import GaussianEncoder, LogSoftmaxEncoder
from ..models.train import LevelData, MixedTrainer, TrainConfig
from ..ops import collapse as clp
from ..ops import random_projection as rp
from ..ops import sparse as sparse_ops
from ..utils import prng
from ..utils.manifest import ArtifactScale, RunManifest, manifest_path
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


def decoder_names(decoder: str) -> list[str]:
    """The families of `--decoder`: one name, or several separated by
    commas or spaces."""
    return [s for s in decoder.replace(",", " ").split() if s]


def check_supported(args: TopicArgs):
    """Options the port does not carry yet raise instead of running
    something else; an unknown decoder family is an error."""
    names = decoder_names(args.decoder)
    if args.data_parallel:
        raise NotImplementedError("senna topic port does not support --data-parallel yet")
    unknown = [n for n in names if n not in DECODERS]
    if not names or unknown:
        raise ValueError(f"unknown decoder {unknown or args.decoder!r}; choose from {sorted(DECODERS)}")
    if args.decoder_weights and len(args.decoder_weights) != len(names):
        raise ValueError(f"{len(args.decoder_weights)} decoder weights for {len(names)} decoders")


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


def read_batch_labels(batch_files: Sequence[str]) -> np.ndarray:
    """One label a line from each (optionally gzipped) file, in order."""
    import gzip

    labels = []
    for f in batch_files:
        opener = gzip.open if str(f).endswith(".gz") else open
        with opener(f, "rt") as fh:
            labels.extend(line.strip() for line in fh if line.strip())
    return np.asarray(labels)


def load_data_vec(data_files: Sequence[str], batch_files=None) -> SparseIoVec:
    vec = SparseIoVec()
    backends = [open_sparse_matrix(f) for f in data_files]
    for b in backends:
        vec.push(b)
    if batch_files:
        vec.register_batches(read_batch_labels(batch_files))
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
    vec, args: TopicArgs, *, partition: dict | None = None, timings: dict | None = None,
    device="cuda",
) -> CollapsedLevels:
    """Projection + binary sort + partition refinement + multilevel
    collapse. `partition` (a prior run's `{out}.partition.npz`, through
    `--from`) supplies `fine_groups` and `level_maps` and skips the sort
    and the refinement; the projection still runs (the matched statistics
    need the cells' coordinates)."""
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
    if partition is not None:
        fine_groups = np.asarray(partition["fine_groups"], np.int32)
        if len(fine_groups) != vec.num_columns:
            raise ValueError(
                f"inherited partition covers {len(fine_groups)} cells but the "
                f"data has {vec.num_columns}"
            )
        level_maps = [np.asarray(m, np.int32) for m in partition["level_maps"]]
        level_dims = level_dims[: len(level_maps)]
        fine_codes = fine_groups.astype(np.int64)
        s_fine = int(fine_groups.max()) + 1
        log.info("reusing inherited cell->pb partition (%d fine pbs)", s_fine)
    else:
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


def _inherit_run(args: TopicArgs) -> tuple[TopicArgs, dict | None]:
    """`--from`: the data and batch files of a prior run's manifest fill
    the ones not given, and its `{out}.partition.npz` is reused when the
    data files are the same."""
    prev = RunManifest.load(manifest_path(args.from_run))
    data_files = args.data_files or prev.inputs.get("data_files", [])
    batch_files = args.batch_files
    if batch_files is None and prev.inputs.get("batch_files"):
        batch_files = prev.inputs["batch_files"]
    args = dataclasses.replace(args, data_files=list(data_files), batch_files=batch_files)
    partition = None
    part_path = prev.outputs.get("partition")
    if part_path and list(args.data_files) == list(prev.inputs.get("data_files", [])):
        with np.load(part_path) as z:
            partition = {
                "fine_groups": z["fine_groups"],
                "level_maps": [z[k] for k in sorted(z.files) if k.startswith("map")],
            }
        log.info("inherited cell->pb partition from %s", part_path)
    log.info("inherited inputs from %s", args.from_run)
    return args, partition


def _apply_qc(vec, args: TopicArgs, device) -> tuple[object, str]:
    """`--qc`: per-cell statistics, the keep mask, the `{out}.qc` table,
    and the view over the kept cells."""
    from ..data.qc import compute_cell_qc

    stats = compute_cell_qc(vec, block_size=args.block_size, device=device)
    keep = stats.keep_mask(
        min_total=args.qc_min_total, min_genes=args.qc_min_genes,
        max_mito_frac=args.qc_max_mito_frac,
    )
    path = write_table(f"{args.out}.qc", {
        "cell": np.asarray(vec.column_names()), "total": stats.total, "n_genes": stats.n_genes,
        "mito_frac": stats.mito_frac, "keep": keep,
    })
    log.info("qc: keeping %d/%d cells", int(keep.sum()), vec.num_columns)
    return vec.subset_columns(keep), path


def coarse_feature_targets(max_features: int, n_levels: int) -> list[int]:
    """Per-level meta-feature targets, finest first: `max_features` down
    to `max(max_features // n_levels, 50)`."""
    floor = max(max_features // n_levels, 50)
    fracs = [i / (n_levels - 1) if n_levels > 1 else 0.0 for i in range(n_levels)]
    return [int(round(max_features - f * (max_features - floor))) for f in fracs]


def fit_topic_model(args: TopicArgs, *, vec: SparseIoVec | None = None, device="cuda") -> dict:
    """End-to-end `senna topic`. `vec` overrides `args.data_files`."""
    check_supported(args)
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    partition = None
    if args.from_run:
        args, partition = _inherit_run(args)
    if vec is None:
        vec = load_data_vec(args.data_files, args.batch_files)
    if args.preload_data:
        vec = _preload(vec)
    d = vec.num_rows
    log.info("topic fit: D=%d genes, N=%d cells", d, vec.num_columns)
    warm = None
    if args.init_from:
        # warm start: a strict architecture check before any work
        meta, flat, _ = load_model(args.init_from)
        if (meta["n_topics"] != args.n_latent_topics or meta["n_features"] != d
                or list(meta["encoder_layers"]) != list(args.encoder_layers)):
            raise ValueError(
                "init-from architecture mismatch: "
                f"{meta} vs K={args.n_latent_topics}, D={d}, layers={args.encoder_layers}"
            )
        warm = params_from_jax({n: v for n, v in flat.items() if n.startswith("params/")})
    written = {}
    if args.qc:
        t0 = time.time()
        vec, written["qc"] = _apply_qc(vec, args, device)
        timings["qc_s"] = time.time() - t0

    levels = load_and_collapse(vec, args, partition=partition, timings=timings, device=device)
    n_levels = len(levels.collapsed)
    keys = prng.split(prng.key(args.seed & 0x7FFFFFFF), 1 + n_levels)
    key = keys[0]
    t0 = time.time()
    level_data = [
        sample_collapsed_data(out, k, device) for out, k in zip(levels.collapsed, keys[1:])
    ]
    timings["sample_s"] = time.time() - t0

    # per-level coarsening of the decoder targets (the encoder keeps D)
    coarsenings = [None] * n_levels
    if args.max_coarse_features and args.max_coarse_features < d:
        from ..ops.feature_coarsening import compute_feature_coarsening

        t0 = time.time()
        finest_profile = levels.collapsed[0].mu_observed.mean().cpu().numpy()
        for i, target in enumerate(coarse_feature_targets(args.max_coarse_features, n_levels)):
            fc = compute_feature_coarsening(
                finest_profile, target, seed=args.seed & 0x7FFFFFFF, device=device
            )
            coarsenings[i] = fc
            level_data[i].output = fc.aggregate_columns_nd(level_data[i].target).astype(np.float32)
        timings["coarsening_s"] = time.time() - t0
        log.info("coarse features per level: %s", [fc.num_coarse for fc in coarsenings])

    t0 = time.time()
    k_init, k_train = prng.split(key)
    init_gen = prng.generator_from_key(k_init)
    k = args.n_latent_topics
    names = decoder_names(args.decoder)
    multi = len(names) > 1
    encoder = LogSoftmaxEncoder(d, k, tuple(args.encoder_layers), generator=init_gen)

    def make_decoder(name: str, n_feat: int):
        kw = {}
        if name == "nb-mixture":
            kw = dict(rho_prior_weight=args.rho_prior_weight, rho_prior_alpha=args.rho_prior_alpha,
                      rho_prior_beta=args.rho_prior_beta)
        return DECODERS[name](n_feat, k, generator=init_gen, **kw)

    decoders = []
    for fc in coarsenings:
        n_feat = fc.num_coarse if fc is not None else d
        fams = [make_decoder(nm, n_feat) for nm in names]
        decoders.append(fams if multi else fams[0])
    timings["model_init_s"] = time.time() - t0

    feature_weights = [None] * n_levels
    t0 = time.time()
    if args.gene_weighting == "nb-fisher":
        from ..ops.gene_stats import nb_fisher_weights

        fw = nb_fisher_weights(vec, block_size=args.block_size, device=device)
        for i, fc in enumerate(coarsenings):
            if fc is None:
                feature_weights[i] = fw
            else:  # a coarse feature averages its members' weights
                sums = np.bincount(fc.fine_to_coarse, weights=fw, minlength=fc.num_coarse)
                cnts = np.bincount(fc.fine_to_coarse, minlength=fc.num_coarse)
                feature_weights[i] = (sums / np.maximum(cnts, 1)).astype(np.float32)
    timings["gene_weights_s"] = time.time() - t0

    # anchor prior: archetypal finest pseudobulks (selected in the finest
    # level's coarse features) initialise every level's dictionary, and,
    # with --anchor-penalty, add a CE penalty on every decoder
    t0 = time.time()
    finest = levels.collapsed[0]
    finest_plane = finest.mu_adjusted if finest.mu_adjusted is not None else finest.mu_observed
    finest_mean = finest_plane.mean().cpu().numpy()
    anchor = anchor_weights = None
    if finest_mean.shape[1] >= 2:
        from .anchor import AnchorPrior

        anchor = AnchorPrior.from_pseudobulk(finest_mean, k, finest_coarsening=coarsenings[0])
        if args.anchor_penalty > 0:
            anchor_weights = anchor.per_level_weights(coarsenings)
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
        anchor_weights=anchor_weights, anchor_penalty=args.anchor_penalty,
        decoder_weights=args.decoder_weights, device=device,
    )
    timings["train_setup_s"] = time.time() - t0
    init_dictionaries = None
    if warm is not None:  # the saved weights overlay the fresh ones, no anchor init
        trainer.warm_start(*warm)
        log.info("warm start from %s applied", args.init_from)
    elif anchor is not None and multi:
        log.info("multi-decoder: anchor prior via CE penalty only")
    elif anchor is not None and names[0] != "gaussian-nb":
        # (the JAX package's overlay leaves gaussian-nb's loading matrix
        # at its init: the anchor logits land beside it, unused)
        init_dictionaries = [anchor.init_logits(fc) for fc in coarsenings]
    t0 = time.time()
    scores = trainer.train(
        level_data, prng.generator_from_key(k_train, device), init_dictionaries=init_dictionaries
    )
    timings["train_s"] = time.time() - t0

    # the finest level's dictionaries (log beta [D, K]; the first family's
    # is `{out}.dictionary`), a coarsened one expanded back to D
    finest_decs = trainer.level_decoders(0)

    def full_log_dict(dec) -> np.ndarray:
        with torch.no_grad():
            ld = dec.get_dictionary().cpu().numpy()
        return coarsenings[0].expand_log_dict_dk(ld) if coarsenings[0] is not None else ld

    log_beta = full_log_dict(finest_decs[0])
    t0 = time.time()
    z = evaluate_latent_by_encoder(
        vec, trainer.encoder, finest, levels.groups_per_level[0],
        block_size=args.minibatch_size * 8, adj_method=args.adj_method,
        refine_log_dict=torch.from_numpy(np.ascontiguousarray(log_beta, np.float32))
        if args.amort_refine_steps > 0 else None,
        refine_steps=args.amort_refine_steps, refine_lr=args.amort_refine_lr,
        refine_reg=args.amort_refine_reg, device=device,
    )
    timings["cell_eval_s"] = time.time() - t0

    # ---- outputs -------------------------------------------------------
    t0 = time.time()
    cell_names = vec.column_names()
    gene_names = np.asarray(vec.row_names())
    written["dictionary"] = write_table(
        f"{args.out}.dictionary", matrix_columns(log_beta, "topic", "gene", gene_names)
    )
    if multi:
        for nm, dec in zip(names, finest_decs):
            written[f"{nm}.dictionary"] = write_table(
                f"{args.out}.{nm}.dictionary",
                matrix_columns(full_log_dict(dec), "topic", "gene", gene_names),
            )
    written["latent"] = write_table(
        f"{args.out}.latent", matrix_columns(z, "topic", "cell", cell_names)
    )

    pb_log_z = trainer.encode(level_data[0].input, level_data[0].input_null)
    written["pb_latent"] = write_table(f"{args.out}.pb_latent", matrix_columns(np.exp(pb_log_z), "topic"))
    if finest.delta is not None:
        delta = finest.delta.mean().cpu().numpy()
        written["delta"] = write_table(
            f"{args.out}.delta",
            {"gene": gene_names, **{b: delta[:, i] for i, b in enumerate(vec.batch_names())}},
        )
    written.update(write_nuisance_tables(args.out, names, finest_decs, coarsenings[0], gene_names))
    written["log_likelihood"] = write_table(
        f"{args.out}.log_likelihood",
        {"epoch": np.arange(len(scores.llik)), "llik": np.asarray(scores.llik), "kl": np.asarray(scores.kl)},
    )
    if args.cnv:
        # CNV side-channel: per-pseudobulk copy-number states of the finest
        # level's means (adjusted when batch correction ran) against their
        # cross-pseudobulk shared profile
        from ..cocoa.cnv_call import call_cnv_on_residuals

        t_cnv = time.time()
        cnv = call_cnv_on_residuals(finest_mean, finest_mean.mean(1),
                                    genes_per_bin=args.cnv_genes_per_bin, device=device)
        n_pb, n_bins = cnv.states.shape
        written["cnv"] = write_table(f"{args.out}.cnv", {
            "pseudobulk": np.repeat(np.arange(n_pb), n_bins),
            "bin": np.tile(np.arange(n_bins), n_pb),
            "state": cnv.states.ravel(),
            "log_ratio": cnv.log_ratio.ravel(),
        })
        timings["cnv_s"] = time.time() - t_cnv
        log.info("cnv side-channel: %d pbs x %d bins", n_pb, n_bins)
    save_model(args.out, trainer_params(trainer), args, d, gene_names)
    part_path = f"{args.out}.partition.npz"
    np.savez(
        part_path,
        fine_groups=levels.groups_per_level[0].astype(np.int32),
        **{f"map{i:02d}": m.astype(np.int32) for i, m in enumerate(levels.level_maps)},
    )
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    manifest = RunManifest(
        command="topic",
        inputs={
            "data_files": list(args.data_files),
            "batch_files": list(args.batch_files) if args.batch_files else [],
        },
        outputs={
            **written,
            "model": f"{args.out}.model.npz",
            "model_metadata": f"{args.out}.model.json",
        },
        params=dataclasses.asdict(args),
        timings=timings,
        engine="legume-tpu-torch",
    )
    # the artifacts' kinds and scales, as the JAX package records them
    manifest.record_artifact("latent", written["latent"], "cell_latent",
                             ArtifactScale.detect(z, axis=1))
    manifest.record_artifact("pb_latent", written["pb_latent"], "pb_latent",
                             ArtifactScale.PROBABILITY_SIMPLEX_COLUMNS)
    manifest.record_artifact("dictionary", written["dictionary"], "topic_dictionary",
                             ArtifactScale.detect(log_beta, axis=0))
    manifest.record_artifact("partition", part_path, "cell_pb_partition", ArtifactScale.SIGNED)
    manifest.save(args.out)

    return {
        "scores": scores,
        "trainer": trainer,
        "levels": levels,
        "level_data": level_data,
        "coarsenings": coarsenings,
        "latent": z,
        "log_beta": log_beta,
        "timings": timings,
    }


def write_nuisance_tables(out: str, names, decoders, coarsening, gene_names) -> dict:
    """Per family (suffixed `.{family}` when there are several): the NB
    dispersion, and for nb-mixture the ambient profile `alpha` (a coarse
    group's mass spread evenly over its genes) and the `rho` sigmoid's
    coefficients. Returns `{name: path}`."""
    written = {}
    f2c = None if coarsening is None else coarsening.fine_to_coarse
    for nm, dec in zip(names, decoders):
        stem = f"{nm}." if len(names) > 1 else ""
        with torch.no_grad():
            if hasattr(dec, "log_phi"):
                phi = torch.exp(dec.log_phi).cpu().numpy().ravel()
                written[f"{stem}dispersion"] = write_table(
                    f"{out}.{stem}dispersion",
                    {"gene": gene_names, "dispersion": phi if f2c is None else phi[f2c]},
                )
            if nm == "nb-mixture":
                alpha = torch.softmax(dec.log_alpha.ravel(), dim=0).cpu().numpy()
                if f2c is not None:
                    alpha = (alpha / np.maximum(coarsening.group_sizes(), 1))[f2c]
                written[f"{stem}alpha"] = write_table(
                    f"{out}.{stem}alpha", {"gene": gene_names, "alpha": alpha}
                )
                written[f"{stem}rho"] = write_table(f"{out}.{stem}rho", {
                    "coef": np.asarray(["rho_a", "rho_b"]),
                    "value": np.asarray([float(dec.rho_a.ravel()[0]), float(dec.rho_b.ravel()[0])]),
                })
    return written


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
    refine_log_dict: torch.Tensor | None = None,
    refine_steps: int = 0,
    refine_lr: float = 0.01,
    refine_reg: float = 1.0,
    device="cuda",
) -> np.ndarray:
    """Per-cell latent: stream cell blocks through the eval encoder with
    each cell's null row. "residual" indexes mu_residual [D, S] by the
    pseudobulk group, "batch" indexes delta [D, B] by the batch label.
    `refine_steps > 0` refines each block's latent against the frozen
    `refine_log_dict` [D, K] (`predict.refine_topic_proportions`; the
    block of `block_size` cells is the refinement's mean)."""
    if adj_method == "batch" and finest.delta is not None:
        null_ds, membership = finest.delta.mean(), vec.batch_membership()
    else:
        null_ds = finest.mu_residual.mean() if finest.mu_residual is not None else None
        membership = groups
    null_sd = None if null_ds is None else null_ds.T.contiguous().to(device)
    memb = torch.as_tensor(np.asarray(membership, np.int64), device=device)
    encoder.eval()
    pieces = []
    refine = refine_steps > 0 and refine_log_dict is not None
    if refine:
        from .predict import refine_topic_proportions

        ld = refine_log_dict.to(device)
    for blk in visit_columns_by_block(vec, block_size=block_size):
        r, p, v = rp.block_to_device(blk, device)
        log_z = encode_block(
            encoder, r, p, v, null_sd, memb[blk.lb : blk.lb + blk.ncols], num_genes=vec.num_rows
        )
        if refine:
            x = sparse_ops.densify_block(r, sparse_ops.col_ids_from_ptr(p), v, ncols=blk.ncols,
                                         num_genes=vec.num_rows)
            log_z = refine_topic_proportions(log_z, x, ld, steps=refine_steps, lr=refine_lr,
                                             reg=refine_reg)
        pieces.append(log_z)
    if not pieces:
        return np.zeros((0, encoder.n_topics), np.float32)
    return torch.cat(pieces).cpu().numpy()


def trainer_params(trainer: MixedTrainer) -> dict[str, np.ndarray]:
    """A dense trainer's weights in the JAX package's flat layout."""
    levels = [
        [d.state_dict() for d in dec] if isinstance(dec, torch.nn.ModuleList) else dec.state_dict()
        for dec in trainer.decoders
    ]
    return params_to_jax(trainer.encoder.state_dict(), levels)


def save_model(out: str, flat: dict, args, n_features: int, gene_names, *,
               model_type: str = "topic", extra_meta: dict | None = None):
    """Flat weights `{"a/b/c": array}` and the JAX package's metadata, so
    either package loads a model the other saved; `model_type` (topic,
    vae, masked-*) selects predict's dispatch."""
    np.savez(f"{out}.model.npz", **flat)
    meta = {
        "model_type": model_type,
        "n_topics": getattr(args, "n_latent_topics", getattr(args, "n_latent", 0)),
        "n_features": n_features,
        "encoder_layers": list(getattr(args, "encoder_layers", ())),
        "decoder": getattr(args, "decoder", ""),
        "num_levels": getattr(args, "num_levels", 1),
        "gene_names_file": f"{out}.genes.txt",
        **(extra_meta or {}),
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
    """(encoder, per level a decoder or a list of them, one per family of
    `meta["decoder"]`) holding saved weights: a `vae` model's Gaussian
    encoder and gaussian-nb decoders, else the topic encoder. Each
    decoder is sized from its saved weights, so a coarsened level's is
    narrower than D."""
    encoder = build_encoder(meta, flat, device)
    _, dec_states = params_from_jax(flat)
    vae = meta.get("model_type", "topic") == "vae"
    names = ["gaussian-nb"] if vae else decoder_names(meta.get("decoder") or "nb")

    def build(name, state):
        if name == "gaussian-nb":
            # a JAX topic run's anchor overlay may leave unused logits here
            state = {key: v for key, v in state.items() if key != "dictionary"}
            n_topics, n_feat = state["dictionary.kernel"].shape
        else:
            n_topics, n_feat = state["dictionary"].shape
        dec = DECODERS[name](n_feat, n_topics)
        dec.load_state_dict(state)
        return dec.to(device)

    decoders = []
    for state in dec_states:
        states = state if isinstance(state, list) else [state]
        if len(states) != len(names):
            raise ValueError(f"model has {len(states)} decoders a level, metadata names {names}")
        fams = [build(nm, st) for nm, st in zip(names, states)]
        decoders.append(fams if isinstance(state, list) else fams[0])
    return encoder, decoders


def build_encoder(meta: dict, flat: dict, device="cuda"):
    """The saved encoder alone, at eval: a `vae` model's Gaussian
    encoder, else the topic encoder."""
    enc_state, _ = params_from_jax(flat)
    vae = meta.get("model_type", "topic") == "vae"
    encoder = (GaussianEncoder if vae else LogSoftmaxEncoder)(
        meta["n_features"], meta["n_topics"], tuple(meta["encoder_layers"]))
    encoder.load_state_dict(enc_state)
    return encoder.to(device).eval()
