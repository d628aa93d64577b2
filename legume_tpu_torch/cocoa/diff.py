"""`cocoa diff`: counterfactual confounder-adjusted differential
expression (the port of the JAX package's `cocoa/diff.py`).

Flow: inputs -> optional collider fix on the topic proportions ->
projection (kernel K1 on the card) and a pseudobulk partition -> match
cache (reused across runs through a file beside the data) ->
topic-weighted matched statistics -> per-topic Gamma fit -> exposure
contrast -> permutation null (the cache replayed under permuted
exposures, every column read once for all of them) -> optional CNV
side-channel on the exposure posteriors -> tables (effect, shared,
residual, pvalue, cnv.*) and a `{out}.cocoa.json` manifest.

`--data-parallel` (the multi-GPU layer) is not ported and raises
`NotImplementedError`. The CNV side-channel orders genes by `--gff`
(faba's GFF reader), which takes precedence over `--cnv-ground-truth`.
"""

from __future__ import annotations

import gzip
import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import random_projection as rp
from ..utils.manifest import RunManifest
from ..utils.output import read_table, write_table
from ..utils.prng import DEFAULT_PROJECTION_SEED
from .collapse import (
    build_match_cache,
    collect_cocoa_stat,
    collect_cocoa_stat_multi,
    load_match_cache,
    match_cache_file,
    match_cache_key,
    save_match_cache,
)
from .stat import (
    compute_exposure_contrast,
    estimate_parameters,
    exposure_log_means,
    remove_exposure_effect_from_topic_proportions,
    z_to_pvalue,
)

log = logging.getLogger(__name__)


@dataclass
class CocoaDiffArgs:
    """The flags of the JAX package's `cocoa diff`, same names and defaults."""

    data_files: Sequence[str] = ()
    out: str = "cocoa"
    indv_file: str = ""  # cell -> individual (one label per line)
    exposure_file: str = ""  # individual TAB exposure
    topic_file: Optional[str] = None  # latent table (cell topic proportions)
    topic_assignment_file: Optional[str] = None  # hard per-cell topic labels
    topic_proportion_value: str = "prob"  # prob | logit
    covariate_file: Optional[str] = None  # individual covariates [I, C] tsv
    n_pb_samples: int = 10
    knn: int = 10
    n_opt_iter: int = 100
    n_permutations: int = 0
    permutation_seed: Optional[int] = None  # defaults to seed
    proj_dim: int = 30
    collider_fix: bool = True
    adjust_housekeeping: bool = True
    a0: float = 1.0
    b0: float = 1.0
    gff: Optional[str] = None
    cnv_ground_truth: Optional[str] = None
    cnv_states: int = 3
    cnv_gmm_k_max: int = 0
    cnv_ref_iters: int = 2
    seed: int = DEFAULT_PROJECTION_SEED
    data_parallel: bool = False
    match_cache: bool = True


def check_supported(args: CocoaDiffArgs):
    if args.data_parallel:
        raise NotImplementedError("cocoa diff port does not support --data-parallel yet")


def assign_pseudobulk(cell_indv: np.ndarray, proj_nk: np.ndarray, n_samples: int, seed: int,
                      *, device="cuda") -> np.ndarray:
    """Cells into pseudobulk samples by projection sign codes."""
    codes = rp.binary_sort_columns(proj_nk.T.copy(), int(np.ceil(np.log2(n_samples))),
                                   seed=seed, device=device)
    groups, s = rp.compact_group_codes(codes)
    if s > n_samples:
        groups = groups % n_samples
    return groups.astype(np.int64)


def _lines(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def run_cocoa_diff(args: CocoaDiffArgs, *, vec=None, device="cuda") -> dict:
    """End-to-end `cocoa diff`. `vec`, when given, holds the cells in
    place of reading `args.data_files`; the match cache is still read
    from and written beside `args.data_files[0]` when files are named."""
    from ..senna.topic import load_data_vec

    check_supported(args)
    device = torch.device(device)
    timings: dict = {}
    if vec is None:
        vec = load_data_vec(args.data_files)
    n, d = vec.num_columns, vec.num_rows

    indv_names, cell_indv = np.unique(np.asarray(_lines(args.indv_file)), return_inverse=True)
    n_indv = len(indv_names)
    table = {p[0]: int(p[1]) for p in (line.split() for line in _lines(args.exposure_file))}
    exposure = np.asarray([table[str(name)] for name in indv_names], np.int64)

    if args.topic_assignment_file:
        lab = np.asarray(_lines(args.topic_assignment_file))
        if len(lab) != n:
            raise ValueError(f"topic assignment lists {len(lab)} cells, data has {n}")
        _, codes = np.unique(lab, return_inverse=True)
        z = np.eye(int(codes.max()) + 1, dtype=np.float32)[codes]
    elif args.topic_file:
        cols = read_table(args.topic_file)
        z = np.stack([np.asarray(cols[c], np.float32) for c in list(cols)[1:]], axis=1)
        if args.topic_proportion_value == "logit":
            z = np.exp(z - z.max(1, keepdims=True))
        elif np.all(z <= 0):
            z = np.exp(z)
    else:
        z = np.ones((n, 1), np.float32)
    z = z / np.maximum(z.sum(1, keepdims=True), 1e-30)

    covariates = None
    if args.covariate_file:
        covariates = np.loadtxt(args.covariate_file, delimiter="\t", dtype=np.float64, ndmin=2)
        if len(covariates) != n_indv:
            raise ValueError(f"covariate file has {len(covariates)} rows, data has {n_indv} "
                             "individuals")
    if args.collider_fix and z.shape[1] > 1:
        z, max_shift = remove_exposure_effect_from_topic_proportions(
            z, cell_indv, exposure, covariates=covariates)
        z = z / np.maximum(z.sum(1, keepdims=True), 1e-30)
        log.info("collider fix: max |shift| per topic %s", np.round(max_shift, 3))

    gene_weights = None
    if args.adjust_housekeeping:
        from ..ops.gene_stats import nb_fisher_weights

        t0 = time.time()
        gene_weights = nb_fisher_weights(vec, device=device)
        timings["housekeeping_s"] = time.time() - t0

    t0 = time.time()
    _, proj_kn = rp.project_columns(vec, args.proj_dim, seed=args.seed, device=device)
    proj_nk = proj_kn.T.copy()
    timings["projection_s"] = time.time() - t0
    pb = assign_pseudobulk(cell_indv, proj_nk, args.n_pb_samples, args.seed, device=device)
    n_samples = int(pb.max()) + 1

    t0 = time.time()
    cache = cache_path = None
    if args.match_cache and args.data_files:
        key = match_cache_key(n, args.knn, n_indv, args.proj_dim, args.seed, cell_indv)
        cache_path = match_cache_file(args.data_files[0], key)
        cache = load_match_cache(cache_path)
        if cache is not None:
            log.info("match cache reused: %s", cache_path)
            timings["match_cache_reused"] = True
    if cache is None:
        cache = build_match_cache(proj_nk, cell_indv, n_indv, args.knn, device=device)
        if cache_path is not None:
            t1 = time.time()
            save_match_cache(cache, cache_path)
            timings["match_cache_save_s"] = time.time() - t1
    timings["match_cache_s"] = time.time() - t0

    pvalue = zscore = None
    fit = dict(n_opt_iter=args.n_opt_iter, a0=args.a0, b0=args.b0, device=device)
    if args.n_permutations > 0:
        perm_seed = args.permutation_seed if args.permutation_seed is not None else args.seed
        rng = np.random.default_rng(perm_seed & 0x7FFFFFFF)
        perms = [rng.permutation(exposure) for _ in range(args.n_permutations)]
        t0 = time.time()
        stats = collect_cocoa_stat_multi(vec, z, cell_indv, pb, n_samples,
                                         np.stack([exposure] + perms), cache,
                                         gene_weights=gene_weights, device=device)
        timings["stat_collect_all_exposures_s"] = time.time() - t0
        stat = stats[0]
        t0 = time.time()
        params = estimate_parameters(stat, **fit)
        effect = compute_exposure_contrast(params, exposure)
        null = np.zeros((args.n_permutations, d), np.float32)
        for t in range(args.n_permutations):
            null[t] = compute_exposure_contrast(estimate_parameters(stats[t + 1], **fit), perms[t])
        timings["gamma_fit_all_s"] = time.time() - t0
        zscore = (effect - null.mean(0)) / np.maximum(null.std(0), 1e-12)
        pvalue = z_to_pvalue(zscore)
    else:
        t0 = time.time()
        stat = collect_cocoa_stat(vec, z, cell_indv, pb, n_samples, exposure, cache,
                                  gene_weights=gene_weights, device=device)
        timings["stat_collect_s"] = time.time() - t0
        t0 = time.time()
        params = estimate_parameters(stat, **fit)
        effect = compute_exposure_contrast(params, exposure)
        timings["gamma_fit_s"] = time.time() - t0

    genes = np.asarray(vec.row_names())
    outputs: dict = {}
    cnv_run = None
    if args.gff or args.cnv_ground_truth:
        from .cnv_call import (call_per_sample_cnv, genome_order_from_gff,
                               genome_order_from_truth_tsv, segments_bed_rows)

        t0 = time.time()
        order = (genome_order_from_gff(list(genes), args.gff) if args.gff
                 else genome_order_from_truth_tsv(d, args.cnv_ground_truth))
        log_tau = exposure_log_means(params)  # [K, D, I]
        topic_names = [f"topic{k}" for k in range(log_tau.shape[0])]
        cnv_run = call_per_sample_cnv(
            log_tau, order, [str(x) for x in indv_names], topic_names,
            n_states=args.cnv_states, gmm_k_max=args.cnv_gmm_k_max,
            ref_iters=args.cnv_ref_iters, seed=args.seed & 0x7FFFFFFF, device=device,
        )
        gene_ord = genes[order.ordered]
        for name, plane in (("states", cnv_run.states), ("cn_score", cnv_run.cn_score)):
            outputs[f"cnv_{name}"] = write_table(
                f"{args.out}.cnv.{name}",
                {"gene": gene_ord, **dict(zip(cnv_run.sample_names, plane.T))})
        with gzip.open(f"{args.out}.cnv.normal_samples.tsv.gz", "wt") as f:
            for k, refs in enumerate(cnv_run.refs_per_topic):
                for i in refs:
                    f.write(f"{topic_names[k]}\t{indv_names[int(i)]}\n")
        outputs["cnv_segments"] = f"{args.out}.cnv.segments.bed.gz"
        with gzip.open(outputs["cnv_segments"], "wt") as f:
            for row in segments_bed_rows(cnv_run):
                f.write("\t".join(str(x) for x in row) + "\n")
        timings["cnv_s"] = time.time() - t0

    cols = {"gene": genes, "effect": effect}
    if cnv_run is not None:
        from .cnv_call import deg_concordance

        r, p, state = deg_concordance(cnv_run, d)
        cols.update(cnv_concordance_r=r, cnv_concordance_p=p, cnv_state=state)
    shared = params.shared.mean().mean(dim=(0, 2)).cpu().numpy()
    resid = params.residual.mean().mean(dim=(0, 2)).cpu().numpy()
    outputs = {
        "effect": write_table(f"{args.out}.effect", cols),
        **outputs,
        "shared": write_table(f"{args.out}.shared", {"gene": genes, "shared": shared}),
        "residual": write_table(f"{args.out}.residual", {"gene": genes, "residual": resid}),
    }
    if pvalue is not None:
        outputs["pvalue"] = write_table(f"{args.out}.pvalue",
                                        {"gene": genes, "pvalue": pvalue, "z": zscore})
    RunManifest(
        command="cocoa-diff", inputs={"data_files": list(args.data_files)}, outputs=outputs,
        timings=timings, engine="legume-tpu-torch",
    ).save(args.out, "cocoa.json")
    return {"effect": effect, "pvalue": pvalue, "z": zscore, "params": params, "stat": stat,
            "cache": cache, "proj_nk": proj_nk, "pb": pb, "cnv": cnv_run, "outputs": outputs,
            "timings": timings}


def run_cocoa_collapse(data_files, indv_file: str, out: str, *, iter_opt: int = 30,
                       a0: float = 1.0, b0: float = 1.0, adjust_housekeeping: bool = True,
                       block_size: int = 8192, vec=None, device="cuda") -> dict:
    """`cocoa collapse`: per-individual pseudobulk Gamma means. The sums
    per individual go through kernel K3 on the card
    (`ops/collapse.py::collect_basic_stats`)."""
    from ..ops import collapse as clp
    from ..senna.topic import load_data_vec

    if vec is None:
        vec = load_data_vec(data_files)
    names, groups = np.unique(np.asarray(_lines(indv_file)), return_inverse=True)
    stat = clp.collect_basic_stats(vec, groups.astype(np.int32), len(names),
                                   block_size=block_size, device=device)
    if adjust_housekeeping:
        from ..ops.gene_stats import nb_fisher_weights

        w = nb_fisher_weights(vec, block_size=block_size, device=device)
        stat.observed_sum_ds = stat.observed_sum_ds * w[:, None]
    fitted = clp.optimize(stat, num_iter=iter_opt, a0=a0, b0=b0, device=device)
    mu = fitted.mu_observed.mean().cpu().numpy()  # [D, I]
    path = write_table(f"{out}.pseudobulk", {"gene": np.asarray(vec.row_names()),
                                             **{str(nm): mu[:, j] for j, nm in enumerate(names)}})
    RunManifest(
        command="collapse", inputs={"data_files": list(data_files), "indv": indv_file},
        outputs={"pseudobulk": path}, engine="legume-tpu-torch",
    ).save(out, "cocoa.json")
    return {"mu": mu, "names": names, "outputs": {"pseudobulk": path}}
