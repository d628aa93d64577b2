"""`faba annotate` — marker-set cell-type annotation of a gem run
(`faba/src/annotate/{run,by_enrichment}.rs` +
`graph-embedding-util/src/type_annotation.rs` equivalents).

Two modes, chosen from `{from}.gem.json` when `--mode` is absent
(`run.rs resolve_mode` — choosing wrong does not error, it answers
wrong, so the producer's manifest decides):

  - **projection** (embedding runs): Euclidean nearest marker centroid
    in the co-embedded gene/cell space → distance-outlier QC → Leiden
    clustering → cluster × type hypergeometric over-representation,
    permutation-calibrated → BH call + Q matrix → optional TreeBH
    Cell-Ontology layer → marker-panel stability bootstrap. Tracks:
    spliced (β_g vs θ) and velocity (δ_g rows vs the velocity
    increment).
  - **enrichment** (topic runs): per-factor weighted-KS marker
    over-representation on the dictionary's specificity ranking
    (never forming a cell↔gene inner product — that direction is a
    gauge freedom a topic model's likelihood never pins,
    `by_enrichment.rs` module doc), carried to cells through θ.
    Tracks: spliced and nascent.

Declared divergences (MIGRATION.md): the enrichment nulls are the
stratified gene-permutation null from `ops/enrichment.py`
(`gene_strata.rs` twin); the reference's correlation-preserving
pseudobulk-shuffle null runs only when the `{from}.pb_gene` /
`{from}.pb_latent` pair exists.

The port's copy of the JAX package's `faba/annotate.py`: the cell kNN
graph and the enrichment Q-matrices run on `device` (default `cuda`)
through the port's `ops/leiden.py::knn_adjacency` and
`ops/enrichment.py::geneset_topic_qmatrix`; Leiden, the ORA tests and
the bootstrap stay on the host with the same `rng` draws. The bootstrap
builds the cell graph once: the JAX package rebuilds the same graph from
the same cells in every replicate.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

UNASSIGNED = "unassigned"


# ---------------------------------------------------------------- #
# Mode resolution ({from}.gem.json manifest; run.rs resolve_mode)   #
# ---------------------------------------------------------------- #


def detect_run_kind(prefix: str) -> str | None:
    """model_type from `{prefix}.gem.json` ('topic' | 'embedding'),
    None when the manifest is absent (pre-manifest run / typo'd
    prefix)."""
    path = f"{prefix}.gem.json"
    if not os.path.exists(path):
        return None
    try:
        return json.load(open(path)).get("model_type")
    except (OSError, ValueError):
        return None


def resolve_mode(prefix: str, requested: str | None) -> str:
    kind = detect_run_kind(prefix)
    if requested == "projection" and kind == "topic":
        log.warning(
            "--mode projection on a TOPIC model (%s.gem.json): "
            "nearest-centroid forms a cell-gene inner product a topic "
            "model does not identify; prefer --mode enrichment.", prefix,
        )
        return requested
    if requested is not None:
        return requested
    if kind is not None:
        mode = "enrichment" if kind == "topic" else "projection"
        log.info("--mode not given; %s.gem.json reports %s -> %s",
                 prefix, kind, mode)
        return mode
    log.warning(
        "no %s.gem.json — cannot tell which program produced this "
        "prefix; falling back to --mode projection.", prefix,
    )
    return "projection"


# ---------------------------------------------------------------- #
# Marker parsing (type_annotation/markers.rs)                       #
# ---------------------------------------------------------------- #


def parse_and_match_markers(
    path: str,
    gene_names: list,
    *,
    use_idf: bool = True,
    min_markers: int = 3,
    min_panel_coverage: float = 0.0,
) -> tuple[list, list]:
    """(type_names, per-type [(gene_idx, weight)]) from a
    gene<TAB>celltype TSV or GMT. IDF down-weights markers shared
    across many types; a type with fewer than `min_markers` matched
    genes is dropped; `min_panel_coverage` > 0 refuses a panel the
    gene axis mostly never saw (`markers.rs` semantics)."""
    from .lineage_run import load_marker_sets

    sets = load_marker_sets(path)
    name_to_idx = {str(g).lower(): i for i, g in enumerate(gene_names)}
    n_types = max(len(sets), 1)
    counts: dict[str, int] = {}
    for genes in sets.values():
        for g in set(map(str.lower, map(str, genes))):
            counts[g] = counts.get(g, 0) + 1

    total = matched_total = 0
    type_names, type_markers = [], []
    for t, genes in sets.items():
        entries = []
        for g in genes:
            total += 1
            j = name_to_idx.get(str(g).lower())
            if j is None:
                continue
            matched_total += 1
            w = (np.log1p(n_types / counts[str(g).lower()])
                 if use_idf else 1.0)
            entries.append((j, float(w)))
        if len(entries) >= min_markers:
            type_names.append(t)
            type_markers.append(entries)
        else:
            log.info("dropping type %r: %d matched markers < %d",
                     t, len(entries), min_markers)
    coverage = matched_total / max(total, 1)
    if min_panel_coverage > 0 and coverage < min_panel_coverage:
        raise ValueError(
            f"marker panel coverage {coverage:.2f} below "
            f"--min-panel-coverage {min_panel_coverage}: the embedding "
            "mostly never saw this panel's genes"
        )
    log.info("markers: %d types, %d/%d matched entries (coverage %.2f)",
             len(type_names), matched_total, total, coverage)
    return type_names, type_markers


# ---------------------------------------------------------------- #
# Projection mode (type_annotation/score.rs + run.rs)               #
# ---------------------------------------------------------------- #


@dataclass
class ProjectionResult:
    cell_assign: np.ndarray  # [N] type index, -1 unassigned
    assign_dist: np.ndarray  # [N]
    clusters: np.ndarray  # [N] Leiden community
    cluster_call: list  # [C] type name or UNASSIGNED
    cluster_p: np.ndarray  # [C] permutation p of the winning term
    cluster_q: np.ndarray  # [C] BH q
    qmatrix: np.ndarray  # [C, T] row-normalized over significant terms
    type_names: list
    support: np.ndarray | None = None  # [C] bootstrap support
    support_p: np.ndarray | None = None  # [C] support-null p
    label_sets: list | None = None  # [C] mixed-annotation sets
    panel_bias_p: np.ndarray | None = None  # [T]
    ontology_q: dict = field(default_factory=dict)


def _type_centroids(feature_emb, type_markers, h):
    cen = np.zeros((len(type_markers), h), np.float64)
    for t, entries in enumerate(type_markers):
        idx = np.array([j for j, _ in entries])
        w = np.array([w for _, w in entries])
        c = (feature_emb[idx] * w[:, None]).sum(0) / max(w.sum(), 1e-12)
        cen[t] = c
    nrm = np.linalg.norm(cen, axis=1, keepdims=True)
    return cen / np.maximum(nrm, 1e-12)


def _assign_cells(cell_emb, centroids, *, assign_qc, assign_mad):
    """Nearest-centroid assignment with the MAD distance-outlier gate
    (`score.rs` assignment + QC)."""
    zn = cell_emb / np.maximum(
        np.linalg.norm(cell_emb, axis=1, keepdims=True), 1e-12
    )
    d2 = 2.0 - 2.0 * (zn @ centroids.T)  # squared Euclidean on the sphere
    assign = d2.argmin(1)
    dist = np.sqrt(np.maximum(d2[np.arange(len(zn)), assign], 0.0))
    if assign_qc:
        med = np.median(dist)
        mad = np.median(np.abs(dist - med)) * 1.4826
        out = dist > med + assign_mad * max(mad, 1e-9)
        assign = np.where(out, -1, assign)
    return assign.astype(np.int64), dist.astype(np.float32)


def _cluster_ora(
    assign: np.ndarray, clusters: np.ndarray, n_types: int,
    *, n_perm: int, rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster × type over-representation: hypergeometric survival of
    each type's assigned cells within each cluster, calibrated by
    permuting the assignment vector (`type_annotation.rs` cluster×term
    ORA). Returns (score [C,T], perm_p [C,T])."""
    from scipy.stats import hypergeom

    n = len(assign)
    c_ids = np.unique(clusters)
    n_c = len(c_ids)
    cl_idx = np.searchsorted(c_ids, clusters)
    n_cl = np.bincount(cl_idx, minlength=n_c)  # [C]
    k_t = np.array([(assign == t).sum() for t in range(n_types)])  # [T]

    def tally(a):
        """[C, T] joint counts of (cluster, assigned type)."""
        k_ct = np.zeros((n_c, n_types), np.int64)
        ok = a >= 0
        np.add.at(k_ct, (cl_idx[ok], a[ok]), 1)
        return k_ct

    def ora(k_ct):
        # vectorized hypergeometric survival over the [C, T] table
        return -hypergeom.logsf(
            np.maximum(k_ct - 1, -1), n, k_t[None, :], n_cl[:, None]
        )

    score = ora(tally(assign))
    if n_perm <= 0:
        # analytic p from the hypergeometric tail alone
        return score, np.exp(-score)
    # one gather per permutation, one vectorized sf over all draws —
    # the permuted assignment is re-tallied, not re-looped
    null = np.stack([
        tally(assign[rng.permutation(n)]) for _ in range(n_perm)
    ])  # [R, C, T]
    null_score = -hypergeom.logsf(
        np.maximum(null - 1, -1), n, k_t[None, None, :],
        n_cl[None, :, None],
    )
    p = (1 + (null_score >= score[None]).sum(0)) / (n_perm + 1)
    return score, p


def annotate_projection(
    feature_emb: np.ndarray,  # [G, H]
    gene_names: list,
    cell_emb: np.ndarray,  # [N, H]
    cell_names: list,
    markers_path: str,
    *,
    use_idf: bool = True,
    min_markers: int = 3,
    min_panel_coverage: float = 0.0,
    knn: int = 15,
    resolution: float = 1.0,
    seed: int = 42,
    n_perm: int = 200,
    assign_qc: bool = True,
    assign_mad: float = 3.0,
    fdr_alpha: float = 0.05,
    q_temperature: float = 1.0,
    panel_perm: int = 0,
    support_perm: int = 0,
    bootstrap: bool = True,
    n_boot: int = 100,
    recluster: bool = True,
    min_support: float = 0.5,
    abstain_separable: bool = False,
    abstain_alpha: float = 0.05,
    set_coverage: float = 0.8,
    max_set_size: int = 3,
    obo: str | None = None,
    label_cl: str | None = None,
    ontology_fdr_q: float = 0.05,
    ontology_by: bool = False,
    device="cuda",
) -> ProjectionResult:
    """The projection scorer (`annotate_embeddings_ora` pipeline)."""
    from ..ops.leiden import knn_adjacency, leiden_clustering
    from .lineage import benjamini_hochberg

    h = feature_emb.shape[1]
    if cell_emb.shape[1] != h:
        raise ValueError(
            f"embedding dim mismatch: features H={h}, cells "
            f"H={cell_emb.shape[1]}"
        )
    rng = np.random.default_rng(seed)
    type_names, type_markers = parse_and_match_markers(
        markers_path, gene_names, use_idf=use_idf,
        min_markers=min_markers, min_panel_coverage=min_panel_coverage,
    )
    if len(type_names) < 2:
        raise ValueError(
            f"need >= 2 cell types with matched markers, found "
            f"{len(type_names)}"
        )
    n_types = len(type_names)
    centroids = _type_centroids(feature_emb, type_markers, h)
    assign, dist = _assign_cells(
        cell_emb, centroids, assign_qc=assign_qc, assign_mad=assign_mad
    )

    # Leiden on the cosine kNN graph of cells
    zn = cell_emb / np.maximum(
        np.linalg.norm(cell_emb, axis=1, keepdims=True), 1e-12
    )
    adj = knn_adjacency(zn, k=min(knn, len(zn) - 1), device=device)
    clusters = leiden_clustering(
        adj, resolution=resolution, seed=seed
    ).membership
    c_ids = np.unique(clusters)
    n_c = len(c_ids)
    log.info("projection: %d cells -> %d Leiden clusters, %d types",
             len(cell_emb), n_c, n_types)

    score, p = _cluster_ora(assign, clusters, n_types, n_perm=n_perm,
                            rng=rng)
    q = benjamini_hochberg(p.ravel()).reshape(p.shape)
    sig = q <= fdr_alpha
    call, p_call, q_call = [], np.ones(n_c), np.ones(n_c)
    for ci in range(n_c):
        if sig[ci].any():
            t = int(np.where(sig[ci], score[ci], -np.inf).argmax())
            call.append(type_names[t])
            p_call[ci] = p[ci, t]
            q_call[ci] = q[ci, t]
        else:
            call.append(UNASSIGNED)
    # Q matrix: softmax over SIGNIFICANT terms only (q_temperature)
    qm = np.zeros((n_c, n_types))
    for ci in range(n_c):
        if sig[ci].any():
            s = np.where(sig[ci], score[ci] / max(q_temperature, 1e-6),
                         -np.inf)
            s = s - s.max()
            e = np.exp(s)
            qm[ci] = e / e.sum()

    res = ProjectionResult(
        cell_assign=assign, assign_dist=dist, clusters=clusters,
        cluster_call=call, cluster_p=p_call, cluster_q=q_call,
        qmatrix=qm, type_names=type_names,
    )

    # panel permutation null: the BIAS guard the bootstrap cannot give
    # (panel_null.rs). One type on trial at a time, rivals held REAL;
    # the statistic is the assignment COST Σ_i min(d²(i, centroid_t),
    # bar_i) — NOT occupancy, which only measures whether any rival is
    # nearby (the reference measured 0.337 vs 0.333 occupancy on a
    # clean synthetic, p = 0.995). Null panels draw |panel_t| genes
    # from the LIVE marker pool, keeping t's weight multiset, so the
    # small-panel winner's curse appears on both sides and divides out.
    if panel_perm > 0:
        znq = cell_emb / np.maximum(
            np.linalg.norm(cell_emb, axis=1, keepdims=True), 1e-12
        )
        d2_all = np.maximum(2.0 - 2.0 * (znq @ centroids.T), 0.0)  # [N,T]
        pool = np.unique(np.concatenate([
            [j for j, _ in entries] for entries in type_markers
        ]))
        bias_p = np.ones(n_types)
        for t in range(n_types):
            rivals = np.delete(d2_all, t, axis=1)
            bar = rivals.min(1) if n_types > 1 else np.full(
                len(znq), np.inf)
            cost_real = float(np.minimum(d2_all[:, t], bar).sum())
            weights = [w for _, w in type_markers[t]]
            m = len(weights)
            beats = 0
            for _ in range(panel_perm):
                draw = rng.choice(pool, m, replace=m > len(pool))
                fake = list(zip(draw.tolist(), weights))
                cen_t = _type_centroids(feature_emb, [fake], h)[0]
                d2_t = np.maximum(2.0 - 2.0 * (znq @ cen_t), 0.0)
                if float(np.minimum(d2_t, bar).sum()) <= cost_real:
                    beats += 1
            bias_p[t] = (1 + beats) / (panel_perm + 1)
        res.panel_bias_p = bias_p

    if bootstrap and n_boot > 0:
        res = _projection_bootstrap(
            res, feature_emb, cell_emb, type_markers, type_names,
            assign_qc=assign_qc, assign_mad=assign_mad, knn=knn,
            resolution=resolution, n_boot=n_boot, recluster=recluster,
            min_support=min_support, abstain_separable=abstain_separable,
            abstain_alpha=abstain_alpha, set_coverage=set_coverage,
            max_set_size=max_set_size, support_perm=support_perm,
            n_perm=n_perm, fdr_alpha=fdr_alpha, rng=rng, seed=seed,
            adj=adj,
        )

    if obo is not None and label_cl is not None:
        res.ontology_q = _ontology_layer(
            res, obo, label_cl, ontology_fdr_q, ontology_by
        )
    return res


def _projection_bootstrap(
    res, feature_emb, cell_emb, type_markers, type_names, *,
    assign_qc, assign_mad, knn, resolution, n_boot, recluster,
    min_support, abstain_separable, abstain_alpha, set_coverage,
    max_set_size, support_perm, n_perm, fdr_alpha, rng, seed, adj,
):
    """Stability bootstrap: resample each panel WITH replacement (and
    optionally recluster under a fresh seed), re-call every cluster;
    support = fraction of resamples agreeing with the base call
    (`marker_bootstrap.rs`). Abstain by threshold or by the
    top-vs-runner-up sign test (`--abstain-separable`). `adj` is the
    cell graph of the base call: a replicate reclusters that graph
    under a fresh seed."""
    from scipy.stats import binomtest

    from ..ops.leiden import leiden_clustering
    from .lineage import benjamini_hochberg

    n_c = len(res.cluster_call)
    n_types = len(type_names)
    h = feature_emb.shape[1]
    wins = np.zeros((n_c, n_types), np.int64)
    for r in range(n_boot):
        panels = [
            [entries[i] for i in rng.integers(0, len(entries),
                                              len(entries))]
            for entries in type_markers
        ]
        cen_r = _type_centroids(feature_emb, panels, h)
        a_r, _ = _assign_cells(cell_emb, cen_r, assign_qc=assign_qc,
                               assign_mad=assign_mad)
        if recluster:
            cl_r = leiden_clustering(
                adj, resolution=resolution,
                seed=int(rng.integers(2**31)),
            ).membership
        else:
            cl_r = res.clusters
        score_r, _ = _cluster_ora(a_r, cl_r, n_types, n_perm=0, rng=rng)
        call_r = score_r.argmax(1)
        # map each base cluster to the replicate cluster holding the
        # plurality of its cells
        cl_r_ids = np.unique(cl_r)
        for ci, c in enumerate(np.unique(res.clusters)):
            members = res.clusters == c
            twin = np.bincount(
                np.searchsorted(cl_r_ids, cl_r[members]),
                minlength=len(cl_r_ids),
            ).argmax()
            wins[ci, call_r[twin]] += 1

    support = np.array([
        wins[ci, type_names.index(res.cluster_call[ci])] / n_boot
        if res.cluster_call[ci] != UNASSIGNED else 0.0
        for ci in range(n_c)
    ])
    res.support = support
    # abstain rule
    for ci in range(n_c):
        if res.cluster_call[ci] == UNASSIGNED:
            continue
        if abstain_separable:
            order = np.argsort(wins[ci])[::-1]
            top, runner = int(wins[ci][order[0]]), int(wins[ci][order[1]])
            if top + runner > 0:
                pv = binomtest(top, top + runner, 0.5,
                               alternative="greater").pvalue
                if pv > abstain_alpha:
                    res.cluster_call[ci] = UNASSIGNED
        elif support[ci] < min_support:
            res.cluster_call[ci] = UNASSIGNED
    # label sets: smallest set of types covering set_coverage of wins
    label_sets = []
    for ci in range(n_c):
        order = np.argsort(wins[ci])[::-1]
        tot = wins[ci].sum()
        acc, chosen = 0, []
        for t in order:
            if tot == 0 or len(chosen) >= max_set_size:
                break
            chosen.append(type_names[t])
            acc += wins[ci][t]
            if acc / tot >= set_coverage:
                break
        label_sets.append(
            "|".join(chosen) if len(chosen) <= max_set_size else UNASSIGNED
        )
    res.label_sets = label_sets
    # support permutation null -> p-value on the observed support
    if support_perm > 0:
        null = np.zeros((support_perm, n_c))
        for r in range(support_perm):
            w = rng.multinomial(n_boot, np.ones(n_types) / n_types,
                                size=n_c)
            null[r] = w.max(1) / n_boot
        res.support_p = (1 + (null >= support[None]).sum(0)) / (
            support_perm + 1)
    return res


def _ontology_layer(res, obo, label_cl, fdr_q, use_by):
    """TreeBH Cell-Ontology layer over the per-cluster calls: map each
    called label to its CL id, take the per-cluster winning p as the
    term's p (best across clusters), and run the hierarchical BH over
    the CL DAG (`ontology_obo.rs` + `enrichment/treebh.rs`)."""
    from ..data.knowledge import parse_obo
    from ..ops.enrichment import treebh

    lut = {}
    with open(label_cl) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                lut[parts[0].lower()] = parts[1]
    onto = parse_obo(obo)
    pvals: dict[str, float] = {}
    for ci, lab in enumerate(res.cluster_call):
        cl = lut.get(str(lab).lower())
        if cl is None:
            continue
        p = float(res.cluster_p[ci])
        if use_by:
            # Benjamini-Yekutieli inflation within the family
            m = max(len(res.cluster_call), 1)
            p = min(1.0, p * np.log(m) + p)
        pvals[cl] = min(p, pvals.get(cl, 1.0))
    if not pvals:
        return {}
    return treebh(pvals, onto, alpha=fdr_q)


# ---------------------------------------------------------------- #
# Enrichment mode (annotate/by_enrichment.rs)                       #
# ---------------------------------------------------------------- #


def annotate_enrichment(
    log_beta: np.ndarray,  # [G, K] log dictionary
    gene_names: list,
    log_theta: np.ndarray,  # [N, K] log θ
    cell_names: list,
    markers_path: str,
    *,
    min_markers: int = 3,
    min_panel_coverage: float = 0.0,
    n_perm: int = 200,
    fdr_alpha: float = 0.05,
    q_temperature: float = 1.0,
    seed: int = 42,
    bootstrap: bool = True,
    n_boot: int = 100,
    min_support: float = 0.5,
    pb_gene: np.ndarray | None = None,  # [G, P]
    pb_log_theta: np.ndarray | None = None,  # [P, K]
    device="cuda",
) -> dict:
    """Marker over-representation per topic factor, carried to cells
    through θ (`by_enrichment.rs run`): the factor × type edges come
    from the weighted-KS walk over the dictionary's simplex
    specificity; when the pseudobulk pair is given, the null ALSO
    recomputes β̃ = pb_gene · shuffled-membership to destroy the
    PB↔topic coupling while preserving gene-gene correlation."""
    from ..ops.enrichment import geneset_topic_qmatrix
    from .lineage import benjamini_hochberg
    from .lineage_run import load_marker_sets

    sets = load_marker_sets(markers_path)
    gene_pool = {str(g).lower() for g in gene_names}
    kept = {
        t: g for t, g in sets.items()
        if sum(str(x).lower() in gene_pool for x in g) >= min_markers
    }
    if min_panel_coverage > 0:
        total = sum(len(g) for g in sets.values())
        matched = sum(
            sum(str(x).lower() in gene_pool for x in g)
            for g in sets.values()
        )
        if matched / max(total, 1) < min_panel_coverage:
            raise ValueError(
                f"marker panel coverage {matched / max(total, 1):.2f} "
                f"below --min-panel-coverage {min_panel_coverage}"
            )
    if len(kept) < 2:
        raise ValueError("need >= 2 cell types with matched markers")

    # GOseq-style abundance stratification needs a real abundance
    # spread; on a (near-)constant axis the tie-broken strata become
    # index-contiguous and every "matched" null draw is the panel
    # itself (null ≡ observed → z = 0 for a truly enriched set)
    abundance = np.exp(np.asarray(log_beta, np.float64)).sum(1)
    stratify = len(np.unique(np.round(abundance, 12))) > 10
    qres = geneset_topic_qmatrix(
        np.asarray(log_beta, np.float64).T, list(gene_names), kept,
        n_perm=n_perm, specificity="simplex", seed=seed,
        stratify=stratify, device=device,
    )
    labels = qres["labels"]
    z = np.asarray(qres["z"])  # [T, K]
    es = np.asarray(qres["es"])
    p = np.asarray(qres["pvalue"])
    q = np.asarray(qres["q"])

    if pb_gene is not None and pb_log_theta is not None:
        # correlation-preserving null: shuffle the pseudobulk rows of
        # the membership, rebuild β̃, re-run the walk; a factor×type
        # edge must beat BOTH nulls (by_enrichment.rs module doc)
        rng = np.random.default_rng(seed)
        pb_theta = np.exp(np.asarray(pb_log_theta, np.float64))
        null_es = np.zeros((max(n_perm // 4, 8),) + es.shape)
        for r in range(null_es.shape[0]):
            perm = rng.permutation(pb_theta.shape[0])
            beta_tilde = np.asarray(pb_gene, np.float64) @ pb_theta[perm]
            beta_tilde /= np.maximum(beta_tilde.sum(0, keepdims=True),
                                     1e-300)
            nr = geneset_topic_qmatrix(
                np.log(np.maximum(beta_tilde, 1e-300)).T,
                list(gene_names), kept, n_perm=1, specificity="simplex",
                seed=seed + r + 1, device=device,
            )
            null_es[r] = np.asarray(nr["es"])
        p_pb = (1 + (null_es >= es[None]).sum(0)) / (null_es.shape[0] + 1)
        q_pb = benjamini_hochberg(p_pb.ravel()).reshape(p_pb.shape)
        sig = (q <= fdr_alpha) & (q_pb <= fdr_alpha)
    else:
        sig = q <= fdr_alpha
    # over-REPRESENTATION only: the same-sign permutation tail also
    # hands small p to significant DEPLETION (es < 0), and a depletion
    # edge must never name a factor
    sig &= es > 0

    # carry factor×type edges to cells through θ
    theta = np.exp(np.asarray(log_theta, np.float64))
    theta /= np.maximum(theta.sum(1, keepdims=True), 1e-300)
    zs = np.where(sig, z, -np.inf)  # [T, K]
    # per-cell type score: θ-weighted significant enrichment
    cell_scores = theta @ np.where(sig, z, 0.0).T  # [N, T]
    best = cell_scores.argmax(1)
    called = cell_scores[np.arange(len(theta)), best] > 0
    cell_labels = [
        labels[b] if ok else UNASSIGNED for b, ok in zip(best, called)
    ]
    # per-factor call + Q matrix over significant edges
    factor_call = []
    k = z.shape[1]
    qm = np.zeros((k, len(labels)))
    for kk in range(k):
        col = zs[:, kk]
        if np.isfinite(col).any() and col.max() > -np.inf:
            factor_call.append(labels[int(col.argmax())])
            s = col / max(q_temperature, 1e-6)
            s = s - s[np.isfinite(s)].max()
            e = np.where(np.isfinite(s), np.exp(s), 0.0)
            qm[kk] = e / max(e.sum(), 1e-300)
        else:
            factor_call.append(UNASSIGNED)

    support = None
    if bootstrap and n_boot > 0:
        rng = np.random.default_rng(seed + 7)
        wins = np.zeros((k, len(labels)), np.int64)
        for _ in range(n_boot):
            panels = {
                t: list(rng.choice(g, len(g), replace=True))
                for t, g in kept.items()
            }
            br = geneset_topic_qmatrix(
                np.asarray(log_beta, np.float64).T, list(gene_names),
                panels, n_perm=1, specificity="simplex",
                seed=int(rng.integers(2**31)), device=device,
            )
            wins[np.arange(k), np.asarray(br["es"]).argmax(0)] += 1
        support = wins.max(1) / n_boot
        for kk in range(k):
            if (factor_call[kk] != UNASSIGNED
                    and support[kk] < min_support):
                factor_call[kk] = UNASSIGNED

    return {
        "labels": labels, "z": z, "p": p, "q": q, "sig": sig,
        "factor_call": factor_call, "qmatrix": qm,
        "cell_labels": cell_labels, "cell_scores": cell_scores,
        "factor_support": support,
    }
