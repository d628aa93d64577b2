"""Annotation statistics (the port of the JAX package's
`ops/enrichment.py`; the `enrichment` crate's weighted-KS GSEA `es.rs`,
permutation null `null.rs`, BH FDR `fdr.rs`, marker-based cell-type
scoring).

The enrichment-score sweep runs as cumulative sums over the ranked gene
axis, many masks at once in torch on `device` (default `cuda`). It is
float32 as in the JAX package, and every operation on it rounds alike
on the card and on the CPU: elementwise arithmetic, and cumulative sums
in the order of XLA's CPU backend (blocks of 16 summed in order, each
offset by the exclusive prefix of the block totals; `utils/prng.py::
cumsum_rows_f32`). The permutation null of `gsea_permutation_pvalue` draws
JAX's threefry permutations (`utils/prng.py`), so its p-values are
JAX's. The rest is numpy, copied, with numpy's generators as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import prng

UNASSIGNED_LABEL = "Unassigned"  # enrichment/src/lib.rs:35


def _es_curve(scores_sorted_desc: torch.Tensor, in_set: torch.Tensor, p: float = 1.0):
    """Weighted-KS enrichment scores (GSEA; es.rs) of masks `in_set`
    [B, D] (0/1, float32) against genes pre-ranked by score desc
    [D]: the signed extreme deviation of each row's running sum, [B]."""
    a = scores_sorted_desc.abs()
    w = (a if p == 1.0 else (a.double() ** p).float())[None, :] * in_set
    cw = prng.cumsum_rows_f32(w)
    cm = prng.cumsum_rows_f32(1.0 - in_set)
    nr = torch.clamp_min(cw[:, -1:], 1e-30)
    n_miss = torch.clamp_min(cm[:, -1:], 1.0)
    dev = cw / nr - cm / n_miss
    i_max = torch.argmax(dev.abs(), dim=1)  # the first maximum, as XLA's
    return dev.gather(1, i_max[:, None])[:, 0]


def _ranked(scores: np.ndarray, device):
    order = np.argsort(-scores)
    s = torch.from_numpy(np.asarray(scores[order], np.float32)).to(device)
    return order, s


def _masks(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.float32)).to(device)


def enrichment_score(scores: np.ndarray, gene_set_mask: np.ndarray, p: float = 1.0,
                     *, device="cuda") -> float:
    return float(enrichment_scores(scores, np.asarray(gene_set_mask)[None], p, device=device)[0])


def enrichment_scores(scores: np.ndarray, masks: np.ndarray, p: float = 1.0,
                      *, device="cuda") -> np.ndarray:
    """`enrichment_score` of each row of `masks` [B, D] against the same
    scores, in one pass: float32 [B]."""
    order, s = _ranked(scores, device)
    es = _es_curve(s, _masks(np.asarray(masks)[:, order], device), p)
    return es.cpu().numpy()


def gsea_permutation_pvalue(
    scores: np.ndarray,
    gene_set_mask: np.ndarray,
    *,
    n_permutations: int = 1000,
    seed: int = 0,
    device="cuda",
) -> tuple[float, float, float]:
    """(ES, normalized ES, permutation p) with the Efron-Tibshirani
    restandardized null (null.rs): permute set membership with the JAX
    package's threefry keys (`split(key(seed), n_permutations)`)."""
    order, s = _ranked(scores, device)
    mask = np.asarray(gene_set_mask[order], np.float32)
    keys = prng.split(prng.key(seed), n_permutations)
    rows = np.stack([mask] + [mask[prng.permutation(k, len(mask))] for k in keys])
    all_es = _es_curve(s, _masks(rows, device)).cpu().numpy()
    es_f, perms = float(all_es[0]), all_es[1:]
    same_sign = perms[np.sign(perms) == np.sign(es_f)]
    if len(same_sign) == 0:
        p = 1.0 / (n_permutations + 1)
        nes = es_f
    else:
        p = (np.sum(np.abs(same_sign) >= abs(es_f)) + 1) / (len(same_sign) + 1)
        nes = es_f / max(np.abs(same_sign).mean(), 1e-30)
    return es_f, float(nes), float(p)


def bh_fdr(pvalues: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted q-values (fdr.rs)."""
    p = np.asarray(pvalues, np.float64)
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    q = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(q, 0, 1)
    return out


def treebh(
    pvalues: dict[str, float],
    ontology,
    *,
    alpha: float = 0.05,
) -> dict[str, float]:
    """TreeBH hierarchical FDR over an ontology DAG
    (enrichment `treebh.rs`; Bogomolov et al. 2021).

    Tests proceed root-to-leaf: a term is tested only when at least one
    tested parent was rejected, within that parent's child family, with
    BH budget alpha * gamma where gamma is the running product of
    ancestor-family rejection fractions. Returns q-values rescaled by
    1/gamma so that `q <= alpha` reproduces the hierarchical decision
    (1.0 for never-tested terms).

    Depth and eligibility are computed over the TESTED subforest:
    ancestors absent from ``pvalues`` are transparent (a term whose
    only ancestors are untested counts as a root), so dropping
    uninformative roots does not wall off the rest of the DAG."""

    def tested_parents(t):
        """Nearest ancestors that are themselves tested."""
        out, stack, seen = set(), list(ontology.parents.get(t, ())), set()
        while stack:
            p = stack.pop()
            if p in seen:
                continue
            seen.add(p)
            if p in pvalues:
                out.add(p)
            else:
                stack.extend(ontology.parents.get(p, ()))
        return out

    tp = {t: tested_parents(t) for t in pvalues}
    depth: dict[str, int] = {}

    def get_depth(t):
        if t in depth:
            return depth[t]
        depth[t] = 0 if not tp[t] else 1 + max(get_depth(p) for p in tp[t])
        return depth[t]

    for t in pvalues:
        get_depth(t)
    max_d = max(depth.values(), default=0)

    # TreeBH descends family-by-family: children of a rejected node form
    # a family tested with BH at level alpha * gamma, where gamma is the
    # product of ancestor-family rejection fractions
    # (gamma_child_family = gamma_parent_family * n_rejected / n_family;
    # treebh.rs::descend). Reported q is the family-BH q rescaled by
    # 1/gamma so `q <= alpha` reproduces the selective-FDR decision.
    q_out = {t: 1.0 for t in pvalues}
    rejected: set = set()
    child_gamma: dict[str, float] = {}  # rejected node -> gamma for its child family

    def run_family(terms: list[str], gamma: float):
        p = np.asarray([pvalues[t] for t in terms])
        q = bh_fdr(p)
        n_rej = 0
        for t, qv in zip(terms, q):
            q_out[t] = float(min(1.0, qv / max(gamma, 1e-300)))
            if qv <= alpha * gamma:
                rejected.add(t)
                n_rej += 1
        frac = n_rej / len(terms)
        for t, qv in zip(terms, q):
            if qv <= alpha * gamma:
                child_gamma[t] = gamma * frac

    roots = [t for t in pvalues if depth[t] == 0]
    if roots:
        run_family(roots, 1.0)
    for d in range(1, max_d + 1):
        terms = [t for t in pvalues if depth[t] == d]
        # family key: the rejected tested-parent with the largest gamma
        # (a DAG child with several rejected parents is tested once, in
        # the most-powered family; ties break deterministically)
        families: dict[str, list[str]] = {}
        for t in terms:
            rej_parents = [p for p in tp[t] if p in rejected]
            if not rej_parents:
                continue
            fam = max(rej_parents, key=lambda p: (child_gamma[p], p))
            families.setdefault(fam, []).append(t)
        for fam in sorted(families):
            run_family(sorted(families[fam]), child_gamma[fam])
    return q_out


def geneset_topic_qmatrix(
    log_beta_kd: np.ndarray,  # [K, D] topic log-dictionary
    gene_names: list[str],
    gene_sets: dict[str, list[str]],
    *,
    n_perm: int = 500,
    specificity: str = "raw",
    stratify: bool = True,
    n_strata: int = 10,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The Q-matrix lens (enrichment/src/lib.rs annotate path): GSEA
    enrichment of every gene set against every topic's dictionary
    ranking -> Q [n_sets, K] of signed z-scores (vs a permutation
    null) + BH-adjusted p-values.

    `stratify` matches null gene sets on the abundance covariate
    (gene_strata.rs / GOseq fix); `specificity` applies the
    specificity.rs transform to the (linear) profile before ranking.
    The null draws come from numpy's generator in the JAX package's
    order; each (set, topic) scores its real set and its `n_perm` null
    sets in one pass."""
    rng = np.random.default_rng(seed)
    beta = np.asarray(log_beta_kd, np.float64)
    if specificity != "raw":
        prof = compute_specificity(np.exp(beta).T, specificity).T  # [K, D]
        beta = np.log(np.maximum(prof, 1e-300))
    k, d = beta.shape
    name_to_idx = {str(g).lower(): i for i, g in enumerate(gene_names)}
    sets = {
        lab: np.asarray(
            [name_to_idx[m.lower()] for m in genes if m.lower() in name_to_idx],
            np.int64,
        )
        for lab, genes in gene_sets.items()
    }
    sets = {lab: ids for lab, ids in sets.items() if len(ids)}
    labels = list(sets)

    es = np.zeros((len(labels), k))
    z = np.zeros((len(labels), k))
    pv = np.ones((len(labels), k))
    strata = abundance_strata(np.exp(beta).sum(axis=0), n_strata) if stratify else None
    for t in range(k):
        order = np.argsort(-beta[t])  # descending relevance
        rank_of = np.empty(d, np.int64)
        rank_of[order] = np.arange(d)
        scores = beta[t][order] - beta[t].mean()
        for li, lab in enumerate(labels):
            rows = np.zeros((n_perm + 1, d), bool)
            rows[0, rank_of[sets[lab]]] = True
            # permutation null: abundance-stratified sets (GOseq fix)
            # when stratify, else uniform same-size sets
            if strata is not None:
                draws = stratified_null_sets(rng, strata, sets[lab], n_perm)
                for b in range(n_perm):
                    rows[b + 1, rank_of[draws[b]]] = True
            else:
                for b in range(n_perm):
                    rows[b + 1, rng.choice(d, len(sets[lab]), replace=False)] = True
            all_es = enrichment_scores(scores, rows, device=device).astype(np.float64)
            es[li, t], null = all_es[0], all_es[1:]
            mu, sd = null.mean(), max(null.std(), 1e-12)
            z[li, t] = (es[li, t] - mu) / sd
            # same-sign tail (GSEA convention): the weighted-KS null is
            # asymmetric, a two-sided count loses power
            if es[li, t] >= 0:
                tail = null[null >= 0]
                pv[li, t] = (1 + np.sum(tail >= es[li, t])) / (len(tail) + 1)
            else:
                tail = null[null < 0]
                pv[li, t] = (1 + np.sum(tail <= es[li, t])) / (len(tail) + 1)
    q = bh_fdr(pv.ravel()).reshape(pv.shape)
    return {"labels": labels, "es": es, "z": z, "pvalue": pv, "q": q}


def annotate_ontology(
    mean_profiles: np.ndarray,  # [K, D] cluster mean expression
    gene_names: list[str],
    term_genes: dict[str, set],  # term -> gene symbols (GAF true-path)
    ontology,
    *,
    top_frac: float = 0.1,
    alpha: float = 0.05,
    term_names: dict[str, str] | None = None,
) -> dict:
    """Ontology-consensus annotation (`senna annotate-ontology`):
    per cluster, hypergeometric enrichment of each ontology term in the
    cluster's top-expressed genes, TreeBH-adjusted down the DAG; the
    consensus label is the DEEPEST term that stays significant (the
    most specific claim the hierarchy supports)."""
    from scipy.stats import hypergeom

    prof = np.asarray(mean_profiles, np.float64)
    kk, d = prof.shape
    # rank genes by the cluster's deviation from the cross-cluster mean
    # (NOT a z-score: with K <= 2 clusters the per-gene std collapses
    # and z degenerates to +/-1 ties, making the top-gene cut arbitrary)
    z = prof - prof.mean(0, keepdims=True) if kk > 1 else prof
    name_set = {str(g).lower(): i for i, g in enumerate(gene_names)}
    term_ids = {
        t: {name_set[g.lower()] for g in genes if g.lower() in name_set}
        for t, genes in term_genes.items()
    }
    # drop empty and near-universal terms (a root annotated to every
    # gene can never be enriched; treebh treats its children as roots)
    term_ids = {
        t: ids for t, ids in term_ids.items() if ids and len(ids) < 0.5 * d
    }

    n_top = max(int(d * top_frac), 5)
    labels, qvals, all_q = [], [], []
    for c in range(kk):
        top = set(np.argsort(-z[c])[:n_top].tolist())
        pvals = {}
        for t, ids in term_ids.items():
            x = len(top & ids)
            if x == 0:
                pvals[t] = 1.0
                continue
            pvals[t] = float(hypergeom.sf(x - 1, d, len(ids), n_top))
        q = treebh(pvals, ontology, alpha=alpha)
        all_q.append(q)
        sig = [t for t, qv in q.items() if qv <= alpha]
        if not sig:
            labels.append(UNASSIGNED_LABEL)
            qvals.append(1.0)
            continue

        def _depth(t, seen=()):
            ps = ontology.parents.get(t, ())
            return 0 if not ps else 1 + max(_depth(p) for p in ps)

        best = max(sig, key=lambda t: (_depth(t), -q[t]))
        nice = term_names.get(best, best) if term_names else best
        labels.append(nice)
        qvals.append(q[best])
    return {"labels": labels, "q": np.asarray(qvals), "per_cluster_q": all_q}


def annotate_by_markers(
    mean_profiles: np.ndarray,  # [K, D] cluster/topic mean expression
    gene_names: list[str],
    marker_sets: dict[str, list[str]],
    *,
    min_score: float = 0.0,
) -> tuple[list[str], np.ndarray]:
    """Marker-panel annotation: per cluster, score each label's marker
    set by the mean z-scored expression of its genes; assign argmax or
    UNASSIGNED (enrichment marker core + `annotate-by-enrichment`)."""
    name_to_idx = {str(g).lower(): i for i, g in enumerate(gene_names)}
    prof = np.asarray(mean_profiles, np.float64)
    z = (prof - prof.mean(0, keepdims=True)) / np.maximum(prof.std(0, keepdims=True), 1e-8)

    labels = list(marker_sets)
    scores = np.full((prof.shape[0], len(labels)), -np.inf)
    for li, lab in enumerate(labels):
        ids = [name_to_idx[m.lower()] for m in marker_sets[lab] if m.lower() in name_to_idx]
        if not ids:
            continue
        scores[:, li] = z[:, ids].mean(axis=1)
    best = scores.argmax(1)
    out = [
        labels[b] if scores[i, b] > min_score else UNASSIGNED_LABEL
        for i, b in enumerate(best)
    ]
    return out, scores


def compute_specificity(
    profile_gk: np.ndarray, mode: str = "raw"
) -> np.ndarray:
    """Specificity transforms on a G x K group profile
    (enrichment/src/specificity.rs):
    - raw: no transform (training-time NB-Fisher weighting already
      suppressed housekeeping; default for topic kinds)
    - simplex: beta_gk / sum_k max(beta_gk, 0) — a second housekeeping
      adjustment
    - abs: |beta_gk| / sum_k |beta_gk| for signed profiles (SVD kinds)
    """
    p = np.asarray(profile_gk, np.float64)
    if mode == "raw":
        return p
    if mode == "simplex":
        pos = np.maximum(p, 0.0)
        s = pos.sum(axis=1, keepdims=True)
        return np.divide(pos, s, out=np.zeros_like(pos), where=s > 0)
    if mode == "abs":
        a = np.abs(p)
        s = a.sum(axis=1, keepdims=True)
        return np.divide(a, s, out=np.zeros_like(a), where=s > 0)
    raise ValueError(f"unknown specificity mode {mode!r}")


def abundance_strata(abundance: np.ndarray, n_strata: int = 10) -> np.ndarray:
    """Stratum id per gene by abundance quantile
    (enrichment/src/gene_strata.rs; GOseq bias fix, Young et al. 2010):
    null gene sets must match the REAL set's abundance composition,
    else argmax labels reward well-expressed panels over biology."""
    a = np.asarray(abundance, np.float64)
    qs = np.quantile(a, np.linspace(0, 1, n_strata + 1)[1:-1])
    return np.searchsorted(qs, a, side="right").astype(np.int64)


def stratified_null_sets(
    rng: np.random.Generator,
    strata: np.ndarray,  # [D] stratum per gene
    set_ids: np.ndarray,  # the real set's gene indices
    n_draws: int,
) -> np.ndarray:
    """[n_draws, |set|] null gene sets matched on the real set's
    per-stratum counts (uniform WITHIN each stratum)."""
    d = len(strata)
    by_stratum = {s: np.flatnonzero(strata == s) for s in np.unique(strata)}
    s_of_set, cnt = np.unique(strata[set_ids], return_counts=True)
    out = np.empty((n_draws, len(set_ids)), np.int64)
    for b in range(n_draws):
        parts = []
        for s, c in zip(s_of_set, cnt):
            pool = by_stratum[s]
            parts.append(rng.choice(pool, c, replace=len(pool) < c))
        out[b] = np.concatenate(parts)
    return out


def marker_bootstrap(
    mean_profiles: np.ndarray,  # [K, D] cluster profiles
    gene_names: list[str],
    marker_sets: dict[str, list[str]],
    *,
    n_boot: int = 100,
    support_threshold: float = 0.6,
    min_score: float = 0.0,
    seed: int = 0,
) -> dict:
    """Marker-panel stability bootstrap
    (enrichment/src/marker_bootstrap.rs): resample every label's panel
    WITH replacement, re-score, re-call the winner per cluster; a
    cluster's call ships with the fraction of resamples that agreed
    (cluster_label_support) and abstains below the threshold — the
    cross-label winner's curse dies with the resampling."""
    rng = np.random.default_rng(seed)
    base_names, _ = annotate_by_markers(
        mean_profiles, gene_names, marker_sets, min_score=min_score
    )
    k = mean_profiles.shape[0]
    agree = np.zeros(k)
    for _ in range(n_boot):
        resampled = {
            lab: list(rng.choice(genes, len(genes), replace=True))
            for lab, genes in marker_sets.items()
            if len(genes)
        }
        names_b, _ = annotate_by_markers(
            mean_profiles, gene_names, resampled, min_score=min_score
        )
        agree += np.asarray(
            [names_b[i] == base_names[i] for i in range(k)], float
        )
    support = agree / max(n_boot, 1)
    final = [
        n if s >= support_threshold else UNASSIGNED_LABEL
        for n, s in zip(base_names, support)
    ]
    return {
        "annotation": final,
        "base_annotation": base_names,
        "cluster_label_support": support,
    }


def label_cells(
    cell_membership_nk: np.ndarray,  # [N, K] topic proportions
    q_kc: np.ndarray,  # [K, C] FDR-sparse Q matrix
    celltype_names: list[str],
    *,
    min_confidence: float = 0.0,
) -> tuple[np.ndarray, list[str], np.ndarray]:
    """Cell-level projection P = theta . Q, row-normalized, argmax
    (enrichment/src/cellproj.rs label_cells): returns (posterior
    [N, C], labels, confidence). Zero-mass rows and low-confidence
    calls get UNASSIGNED."""
    theta = np.asarray(cell_membership_nk, np.float64)
    q = np.maximum(np.asarray(q_kc, np.float64), 0.0)
    post = theta @ q
    post = np.maximum(post, 0.0)
    s = post.sum(axis=1, keepdims=True)
    post = np.divide(post, s, out=np.zeros_like(post), where=s > 1e-12)
    best = post.argmax(axis=1)
    conf = post[np.arange(len(post)), best]
    labels = [
        celltype_names[b] if conf[i] > max(min_confidence, 1e-12)
        else UNASSIGNED_LABEL
        for i, b in enumerate(best)
    ]
    return post, labels, conf.astype(np.float32)


def ontology_module_score(
    profile_gk: np.ndarray,  # [G, K] cluster expression profiles
    terms: dict,  # name -> list of gene INDICES (or names via gene_names)
    universe: "np.ndarray | None" = None,
    *,
    gene_names: "list | None" = None,
) -> dict:
    """Descriptive GO/GMT module score with a cross-cluster contrast
    (enrichment/src/ontology_enrich.rs:88-153): per cluster, the term
    score is mean log-CP10K of member genes minus the non-member mean;
    the term's cross-cluster MEDIAN subtracts out, so a signature high
    in EVERY cluster (housekeeping/common) cancels to ~0 while a
    cluster-specific one survives. Returns {"effect_kt" [K, T],
    "terms" [T]}."""
    prof = np.asarray(profile_gk, np.float64)
    g, k = prof.shape
    if k < 2:
        raise ValueError("need >= 2 clusters to contrast")
    if universe is None:
        universe = np.arange(g)
    universe = np.asarray(universe)
    # log CP10K per cluster over the background universe
    sub = prof[universe]
    tot = np.maximum(sub.sum(0, keepdims=True), 1e-12)
    lge = np.log1p(1e4 * sub / tot)  # [n_bg, K]
    pos_of = {int(u): i for i, u in enumerate(universe)}

    name_to_idx = None
    if gene_names is not None:
        name_to_idx = {str(n).lower(): i for i, n in enumerate(gene_names)}

    names = list(terms)
    effect = np.zeros((k, len(names)))
    n_bg = len(universe)
    total_k = lge.sum(0)  # [K]
    for ti, name in enumerate(names):
        members = terms[name]
        if name_to_idx is not None:
            idxs = [name_to_idx.get(str(m).lower()) for m in members]
            idxs = [i for i in idxs if i is not None]
        else:
            idxs = [int(m) for m in members]
        bg_idx = [pos_of[i] for i in idxs if i in pos_of]
        m = len(bg_idx)
        if m < 1 or n_bg - m < 1:
            continue
        sum_in = lge[bg_idx].sum(0)  # [K]
        s = sum_in / m - (total_k - sum_in) / (n_bg - m)
        effect[:, ti] = s - np.median(s)
    return {"effect_kt": effect, "terms": names}
