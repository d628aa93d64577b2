"""Frozen-embedding cell-type annotation (the port's copy of the JAX
package's `embedding/type_annotation.py`; graph-embedding-util
`type_annotation.rs:1-48` equivalent).

Type signature = L2-normalized (weighted) centroid of the type's
marker FEATURE embeddings; per-cell score = cosine(cell embedding,
signature); calibration = permutation z-score against signatures built
from random same-size marker sets (the permutation-moment z of the
reference). Assignment takes the best calibrated score, or
UNASSIGNED below `min_z`. The cell kNN of `annotate_two_layer` runs on
`device` (default `cuda`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..ops.enrichment import UNASSIGNED_LABEL

log = logging.getLogger(__name__)


@dataclass
class TypeAnnotation:
    labels: list
    scores: np.ndarray  # [N, T] cosine scores
    zscores: np.ndarray  # [N, T] permutation-calibrated


def annotate_by_projection(
    cell_emb: np.ndarray,  # [N, H]
    feat_emb: np.ndarray,  # [D, H] frozen feature embeddings
    gene_names: list,
    marker_sets: dict,
    *,
    n_permutations: int = 100,
    min_z: float = 2.0,
    seed: int = 0,
) -> TypeAnnotation:
    rng = np.random.default_rng(seed)
    name_to_idx = {str(g).lower(): i for i, g in enumerate(gene_names)}
    d, h = feat_emb.shape
    fe = feat_emb / np.maximum(np.linalg.norm(feat_emb, axis=1, keepdims=True), 1e-9)
    ce = cell_emb / np.maximum(np.linalg.norm(cell_emb, axis=1, keepdims=True), 1e-9)

    def signature(ids):
        c = fe[ids].mean(0)
        return c / max(np.linalg.norm(c), 1e-9)

    types = list(marker_sets)
    scores = np.zeros((len(ce), len(types)), np.float32)
    z = np.zeros_like(scores)
    for t, ty in enumerate(types):
        ids = [name_to_idx[m.lower()] for m in marker_sets[ty] if m.lower() in name_to_idx]
        if not ids:
            scores[:, t] = -np.inf
            continue
        s = ce @ signature(np.asarray(ids))
        # permutation null: random same-size marker sets
        null = np.stack(
            [ce @ signature(rng.choice(d, len(ids), replace=False)) for _ in range(n_permutations)],
            axis=1,
        )
        mu, sd = null.mean(1), np.maximum(null.std(1), 1e-9)
        scores[:, t] = s
        z[:, t] = (s - mu) / sd

    best = z.argmax(1)
    labels = [
        types[b] if z[i, b] >= min_z else UNASSIGNED_LABEL for i, b in enumerate(best)
    ]
    return TypeAnnotation(labels=labels, scores=scores, zscores=z)


@dataclass
class TwoLayerAnnotation:
    fine: TypeAnnotation
    coarse_labels: list  # [N] merged-group label per cell
    communities: np.ndarray  # [N] Leiden community per cell
    group_of_type: dict  # fine type -> coarse group name
    hub_calls: dict  # community -> label voted by hub cells
    term_ora: "dict | None"  # community -> [(term, pvalue)] when terms given


def _lexical_common_name(members: list) -> str:
    """Name a merged group by the lexical commonality of its members
    (type_annotation.rs coarse naming), falling back to a join."""
    parts = [str(m).replace("_", " ").split() for m in members]
    common = []
    for tokens in zip(*parts):
        if len(set(t.lower() for t in tokens)) == 1:
            common.append(tokens[0])
        else:
            break
    return " ".join(common) if common else "+".join(sorted(str(m) for m in members))


def annotate_two_layer(
    cell_emb: np.ndarray,
    feat_emb: np.ndarray,
    gene_names: list,
    marker_sets: dict,
    *,
    knn: int = 15,
    resolution: float = 1.0,
    n_permutations: int = 100,
    min_z: float = 2.0,
    term_genes: dict | None = None,
    seed: int = 0,
    device="cuda",
) -> TwoLayerAnnotation:
    """Two-layer fine/coarse annotation (type_annotation.rs:14-24):

    a low-dim embedding cannot resolve more directions than it has
    room for, so nested fine types over-type. Cluster the CELLS
    (cosine kNN + Leiden), merge fine types that peak on the same
    community into one coarse group (named by lexical commonality),
    and keep the fine layer alongside. Adds per-community HUB calls
    (majority label among the most-connected cells) and optional
    term-ORA (hypergeometric over-representation of ontology-term
    genes among each community's assigned marker genes)."""
    from ..ops.leiden import knn_adjacency, leiden_clustering

    fine = annotate_by_projection(
        cell_emb, feat_emb, gene_names, marker_sets,
        n_permutations=n_permutations, min_z=min_z, seed=seed,
    )
    ce = cell_emb / np.maximum(np.linalg.norm(cell_emb, axis=1, keepdims=True), 1e-9)
    adj = knn_adjacency(ce.astype(np.float32), k=min(knn, len(ce) - 1), device=device)
    res = leiden_clustering(adj, resolution=resolution, seed=seed)
    comm = np.asarray(res.membership)
    n_comm = res.n_communities
    types = list(marker_sets)

    # each fine type peaks on the community where it is most ENRICHED:
    # per-community mean z, centered on the type's cross-community mean
    # and weighted by sqrt(community size) — a tiny community's mean has
    # standard error ~ 1/sqrt(n), so raw means let noise-inflated small
    # communities steal the peak (type_annotation/coarsen.rs:51-73).
    # Types sharing a peak community merge into one coarse group.
    comm_size = np.asarray([(comm == c).sum() for c in range(n_comm)])
    peak_of_type = {}
    for t, ty in enumerate(types):
        if not np.isfinite(fine.zscores[:, t]).any():
            continue
        means = np.asarray(
            [fine.zscores[comm == c, t].mean() if (comm == c).any() else 0.0
             for c in range(n_comm)]
        )
        centered = means - means[comm_size > 0].mean()
        score = np.where(
            comm_size > 0, centered * np.sqrt(np.maximum(comm_size, 1)), -np.inf
        )
        peak_of_type[ty] = int(score.argmax())
    groups: dict[int, list] = {}
    for ty, c in peak_of_type.items():
        groups.setdefault(c, []).append(ty)
    group_of_type = {}
    for c, members in groups.items():
        name = _lexical_common_name(members)
        for ty in members:
            group_of_type[ty] = name

    coarse_labels = [
        group_of_type.get(lab, lab) if lab != UNASSIGNED_LABEL else lab
        for lab in fine.labels
    ]

    # hub calls: per community, the label voted by its most-connected
    # cells (the embedding-graph hubs; type_annotation.rs hub calls)
    deg = np.asarray(adj.sum(1)).ravel()
    hub_calls = {}
    for c in range(n_comm):
        cells = np.nonzero(comm == c)[0]
        if len(cells) == 0:
            continue
        hubs = cells[np.argsort(-deg[cells])[: max(3, len(cells) // 10)]]
        votes: dict[str, int] = {}
        for i in hubs:
            votes[coarse_labels[i]] = votes.get(coarse_labels[i], 0) + 1
        hub_calls[c] = max(votes, key=votes.get)

    # term-ORA: over-representation of ontology-term genes among the
    # marker genes of each community's assigned fine types
    ora = None
    if term_genes:
        from scipy.stats import hypergeom

        background = set()
        for genes in marker_sets.values():
            background.update(str(g).lower() for g in genes)
        bg = len(background)
        ora = {}
        fine_arr = np.asarray(fine.labels, dtype=object)
        for c in range(n_comm):
            present = set(fine_arr[comm == c]) - {UNASSIGNED_LABEL}
            pool: set = set()
            for ty in present:
                pool.update(str(g).lower() for g in marker_sets.get(ty, []))
            if not pool:
                continue
            rows = []
            for term, genes in term_genes.items():
                tset = {str(g).lower() for g in genes} & background
                x = len(pool & tset)
                if x == 0 or not tset:
                    continue
                p = float(hypergeom.sf(x - 1, bg, len(tset), len(pool)))
                rows.append((term, p))
            rows.sort(key=lambda r: r[1])
            ora[c] = rows
    return TwoLayerAnnotation(
        fine=fine,
        coarse_labels=coarse_labels,
        communities=comm,
        group_of_type=group_of_type,
        hub_calls=hub_calls,
        term_ora=ora,
    )
