"""Bayesian hierarchical clustering (the port's copy of the JAX package's
`ops/bhc.py`; data-beans-alg `bhc.rs`
equivalent; Heller & Ghahramani 2005) over count profiles with a
Dirichlet-multinomial marginal likelihood.

Used as the consensus step over pseudobulk/community profiles (pinto
BHC consensus, senna clustering); operates on the small aggregated
axis, so greedy host agglomeration is the right tool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln


def _dm_marginal(counts: np.ndarray, alpha: float) -> float:
    """log Dirichlet-multinomial marginal of a pooled count vector."""
    d = len(counts)
    n = counts.sum()
    return float(
        gammaln(alpha * d)
        - gammaln(alpha * d + n)
        + np.sum(gammaln(alpha + counts) - gammaln(alpha))
    )


@dataclass
class BhcResult:
    merges: list  # (i, j, score) in merge order; indices into a growing node list
    labels: np.ndarray  # flat clusters after cutting at score < 0
    n_clusters: int


def bhc_cluster(
    profiles: np.ndarray,  # [K, D] count profiles
    *,
    alpha: float = 0.5,
    pi: float = 0.5,
    max_clusters: int | None = None,
    cutoff: float = 0.0,
) -> BhcResult:
    """Greedy BHC: repeatedly merge the pair with the highest posterior
    merge odds log r = log pi + logML(merged) - log(1-pi) -
    logML(i) - logML(j); cut where odds drop below `cutoff`
    (cluster_bhc.rs ClusterBhcConfig.cutoff; 0 = the natural Bayesian
    break point)."""
    k = profiles.shape[0]
    nodes = [profiles[i].astype(np.float64) for i in range(k)]
    ml = [_dm_marginal(p, alpha) for p in nodes]
    members: list[list[int]] = [[i] for i in range(k)]
    active = list(range(k))
    merges = []
    log_pi = np.log(pi) - np.log1p(-pi)

    while len(active) > 1:
        best = None
        for ai in range(len(active)):
            for aj in range(ai + 1, len(active)):
                i, j = active[ai], active[aj]
                pooled = nodes[i] + nodes[j]
                score = log_pi + _dm_marginal(pooled, alpha) - ml[i] - ml[j]
                if best is None or score > best[0]:
                    best = (score, i, j, pooled)
        score, i, j, pooled = best
        if score < cutoff and (
            max_clusters is None or len(active) <= max_clusters
        ):
            break
        nodes.append(pooled)
        ml.append(_dm_marginal(pooled, alpha))
        members.append(members[i] + members[j])
        new_id = len(nodes) - 1
        merges.append((i, j, float(score)))
        active = [a for a in active if a not in (i, j)] + [new_id]

    labels = np.zeros(k, np.int64)
    for c, node in enumerate(active):
        for m in members[node]:
            labels[m] = c
    return BhcResult(merges=merges, labels=labels, n_clusters=len(active))
