"""`faba lineage` — velocity-informed lineage inference over a gem fit
(`faba/src/lineage/` equivalent: `orient.rs` per-edge direction tests,
`matrix_util/branching.rs` max-weight branching, `forest.rs` +
`matrix_util/principal_curve.rs` Slingshot curves, `root.rs` root
resolution, `write.rs` output schemas).

Pipeline (`lineage/run.rs run_lineage`):
  1. θ/δ loaded by prefix, metric-transformed (`input.rs`)
  2. seeded k-means centroids + MST over them
  3. candidate edges = MST ∪ kNN; per-edge velocity DIRECTION test:
     bootstrap CI + sign-flip permutation p, BH across edges, abstain
     below the bar (`orient.rs edge_directionality`)
  4. max-weight branching over geometry × direction arc weights →
     rooted FOREST (contradictions cut, weak parents rewired)
  5. Slingshot principal curves per tree; per-cell pseudotime, branch,
     per-lineage weights, order confidence (`forest.rs`)

All math here is numpy on the host: K ≤ 200 centroids and vectorized
cell-level blocks, so the fit is I/O and small-matrix bound. This is the
port's copy of the JAX package's `faba/lineage.py`, with the same `rng`
draw order; the card work of `faba lineage` (k-means, kNN, layouts) is in
`lineage_run.py`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

log = logging.getLogger(__name__)

# Geometry floor / contradicted-orientation weight (write.rs:71-73).
BETA = 0.2
BETA_LOW = 1e-3

FORWARD, REVERSE, ABSTAIN = 1, -1, 0
_CALL_NAMES = {FORWARD: "forward", REVERSE: "reverse", ABSTAIN: "unassigned"}


# ---------------------------------------------------------------- #
# Hypothesis tests (faba/hypothesis_tests.rs)                       #
# ---------------------------------------------------------------- #


def bootstrap_mean_ci(
    g: np.ndarray, n_boot: int, alpha: float, rng: np.random.Generator
) -> tuple[float, float, float]:
    """(SE, ci_lo, ci_hi) of the mean by cell bootstrap — percentile
    CI at level 1-alpha (`hypothesis_tests.rs bootstrap_mean_ci`)."""
    n = len(g)
    idx = rng.integers(0, n, size=(n_boot, n))
    means = g[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2, 1 - alpha / 2])
    return float(means.std(ddof=1)), float(lo), float(hi)


def sign_flip_pvalue(
    g: np.ndarray, n_perm: int, rng: np.random.Generator
) -> float:
    """Two-sided sign-flip permutation p for H0: mean = 0
    (`hypothesis_tests.rs sign_flip_pvalue`); +1 in the numerator so
    p is never exactly 0."""
    obs = abs(g.sum())
    signs = rng.integers(0, 2, size=(n_perm, len(g))) * 2 - 1
    null = np.abs(signs @ g)
    return float((1 + (null >= obs).sum()) / (n_perm + 1))


def benjamini_hochberg(p: np.ndarray) -> np.ndarray:
    """BH step-up adjusted q-values (`hypothesis_tests.rs`)."""
    p = np.asarray(p, np.float64)
    m = len(p)
    if m == 0:
        return p.copy()
    order = np.argsort(p, kind="stable")
    q = p[order] * m / np.arange(1, m + 1)
    q = np.minimum.accumulate(q[::-1])[::-1]
    out = np.empty(m)
    out[order] = np.minimum(q, 1.0)
    return out


# ---------------------------------------------------------------- #
# Geometry, K, grouping (lineage/{input,cluster}.rs)                #
# ---------------------------------------------------------------- #


def choose_k(n: int, requested: int | None) -> int:
    """K = --n-centroids, else min(N/10, 200) in [2, N]
    (`cluster.rs choose_k`)."""
    k = requested if requested is not None else int(np.clip(n // 10, 2, 200))
    return min(k, n)


def l2_normalize_rows(m: np.ndarray) -> np.ndarray:
    nrm = np.linalg.norm(m, axis=1, keepdims=True)
    return np.where(nrm > 1e-9, m / np.maximum(nrm, 1e-9), m)


def apply_geometry(theta: np.ndarray, geometry: str) -> np.ndarray:
    """Metric transform (`input.rs apply_geometry`): hellinger = √θ
    (Euclidean on the result = Hellinger on the simplex; rows land on
    the unit sphere since Σθ=1), cosine = L2-normalized rows,
    euclidean = raw."""
    if geometry == "euclidean":
        return theta
    if geometry == "cosine":
        return l2_normalize_rows(theta)
    if geometry == "hellinger":
        return np.sqrt(np.maximum(theta, 0.0))
    raise ValueError(f"unknown geometry {geometry!r}")


def cluster_features(
    theta: np.ndarray, velocity: np.ndarray | None, space: str
) -> np.ndarray:
    """Grouping features per --cluster-space (`cluster.rs
    cluster_features`): identity = θ, nascent = θ+δ, concat = [θ̂|δ̂]
    with each channel row-normalized. Falls back to θ without δ."""
    if space == "identity" or velocity is None:
        return theta
    if space == "nascent":
        return theta + velocity
    if space == "concat":
        return np.concatenate(
            [l2_normalize_rows(theta), l2_normalize_rows(velocity)], axis=1
        )
    raise ValueError(f"unknown cluster space {space!r}")


def theta_centroids_from_labels(
    theta: np.ndarray, labels: np.ndarray, k: int
) -> np.ndarray:
    """Recompute centroids in RAW θ from the grouping labels
    (`cluster.rs theta_centroids_from_labels`) so the manifold stays
    θ-based even when the grouping used θ+δ."""
    c = np.zeros((k, theta.shape[1]), np.float64)
    np.add.at(c, labels, theta.astype(np.float64))
    cnt = np.bincount(labels, minlength=k).astype(np.float64)
    nz = cnt > 0
    c[nz] /= cnt[nz, None]
    return c.astype(np.float32)


def assign_clusters(
    z: np.ndarray, centroids: np.ndarray, *, block: int = 8192
) -> np.ndarray:
    """Per-cell nearest centroid, blocked (`principal_curve.rs
    assign_clusters`)."""
    out = np.empty(len(z), np.int64)
    c2 = (centroids**2).sum(1)
    for s in range(0, len(z), block):
        zb = z[s : s + block]
        d2 = (zb**2).sum(1)[:, None] - 2.0 * zb @ centroids.T + c2[None]
        out[s : s + block] = d2.argmin(1)
    return out


def mst_from_centroids(centroids: np.ndarray) -> list[tuple[int, int]]:
    """Prim MST over pairwise squared distances
    (`principal_graph.rs mst_from_sqdist` role)."""
    k = len(centroids)
    d2 = ((centroids[:, None] - centroids[None]) ** 2).sum(-1)
    in_tree = np.zeros(k, bool)
    in_tree[0] = True
    best = d2[0].copy()
    best_from = np.zeros(k, np.int64)
    edges = []
    for _ in range(k - 1):
        j = int(np.argmin(np.where(in_tree, np.inf, best)))
        edges.append((int(best_from[j]), j))
        in_tree[j] = True
        upd = d2[j] < best
        best = np.where(upd, d2[j], best)
        best_from = np.where(upd, j, best_from)
    return [(min(a, b), max(a, b)) for a, b in edges]


# ---------------------------------------------------------------- #
# Edge directionality (lineage/orient.rs)                           #
# ---------------------------------------------------------------- #


@dataclass
class EdgeDirections:
    """All candidate edges with their tested direction, array-of-
    columns layout (`orient.rs EdgeDirection`, vectorized). `edge`
    rows are (a, b) with a < b; flux > 0 means a→b; stats are NaN on
    auto-abstained edges."""

    edge: np.ndarray  # [E, 2] int
    geom_dist: np.ndarray  # [E]
    flux: np.ndarray
    se: np.ndarray
    ci_lo: np.ndarray
    ci_hi: np.ndarray
    p: np.ndarray
    q: np.ndarray
    n_cells: np.ndarray  # [E] int
    call: np.ndarray  # [E] int in {FORWARD, REVERSE, ABSTAIN}
    confidence: np.ndarray  # 1-q for a call, else 0
    in_mst: np.ndarray  # [E] bool

    def __len__(self):
        return len(self.edge)

    def as_map(self) -> dict[tuple[int, int], int]:
        """(a, b) → row index for path lookups."""
        return {(int(a), int(b)): i for i, (a, b) in enumerate(self.edge)}

    def called_direction(self, i: int) -> tuple[int, int] | None:
        a, b = int(self.edge[i, 0]), int(self.edge[i, 1])
        if self.call[i] == FORWARD:
            return (a, b)
        if self.call[i] == REVERSE:
            return (b, a)
        return None


def candidate_edges(
    centroids: np.ndarray, mst_edges: list[tuple[int, int]], k_cand: int
) -> list[tuple[int, int]]:
    """MST ∪ each node's k_cand nearest centroids, deduped (min, max),
    sorted (`orient.rs candidate_edges`) — the non-MST candidates are
    the alternative parents that let the branching REWIRE."""
    k = len(centroids)
    d2 = ((centroids[:, None] - centroids[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    edges = {(min(a, b), max(a, b)) for a, b in mst_edges}
    if k_cand > 0:
        nn = np.argsort(d2, axis=1, kind="stable")[:, : min(k_cand, k - 1)]
        for a in range(k):
            for b in nn[a]:
                edges.add((min(a, int(b)), max(a, int(b))))
    return sorted(edges)


def mst_only_directions(
    centroids: np.ndarray, mst_edges: list[tuple[int, int]]
) -> EdgeDirections:
    """All-abstain geometry-only directions (no velocity /
    --no-edge-direction): branching reduces to the geometric MST
    (`orient.rs mst_only_directions`)."""
    e = np.array(sorted({(min(a, b), max(a, b)) for a, b in mst_edges}), np.int64)
    e = e.reshape(-1, 2)
    m = len(e)
    nan = np.full(m, np.nan, np.float32)
    geom = np.linalg.norm(
        centroids[e[:, 0]] - centroids[e[:, 1]], axis=1
    ).astype(np.float32) if m else nan
    return EdgeDirections(
        edge=e, geom_dist=geom, flux=nan.copy(), se=nan.copy(),
        ci_lo=nan.copy(), ci_hi=nan.copy(), p=nan.copy(), q=nan.copy(),
        n_cells=np.zeros(m, np.int64),
        call=np.full(m, ABSTAIN, np.int8),
        confidence=np.zeros(m, np.float32),
        in_mst=np.ones(m, bool),
    )


def edge_directionality(
    centroids: np.ndarray,
    velocity: np.ndarray,
    labels: np.ndarray,
    cand_edges: list[tuple[int, int]],
    mst_edges: list[tuple[int, int]],
    *,
    n_boot: int = 200,
    n_perm: int = 500,
    alpha: float = 0.05,
    min_cells: int = 2,
    seed: int = 42,
) -> EdgeDirections:
    """Test the velocity direction of every candidate edge
    (`orient.rs edge_directionality`): sample = per-cell δ projected
    onto the a→b axis over cells assigned to node a or b; bootstrap
    SE/CI + sign-flip permutation p, BH across edges, call only when
    q ≤ alpha AND the CI clears zero."""
    mst_set = {(min(a, b), max(a, b)) for a, b in mst_edges}
    m = len(cand_edges)
    cols = {
        k: np.full(m, np.nan, np.float32)
        for k in ("geom", "flux", "se", "lo", "hi", "p")
    }
    n_cells = np.zeros(m, np.int64)
    cells_of = [np.nonzero(labels == a)[0] for a in range(len(centroids))]
    for ei, (a, b) in enumerate(cand_edges):
        axis = centroids[b] - centroids[a]
        nrm = float(np.linalg.norm(axis))
        cols["geom"][ei] = nrm
        members = np.concatenate([cells_of[a], cells_of[b]])
        n_cells[ei] = len(members)
        if nrm <= 0.0 or len(members) < min_cells:
            if len(members):
                cols["flux"][ei] = float(
                    (velocity[members] @ (axis / max(nrm, 1e-12))).mean()
                )
            continue
        g = (velocity[members] @ axis / nrm).astype(np.float64)
        cols["flux"][ei] = g.mean()
        # per-edge seed mirrors the reference's seed ^ (ei * phi) mix
        rng = np.random.default_rng(
            (seed ^ (ei * 0x9E3779B9)) & 0xFFFFFFFFFFFFFFFF
        )
        cols["se"][ei], cols["lo"][ei], cols["hi"][ei] = bootstrap_mean_ci(
            g, n_boot, alpha, rng
        )
        cols["p"][ei] = sign_flip_pvalue(g, n_perm, rng)

    q = np.full(m, np.nan, np.float32)
    call = np.full(m, ABSTAIN, np.int8)
    conf = np.zeros(m, np.float32)
    testable = np.nonzero(np.isfinite(cols["p"]))[0]
    if len(testable):
        q[testable] = benjamini_hochberg(cols["p"][testable])
        clears = (cols["lo"][testable] > 0) | (cols["hi"][testable] < 0)
        called = (q[testable] <= alpha) & clears
        idx = testable[called]
        call[idx] = np.where(cols["flux"][idx] > 0, FORWARD, REVERSE)
        conf[idx] = 1.0 - q[idx]
    e = np.asarray(cand_edges, np.int64).reshape(-1, 2)
    return EdgeDirections(
        edge=e, geom_dist=cols["geom"], flux=cols["flux"], se=cols["se"],
        ci_lo=cols["lo"], ci_hi=cols["hi"], p=cols["p"], q=q,
        n_cells=n_cells, call=call, confidence=conf,
        in_mst=np.array(
            [(int(a), int(b)) in mst_set for a, b in e], bool
        ) if m else np.zeros(0, bool),
    )


# ---------------------------------------------------------------- #
# Max-weight branching (matrix_util/branching.rs)                   #
# ---------------------------------------------------------------- #


@dataclass
class Branching:
    """Rooted forest over the centroids (`branching.rs Branching`)."""

    parent: list  # [K] int | None
    tree: np.ndarray  # [K] dense component id, ordered by root
    roots: list  # ascending root node ids


def assemble_arcs(
    dirs: EdgeDirections,
    k: int,
    root_affinity_arg: float | None,
    root_hint: int | None,
) -> tuple[list[tuple[int, int, float]], np.ndarray]:
    """Directed arc set + per-node root affinity for max_branching
    (`write.rs assemble_arcs`): geometric Gaussian affinity
    (σ = median candidate distance) × direction support — called
    direction gets BETA + (1-BETA)·confidence, the contradiction
    BETA_LOW, abstained edges the BETA floor both ways. τ_root
    defaults to the median arc weight; a root hint pins via +inf."""
    pos = dirs.geom_dist[np.isfinite(dirs.geom_dist) & (dirs.geom_dist > 0)]
    sigma = max(float(np.median(pos)), 1e-6) if len(pos) else 1.0
    arcs: list[tuple[int, int, float]] = []
    for i in range(len(dirs)):
        a, b = int(dirs.edge[i, 0]), int(dirs.edge[i, 1])
        s = float(np.exp(-((dirs.geom_dist[i] / sigma) ** 2)))
        strong = s * (BETA + (1 - BETA) * float(dirs.confidence[i]))
        weak = s * BETA_LOW
        floor = s * BETA
        if dirs.call[i] == FORWARD:
            arcs += [(a, b, strong), (b, a, weak)]
        elif dirs.call[i] == REVERSE:
            arcs += [(b, a, strong), (a, b, weak)]
        else:
            arcs += [(a, b, floor), (b, a, floor)]
    tau = (
        root_affinity_arg
        if root_affinity_arg is not None
        else (float(np.median([w for _, _, w in arcs])) if arcs else 1.0)
    )
    root_affinity = np.full(k, tau, np.float64)
    if root_hint is not None and 0 <= root_hint < k:
        root_affinity[root_hint] = np.inf
    return arcs, root_affinity


def max_branching(
    n: int, arcs: list[tuple[int, int, float]], root_affinity: np.ndarray
) -> Branching:
    """Maximum-weight spanning branching (`branching.rs
    max_branching`): arcs into a node compete with its root_affinity;
    Chu-Liu/Edmonds with a virtual super-root, ties to the earliest
    arc. Every node ends with exactly one of {a parent, root status}."""
    # Super-root R = n; its arc to v carries root_affinity[v] and is
    # ORDERED AFTER the real arcs (earliest-arc tie break favors a
    # real parent over rooting on an exact tie).
    all_arcs = [(u, v, float(w)) for u, v, w in arcs] + [
        (n, v, float(root_affinity[v])) for v in range(n)
    ]
    parent_arc = _edmonds_max_arborescence(n + 1, all_arcs, root=n)
    parent: list = [None] * n
    for v in range(n):
        ai = parent_arc[v]
        u = all_arcs[ai][0]
        parent[v] = None if u == n else u
    roots = sorted(v for v in range(n) if parent[v] is None)
    tree = np.full(n, -1, np.int64)
    for ti, r in enumerate(roots):
        tree[r] = ti
    # propagate component ids down the parent pointers
    for v in range(n):
        path = []
        x = v
        while tree[x] < 0:
            path.append(x)
            x = parent[x]
        for y in path:
            tree[y] = tree[x]
    return Branching(parent=parent, tree=tree, roots=roots)


def _edmonds_max_arborescence(
    n: int, arcs: list[tuple[int, int, float]], root: int
) -> dict[int, int]:
    """Chu-Liu/Edmonds maximum arborescence rooted at `root`.
    Returns {node: index into `arcs` of its chosen in-arc}. Assumes
    every non-root node has at least one in-arc (the super-root
    guarantees it). Ties pick the earliest arc (stable argmax)."""
    # Work on (u, v, w, orig) tuples; recurse on contracted graphs.
    # `orig` tracks the arc through contraction levels: at the top it
    # indexes `arcs`; one level down it indexes the parent's meta list.
    work = [(u, v, w, i) for i, (u, v, w) in enumerate(arcs) if u != v]

    def solve(n_nodes, work, root):
        # best in-arc per node (strict > keeps the EARLIEST on ties)
        best = [-1] * n_nodes
        for j, (u, v, w, _) in enumerate(work):
            if v == root:
                continue
            if best[v] < 0 or w > work[best[v]][2]:
                best[v] = j
        # cycles in the functional graph v -> chosen parent
        in_cycle = [False] * n_nodes
        visited = [-1] * n_nodes
        cycles = []
        for v in range(n_nodes):
            if visited[v] >= 0:
                continue
            x = v
            while visited[x] < 0:
                visited[x] = v
                if x == root or best[x] < 0:
                    break
                x = work[best[x]][0]
            if visited[x] == v and x != root and best[x] >= 0 and not in_cycle[x]:
                cyc = [x]
                y = work[best[x]][0]
                while y != x:
                    cyc.append(y)
                    y = work[best[y]][0]
                for m in cyc:
                    in_cycle[m] = True
                cycles.append(cyc)
        if not cycles:
            return {v: work[best[v]][3] for v in range(n_nodes)
                    if v != root and best[v] >= 0}
        # contract every cycle into a super-node; singletons keep ids
        comp = [-1] * n_nodes
        n_comp = 0
        for cyc in cycles:
            for m in cyc:
                comp[m] = n_comp
            n_comp += 1
        for v in range(n_nodes):
            if comp[v] < 0:
                comp[v] = n_comp
                n_comp += 1
        new_work = []
        # per contracted arc: (orig at this level, landing node) — the
        # landing node is where the cycle is broken on expansion
        meta = []
        for u, v, w, orig in work:
            cu, cv = comp[u], comp[v]
            if cu == cv:
                continue
            # entering a contracted cycle displaces v's cycle in-arc
            w_adj = w - work[best[v]][2] if in_cycle[v] else w
            new_work.append((cu, cv, w_adj, len(meta)))
            meta.append((orig, v))
        sub = solve(n_comp, new_work, comp[root])
        chosen: dict[int, int] = {}
        entered: dict[int, int] = {}
        for mi in sub.values():
            orig, landed = meta[mi]
            chosen[landed] = orig
            entered[comp[landed]] = landed
        for cyc in cycles:
            landed = entered.get(comp[cyc[0]])
            for v in cyc:
                if v != landed:
                    chosen[v] = work[best[v]][3]
        return chosen

    return solve(n, work, root)


# ---------------------------------------------------------------- #
# Slingshot principal curves (matrix_util/principal_curve.rs)       #
# ---------------------------------------------------------------- #


@dataclass
class LineageCurve:
    node_path: list  # centroid ids root…leaf
    points: np.ndarray  # [R, D] smooth curve, root (λ=0) → leaf
    lambda_grid: np.ndarray  # [R] cumulative arc-length


@dataclass
class PrincipalCurves:
    curves: list  # [L] LineageCurve
    cluster: np.ndarray  # [N] nearest-centroid label
    weights: np.ndarray  # [N, L] row-normalized membership
    lineage_pseudotime: np.ndarray  # [N, L] λ, NaN off-lineage
    pseudotime: np.ndarray  # [N] primary-lineage λ
    branch: np.ndarray  # [N] primary lineage id
    n_iters: int = 0

    def n_lineages(self) -> int:
        return len(self.curves)


def _polyline_arclength(pts: np.ndarray) -> np.ndarray:
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)]).astype(np.float32)


def _resample_uniform(
    pts: np.ndarray, arclen: np.ndarray, resolution: int
) -> tuple[np.ndarray, np.ndarray]:
    total = float(arclen[-1]) if len(arclen) else 0.0
    targets = np.linspace(0.0, total, resolution).astype(np.float32)
    seg = np.clip(np.searchsorted(arclen, targets, side="right") - 1,
                  0, max(len(pts) - 2, 0))
    la, lb = arclen[seg], arclen[np.minimum(seg + 1, len(arclen) - 1)]
    t = np.where(lb > la, (targets - la) / np.maximum(lb - la, 1e-12), 0.0)
    t = np.clip(t, 0.0, 1.0)[:, None]
    a = pts[seg]
    b = pts[np.minimum(seg + 1, len(pts) - 1)]
    return (a + t * (b - a)).astype(np.float32), targets


def _project_to_polyline(
    z: np.ndarray, pts: np.ndarray, lambda_grid: np.ndarray,
    *, block: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """Orthogonal projection of each row of z onto the polyline:
    (λ, squared distance), blocked over cells
    (`principal_curve.rs project_point_to_polyline`, vectorized)."""
    a = pts[:-1]  # [S, D]
    d = pts[1:] - a  # [S, D]
    len2 = np.maximum((d**2).sum(1), 1e-12)  # [S]
    lam_out = np.empty(len(z), np.float32)
    sd_out = np.empty(len(z), np.float32)
    for s0 in range(0, len(z), block):
        zb = z[s0 : s0 + block]  # [B, D]
        t = np.clip(
            (zb @ d.T - (a * d).sum(1)[None]) / len2[None], 0.0, 1.0
        )  # [B, S]
        proj_sq = (
            (zb**2).sum(1)[:, None]
            - 2.0 * (zb @ a.T + t * (zb @ d.T))
            + ((a**2).sum(1)[None] + 2.0 * t * (a * d).sum(1)[None]
               + t**2 * len2[None])
        )
        sidx = proj_sq.argmin(1)
        rows = np.arange(len(zb))
        lam_out[s0 : s0 + block] = (
            lambda_grid[sidx]
            + t[rows, sidx] * (lambda_grid[sidx + 1] - lambda_grid[sidx])
        )
        sd_out[s0 : s0 + block] = np.maximum(proj_sq[rows, sidx], 0.0)
    return lam_out, sd_out


def fit_principal_curves(
    z: np.ndarray,
    centroids: np.ndarray,
    mst_edges: list[tuple[int, int]],
    root: int,
    *,
    max_iter: int = 15,
    tol: float = 1e-3,
    resolution: int = 100,
    bandwidth: float = 0.0,
) -> PrincipalCurves:
    """Simultaneous Slingshot curves (`principal_curve.rs
    fit_principal_curves`): root→leaf lineages off the rooted tree,
    polyline init through centroids, iterate project-λ → weighted
    Nadaraya-Watson re-smooth until the primary pseudotime settles."""
    n, d = z.shape
    k = len(centroids)
    if k < 2:
        raise ValueError("need at least 2 centroids for principal curves")
    cluster = assign_clusters(z, centroids)

    # rooted children, lineages = root→leaf paths, sorted for determinism
    adj = [[] for _ in range(k)]
    for a, b in mst_edges:
        adj[a].append(b)
        adj[b].append(a)
    children = [[] for _ in range(k)]
    seen = {root}
    queue = [root]
    while queue:
        u = queue.pop(0)
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                children[u].append(v)
                queue.append(v)
    lineages: list[list[int]] = []
    stack = [(root, [root])]
    while stack:
        node, path = stack.pop()
        if not children[node]:
            lineages.append(path)
        else:
            for c in children[node]:
                stack.append((c, path + [c]))
    lineages.sort()
    n_lin = len(lineages)

    on_path = [set(p) for p in lineages]
    w = np.zeros((n, n_lin), np.float32)
    for l in range(n_lin):
        w[:, l] = np.isin(cluster, list(on_path[l]))
    rows = w.sum(1, keepdims=True)
    w = np.where(rows > 0, w / np.maximum(rows, 1e-12), 1.0 / n_lin)

    def init_curve(path):
        ctrl = centroids[path] if len(path) > 1 else np.repeat(
            centroids[path], 2, axis=0
        )
        pts, lam = _resample_uniform(ctrl, _polyline_arclength(ctrl), resolution)
        return LineageCurve(node_path=list(path), points=pts, lambda_grid=lam)

    curves = [init_curve(p) for p in lineages]
    lam = np.full((n, n_lin), np.nan, np.float32)
    dist2 = np.full((n, n_lin), np.inf, np.float32)
    prev = np.full(n, np.nan, np.float32)
    n_iters = 0

    def project_all():
        for l, cur in enumerate(curves):
            mem = np.nonzero(w[:, l] > 0)[0]
            lam[:, l] = np.nan
            dist2[:, l] = np.inf
            if len(mem):
                lam[mem, l], dist2[mem, l] = _project_to_polyline(
                    z[mem], cur.points, cur.lambda_grid
                )

    def primary():
        masked = np.where(w > 0, dist2, np.inf)
        br = masked.argmin(1)
        pt = lam[np.arange(n), br]
        return np.where(np.isfinite(pt), pt, 0.0).astype(np.float32), br

    for it in range(max_iter):
        project_all()
        # NW re-smooth each curve on its members' λ
        for l, cur in enumerate(curves):
            mem = np.nonzero((w[:, l] > 0) & np.isfinite(lam[:, l]))[0]
            if len(mem) < 2:
                continue
            lm = lam[mem, l]
            lo, hi = float(lm.min()), float(lm.max())
            rng_ = max(hi - lo, 1e-6)
            h = max(bandwidth if bandwidth > 0 else rng_ / 12.0, 1e-6)
            targets = np.linspace(lo, lo + rng_, resolution)
            kw = w[mem, l][None] * np.exp(
                -0.5 * ((lm[None] - targets[:, None]) / h) ** 2
            )  # [R, M]
            wsum = kw.sum(1)
            grid = np.where(
                wsum[:, None] > 1e-12,
                (kw @ z[mem]) / np.maximum(wsum[:, None], 1e-12),
                cur.points,
            ).astype(np.float32)
            cur.points = grid
            cur.lambda_grid = _polyline_arclength(grid)
        pt, _ = primary()
        delta = (
            np.inf if np.isnan(prev).any()
            else float(np.abs(prev - pt).mean()
                       / max(pt.max() - pt.min(), 1e-6))
        )
        prev = pt
        n_iters = it + 1
        if delta < tol:
            break

    project_all()
    pt, br = primary()
    return PrincipalCurves(
        curves=curves, cluster=cluster, weights=w,
        lineage_pseudotime=lam, pseudotime=pt, branch=br, n_iters=n_iters,
    )


# ---------------------------------------------------------------- #
# Forest fitting (lineage/forest.rs)                                #
# ---------------------------------------------------------------- #


@dataclass
class ForestFit:
    curves: PrincipalCurves
    cell_tree: np.ndarray  # [N] tree id (-1 = out of range)
    order_conf: np.ndarray  # [N] min edge confidence on root→node path


def node_order_confidence(
    br: Branching, dirs: EdgeDirections, k: int
) -> np.ndarray:
    """Min edge confidence on each node's root→node path; an edge
    contributes its confidence only when its CALLED direction agrees
    with parent→child; abstained/contradicted edges contribute 0;
    roots score 1 (`forest.rs node_order_confidence`)."""
    dmap = dirs.as_map()
    conf = np.full(k, np.nan, np.float64)
    for v in range(k):
        path = []
        x = v
        while np.isnan(conf[x]):
            p = br.parent[x]
            if p is None:
                conf[x] = 1.0
                break
            path.append((x, p))
            x = p
        for child, parent in reversed(path):
            key = (min(parent, child), max(parent, child))
            ec = 0.0
            if key in dmap:
                i = dmap[key]
                called = dirs.called_direction(i)
                if called == (parent, child):
                    ec = float(dirs.confidence[i])
            conf[child] = min(conf[parent], ec)
    return conf.astype(np.float32)


def fit_forest_curves(
    theta: np.ndarray,
    centroids: np.ndarray,
    labels: np.ndarray,
    br: Branching,
    dirs: EdgeDirections,
    *,
    max_iter: int = 15,
    tol: float = 1e-3,
    resolution: int = 100,
    bandwidth: float = 0.0,
) -> ForestFit:
    """Slingshot per forest tree (pseudotime resets at each tree's
    root), merged into one PrincipalCurves with global lineage ids
    (`forest.rs fit_forest_curves`). Trivial trees (single node, or
    too few cells) write NaN pseudotime — a real, reportable state."""
    k = len(centroids)
    n = len(theta)
    n_comp = len(br.roots)
    node_conf = node_order_confidence(br, dirs, k)
    cell_tree = br.tree[labels]
    order_conf = node_conf[labels]

    comp_nodes = [np.nonzero(br.tree == c)[0] for c in range(n_comp)]
    comp_cells = [np.nonzero(cell_tree == c)[0] for c in range(n_comp)]

    all_curves: list[LineageCurve] = []
    pseudotime = np.full(n, np.nan, np.float32)
    branch = np.zeros(n, np.int64)
    cluster = np.zeros(n, np.int64)
    stashes = []
    total_l = 0
    for c in range(n_comp):
        nodes = comp_nodes[c]
        cells = comp_cells[c]
        root_g = br.roots[c]
        offset = total_l
        if len(nodes) >= 2 and len(cells) >= 2:
            local = {int(g): li for li, g in enumerate(nodes)}
            esub = [
                (local[br.parent[int(v)]], local[int(v)])
                for v in nodes if br.parent[int(v)] is not None
            ]
            sub = fit_principal_curves(
                theta[cells], centroids[nodes], esub, local[root_g],
                max_iter=max_iter, tol=tol, resolution=resolution,
                bandwidth=bandwidth,
            )
            for cur in sub.curves:
                all_curves.append(LineageCurve(
                    node_path=[int(nodes[ln]) for ln in cur.node_path],
                    points=cur.points, lambda_grid=cur.lambda_grid,
                ))
            pseudotime[cells] = sub.pseudotime
            branch[cells] = offset + sub.branch
            cluster[cells] = nodes[sub.cluster]
            stashes.append((c, offset, sub.n_lineages(),
                            sub.weights, sub.lineage_pseudotime))
            total_l += sub.n_lineages()
        else:
            path = [int(v) for v in nodes] or [int(root_g)]
            # root first so the trivial curve still reads root→out
            if int(root_g) in path:
                path.remove(int(root_g))
                path.insert(0, int(root_g))
            pts = centroids[path].astype(np.float32)
            all_curves.append(LineageCurve(
                node_path=path, points=pts,
                lambda_grid=np.arange(len(path), dtype=np.float32),
            ))
            branch[cells] = offset
            cluster[cells] = labels[cells]
            stashes.append((
                c, offset, 1,
                np.ones((len(cells), 1), np.float32),
                np.full((len(cells), 1), np.nan, np.float32),
            ))
            total_l += 1

    weights = np.zeros((n, max(total_l, 1)), np.float32)
    lineage_pt = np.full((n, max(total_l, 1)), np.nan, np.float32)
    for c, offset, l_c, wsub, lpsub in stashes:
        cells = comp_cells[c]
        weights[cells[:, None], offset + np.arange(l_c)[None]] = wsub
        lineage_pt[cells[:, None], offset + np.arange(l_c)[None]] = lpsub

    return ForestFit(
        curves=PrincipalCurves(
            curves=all_curves, cluster=cluster, weights=weights,
            lineage_pseudotime=lineage_pt, pseudotime=pseudotime,
            branch=branch,
        ),
        cell_tree=cell_tree.astype(np.int64),
        order_conf=order_conf,
    )


# ---------------------------------------------------------------- #
# Root resolution (lineage/root.rs)                                 #
# ---------------------------------------------------------------- #


def resolve_root_hint(
    root_node: int | None,
    root_cell: str | None,
    cell_names: list,
    labels: np.ndarray,
    k: int,
    type_root: int | None,
    gem_root: int | None,
) -> int | None:
    """Priority: --root-node (validated) > --root-cell (its node) >
    --root-type call > gem DAG source (`root.rs resolve_root_hint`)."""
    if root_node is not None:
        if not 0 <= root_node < k:
            raise ValueError(f"--root-node {root_node} out of range (K={k})")
        return root_node
    if root_cell is not None:
        try:
            idx = list(cell_names).index(root_cell)
        except ValueError:
            raise ValueError(
                f"--root-cell {root_cell!r} not found in latent"
            ) from None
        return int(labels[idx])
    return type_root if type_root is not None else gem_root


def gem_root_node(
    prefix: str, cell_names: list, labels: np.ndarray, k: int
) -> int | None:
    """--root-from-gem: the modal MST node of the low-τ region in
    `{prefix}.dag_pseudotime.parquet` — robust to a single τ≈0
    outlier (`root.rs gem_root_node`). None (logged) when the file is
    absent, no low-τ barcode matches, or gem reports 0 terminals."""
    import json
    import os

    import pandas as pd

    qc_path = f"{prefix}.lineage_qc.json"
    if os.path.exists(qc_path):
        try:
            qc = json.load(open(qc_path))
            if qc.get("n_terminals") == 0:
                log.warning(
                    "--root-from-gem: gem's DAG has no terminal structure; "
                    "using the velocity-flux root instead"
                )
                return None
        except (OSError, ValueError):
            pass
    path = f"{prefix}.dag_pseudotime.parquet"
    if not os.path.exists(path):
        log.warning("--root-from-gem: %s absent; using the flux root", path)
        return None
    df = pd.read_parquet(path)
    tau = df.iloc[:, 1].to_numpy(np.float64)
    bcs = df.iloc[:, 0].astype(str).to_numpy()
    bc_label = {str(c): int(l) for c, l in zip(cell_names, labels)}
    order = np.argsort(tau, kind="stable")
    n_low = int(np.clip(len(tau) // 20, min(5, len(tau)), len(tau)))
    votes = np.zeros(k, np.int64)
    for r in order[:n_low]:
        lab = bc_label.get(bcs[r])
        if lab is not None and lab < k:
            votes[lab] += 1
    if votes.max() == 0:
        log.warning("--root-from-gem: no low-τ barcode matched the latent")
        return None
    root = int(votes.argmax())
    log.info("--root-from-gem: low-τ region (%d cells) → node %d (%d votes)",
             n_low, root, votes[root])
    return root


def root_type_node(
    node_labels: list, node_conf: np.ndarray, root_type: str
) -> int | None:
    """--root-type: highest-confidence node carrying that call,
    case-insensitive (`root.rs root_type_node`)."""
    cand = [
        i for i, lab in enumerate(node_labels)
        if str(lab).lower() == root_type.lower()
    ]
    if not cand:
        log.warning(
            "--root-type %r matched no trajectory node; next root rule",
            root_type,
        )
        return None
    best = max(cand, key=lambda i: node_conf[i])
    log.info("--root-type %r → node %d (confidence %.3f)",
             root_type, best, node_conf[best])
    return best
