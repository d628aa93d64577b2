"""Principal graphs + pseudotime (the port of the JAX package's
`ops/principal_graph.py`; `senna pseudotime`, `senna layout tree`).

SimplePPT (Mao et al. 2015): alternate (1) soft cell->node
responsibilities, (2) node positions solving a tree-regularized least
squares `(diag(R^T 1) + lam L) C = R^T X`, (3) MST refresh over node
distances. The responsibilities, their column sums and `R^T X` are
formed on the device, every sum in an order that is the same on the card
and on the CPU (`ops/rounding.py`), so both fit the same tree; the MST,
the float64 solve, shortest paths and connected components are tiny host
work (K x K), as in the reference.

Pseudotime: geodesic distance from a root node along the fitted tree;
branch labels from the tree's degree->3 vertices.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components, minimum_spanning_tree, shortest_path

from . import rounding as R


@dataclass
class PrincipalGraph:
    nodes: np.ndarray  # [K, d]
    edges: np.ndarray  # [K, K] adjacency (0/1 tree)
    cell_to_node: np.ndarray  # [N]
    pseudotime: np.ndarray  # [N]
    branch: np.ndarray  # [N] branch labels
    root: int = 0  # tree root node id (layout tree re-roots from this)


def _sq_dists_to(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`[N, K]` squared distances by the broadcast difference, as the
    reference forms them (an expansion by a product rounds otherwise)."""
    return R.seq_sum((x[:, None, :] - c[None, :, :]) ** 2, -1)


def _responsibilities(x: torch.Tensor, c: torch.Tensor, sigma: float) -> torch.Tensor:
    # a tensor divisor: a CUDA tensor divided by a Python number is
    # multiplied by its reciprocal, which rounds otherwise than the CPU
    div = torch.tensor(max(sigma, 1e-8), dtype=x.dtype, device=x.device)
    return R.softmax(-_sq_dists_to(x, c) / div, 1)


def _tree_adjacency(c: np.ndarray) -> np.ndarray:
    d2 = ((c[:, None] - c[None, :]) ** 2).sum(-1)
    mst = minimum_spanning_tree(sp.csr_matrix(np.sqrt(d2))).toarray()
    return ((mst > 0) | (mst.T > 0)).astype(np.float64)


@torch.no_grad()
def fit_principal_tree(
    x: np.ndarray,
    n_nodes: int = 50,
    *,
    lam: float = 1.0,
    sigma: float = 0.1,
    n_iter: int = 30,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (node positions [K, d], tree adjacency [K, K]). `timings`
    (if given) receives the seconds of the k-means init (`kmeans_s`) and
    of the iterations (`iterations_s`)."""
    from .kmeans import kmeans

    t0 = time.perf_counter()
    x = np.asarray(x, np.float32)
    k = min(n_nodes, max(x.shape[0] // 3, 2))
    c, _ = kmeans(x, k, seed=seed, device=device)
    t1 = time.perf_counter()

    x_t = torch.as_tensor(x).to(device)
    scale = float(np.var(x)) * sigma
    for _ in range(n_iter):
        lap = _tree_adjacency(c)
        lap = np.diag(lap.sum(1)) - lap
        r = _responsibilities(x_t, torch.as_tensor(c).to(device), scale)  # [N, K]
        b = R.tree_sum(r[:, :, None] * x_t[:, None, :], 0).cpu().numpy()  # R^T X
        mass = R.tree_sum(r, 0).cpu().numpy()
        a = np.diag(mass) + lam * lap
        c = np.linalg.solve(a, b).astype(np.float32)
    adj = _tree_adjacency(c)
    if timings is not None:
        timings["kmeans_s"] = t1 - t0
        timings["iterations_s"] = time.perf_counter() - t1
    return c, adj


def nearest_node(x: np.ndarray, nodes: np.ndarray, device="cuda") -> np.ndarray:
    """`[N]` index of each row's nearest node (the first of equals)."""
    with torch.no_grad():
        d2 = _sq_dists_to(torch.as_tensor(np.asarray(x, np.float32)).to(device),
                          torch.as_tensor(nodes).to(device))
        return torch.argmin(d2, dim=1).cpu().numpy()


def pseudotime(
    x: np.ndarray,
    *,
    n_nodes: int = 50,
    root_cell: int | None = None,
    root_node: int | None = None,  # PseudotimeArgs root_node
    lam: float = 1.0,
    sigma: float = 0.1,
    n_iter: int = 30,
    seed: int = 0,
    device="cuda",
    timings: dict | None = None,
) -> PrincipalGraph:
    """Fit the tree, root it, and order cells (`senna pseudotime`;
    branching.rs branch labels at degree >= 3 vertices). `timings` (if
    given) receives `kmeans_s`, `iterations_s` and the seconds of the
    cell assignment and ordering (`assign_s`)."""
    nodes, adj = fit_principal_tree(
        x, n_nodes, lam=lam, sigma=sigma, n_iter=n_iter, seed=seed, device=device,
        timings=timings,
    )
    t0 = time.perf_counter()
    k = nodes.shape[0]
    cell_to_node = nearest_node(x, nodes, device)

    # root: explicit node id > node nearest the root cell > a tree leaf
    deg = adj.sum(1)
    if root_node is not None:
        root = int(root_node) % k
    elif root_cell is not None:
        root = int(cell_to_node[root_cell])
    else:
        leaves = np.nonzero(deg <= 1)[0]
        root = int(leaves[0]) if len(leaves) else 0

    w = np.sqrt(((nodes[:, None] - nodes[None]) ** 2).sum(-1)) * adj
    dist = shortest_path(sp.csr_matrix(w), indices=root)
    pt = dist[cell_to_node]
    finite = np.isfinite(pt)
    pt[~finite] = np.nanmax(np.where(finite, pt, np.nan)) if finite.any() else 0.0

    # branch labels: cut the tree at branching vertices; each resulting
    # subtree segment is one branch
    branch_nodes = np.nonzero(deg >= 3)[0]
    cut = adj.copy()
    for bnode in branch_nodes:
        cut[bnode, :] = 0
        cut[:, bnode] = 0
    _, comp = connected_components(sp.csr_matrix(cut), directed=False)
    comp[branch_nodes] = -1
    branch = comp[cell_to_node]
    if timings is not None:
        timings["assign_s"] = time.perf_counter() - t0

    return PrincipalGraph(
        nodes=nodes,
        edges=adj,
        cell_to_node=cell_to_node,
        pseudotime=(pt / max(pt.max(), 1e-12)).astype(np.float32),
        branch=branch,
        root=int(root),
    )


# ----------------------------------------------------------------------------
# Reingold-Tilford tree layout (`senna layout tree`; tree_layout.rs)
# ----------------------------------------------------------------------------


def edge_list_from_adjacency(
    nodes: np.ndarray, adj: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (from, to) pairs [E, 2] + Euclidean weights [E]."""
    a, b = np.nonzero(np.triu(np.asarray(adj) > 0, 1))
    w = np.sqrt(((nodes[a] - nodes[b]) ** 2).sum(-1)).astype(np.float32)
    return np.stack([a, b], axis=1).astype(np.int64), w


@torch.no_grad()
def project_cells_to_edges(
    x: np.ndarray, nodes: np.ndarray, edges: np.ndarray, *, device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest point on any tree edge per cell: `(nearest_edge [N],
    t [N])` with t in [0, 1] along edges[e] = (j, k)
    (principal_graph.rs `project_cells_to_graph`). Dense [N, E, d]
    device math — E is tens of segments."""
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    p0 = torch.as_tensor(np.asarray(nodes[edges[:, 0]], np.float32)).to(device)  # [E, d]
    p1 = torch.as_tensor(np.asarray(nodes[edges[:, 1]], np.float32)).to(device)
    seg = p1 - p0  # [E, d]
    # every sum in the reference's order (its products a fused multiply-add
    # per coordinate), the same on the card and on the CPU
    len2 = torch.clamp(R.seq_sum(seg * seg, 1), min=1e-12)  # [E]
    # t*[n, e] = clip(<x_n - p0_e, seg_e> / |seg_e|^2)
    t = torch.clamp(
        (R.fma_dot(x[:, None, :], seg[None, :, :]) - R.seq_sum(p0 * seg, 1)[None, :])
        / len2[None, :], 0.0, 1.0
    )  # [N, E]
    proj = p0[None, :, :] + t[:, :, None] * seg[None, :, :]  # [N, E, d]
    d2 = R.seq_sum((x[:, None, :] - proj) ** 2, 2)  # [N, E]
    e_star = torch.argmin(d2, dim=1)
    t_star = torch.gather(t, 1, e_star[:, None])[:, 0]
    return e_star.cpu().numpy(), t_star.cpu().numpy()


def reingold_tilford_layout(
    nodes: np.ndarray,
    edges: np.ndarray,
    weights: np.ndarray,
    root: int,
) -> np.ndarray:
    """[K, 2] node positions: y = geodesic pseudotime from the root
    along tree edges, x = Reingold-Tilford placement (post-order leaf
    slots; internal nodes at their children's mean). NaN for nodes
    unreachable from the root (tree_layout.rs:38-77)."""
    k = nodes.shape[0]
    xy = np.full((k, 2), np.nan, np.float32)
    if k == 0:
        return xy
    adj: list[list[int]] = [[] for _ in range(k)]
    for (a, b) in np.asarray(edges):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))

    # BFS-rooted orientation; children in sorted id order (:56-60)
    parent = np.full(k, -1, np.int64)
    seen = np.zeros(k, bool)
    seen[root] = True
    order = []
    q = deque([int(root)])
    while q:
        u = q.popleft()
        order.append(u)
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                parent[v] = u
                q.append(v)
    children: list[list[int]] = [[] for _ in range(k)]
    for v in order:
        if v != root and parent[v] >= 0:
            children[parent[v]].append(v)
    for c in children:
        c.sort()

    # post-order x: iterative (a deep unbranched tree would blow the
    # recursion limit the reference's rt_recurse tolerates)
    x = np.full(k, np.nan, np.float32)
    next_leaf = 0.0
    stack: list[tuple[int, bool]] = [(int(root), False)]
    while stack:
        node, expanded = stack.pop()
        kids = children[node]
        if not kids:
            x[node] = next_leaf
            next_leaf += 1.0
            continue
        if expanded:
            x[node] = np.mean([x[c] for c in kids])
        else:
            stack.append((node, True))
            stack.extend((c, False) for c in reversed(kids))

    # y: geodesic distance over edge weights
    w = sp.csr_matrix(
        (
            np.concatenate([weights, weights]).astype(np.float64),
            (
                np.concatenate([edges[:, 0], edges[:, 1]]),
                np.concatenate([edges[:, 1], edges[:, 0]]),
            ),
        ),
        shape=(k, k),
    )
    y = shortest_path(w, indices=int(root))
    ok = np.isfinite(x) & np.isfinite(y)
    xy[ok, 0] = x[ok]
    xy[ok, 1] = y[ok].astype(np.float32)
    return xy


def place_cells_on_tree(
    edges: np.ndarray,
    node_xy: np.ndarray,
    nearest_edge: np.ndarray,
    t: np.ndarray,
    *,
    jitter_frac: float = 0.08,
    seed: int = 42,
) -> np.ndarray:
    """[N, 2] cell positions: lerp along the assigned edge's 2D layout
    plus perpendicular Gaussian jitter scaled by edge length
    (tree_layout.rs:126-173). Cells on root-unreachable edges are NaN."""
    e = np.asarray(edges)[np.asarray(nearest_edge)]
    p0 = node_xy[e[:, 0]]  # [N, 2]
    p1 = node_xy[e[:, 1]]
    tt = np.clip(np.asarray(t, np.float32), 0.0, 1.0)[:, None]
    pos = p0 + tt * (p1 - p0)
    frac = float(np.clip(jitter_frac, 0.0, 0.5))
    if frac > 0.0:
        seg = p1 - p0
        length = np.sqrt((seg**2).sum(-1, keepdims=True))
        perp = np.stack([-seg[:, 1], seg[:, 0]], axis=1) / np.maximum(length, 1e-8)
        rng = np.random.default_rng(seed)
        s = rng.normal(0.0, 1.0, (len(pos), 1)).astype(np.float32) * frac * length
        pos = np.where(length > 1e-8, pos + perp * s, pos)
    return pos.astype(np.float32)
