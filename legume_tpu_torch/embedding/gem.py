"""gem — geodesic embedding + motion: joint spliced/unspliced NCE with
a velocity shift (the port of the JAX package's `embedding/gem.py`;
`faba/src/gem/` equivalent).

Model: spliced counts score against feature embeddings beta; unspliced
counts score against beta + delta (the velocity offset — a per-gene
displacement in embedding space). Both tracks share the cell/pb side.
Fitted full-batch with optax's Adam (or AdamW, after an optional
global-norm clip), written here in torch ops. Per-cell RNA velocity =
the expected displacement of the cell under its unspliced loadings:

    v_cell = sum_g w_g(cell) * delta_g,   w ~ unspliced share

The JAX package folds the epochs into chunked scans
(`utils/scan_train.py::fold_epochs`); the port loops over them and
draws the same per-epoch keys. `fit_gem` draws nothing after its
initial parameters, so its run is deterministic; `fit_gem_encoder`
draws one mask a epoch. The initial parameters are the JAX package's
threefry normals bit for bit. `dtype=torch.float64` runs the same fit in
float64 (the reference a float32 run is held to).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.losses import log_sigmoid
from ..utils import prng

log = logging.getLogger(__name__)

_CHUNK = 100  # fold_epochs' chunk: one key split per chunk of epochs


@dataclass
class GemResult:
    e_feat: np.ndarray  # [D, H] beta
    delta: np.ndarray  # [D, H] velocity offsets
    b_feat_s: np.ndarray
    b_feat_u: np.ndarray
    pb_e: np.ndarray  # [P, H]
    pb_b: np.ndarray
    losses: list = field(default_factory=list)
    # lineage-DAG readout (only when lineage_dag ran)
    dag_edges: "np.ndarray | None" = None  # [E, 2] src -> dst
    dag_pseudotime: "np.ndarray | None" = None  # [P] in [0, 1]
    dag_fate: "np.ndarray | None" = None  # [P, n_leaves]
    dag_leaves: "np.ndarray | None" = None  # leaf row indices

    def cell_velocity(self, unspliced_nd: np.ndarray) -> np.ndarray:
        w = unspliced_nd / np.maximum(unspliced_nd.sum(1, keepdims=True), 1e-9)
        return w @ self.delta


class _Optimizer:
    """optax's `adam` / `adamw(weight_decay=)`, chained after
    `clip_by_global_norm(grad_clip)` when `grad_clip > 0`, over a dict of
    tensors updated in place (b1 0.9, b2 0.999, eps 1e-8; the bias
    corrections in the parameters' precision, as optax takes them)."""

    def __init__(self, params: dict, lr: float, weight_decay: float, grad_clip: float):
        self.params, self.lr, self.wd, self.clip = params, lr, weight_decay, grad_clip
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict):
        b1, b2, eps = 0.9, 0.999, 1e-8
        if self.clip > 0:
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if not bool(g_norm < self.clip):
                grads = {k: (g / g_norm) * self.clip for k, g in grads.items()}
        self.t += 1
        ftype = np.float64 if next(iter(self.params.values())).dtype == torch.float64 else np.float32
        bc1 = float(ftype(1.0) - ftype(b1) ** ftype(self.t))
        bc2 = float(ftype(1.0) - ftype(b2) ** ftype(self.t))
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g * (1.0 - b1))
            self.nu[k].mul_(b2).add_(g * g * (1.0 - b2))
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            if self.wd:
                upd = upd + self.wd * p
            p.add_(upd * -self.lr)


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d param for every param (zeros where the loss does not
    reach it, as `jax.grad` gives)."""
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(keys, gs)}


def _fold(loss_fn, params: dict, opt: _Optimizer, epochs: int, keys=None) -> list[float]:
    """`epochs` full-batch steps of `loss_fn(params, key)`; the loss of
    each epoch is taken before its update, as the JAX scan returns it."""
    losses = []
    for e in range(epochs):
        for v in params.values():
            v.requires_grad_(True)
        loss = loss_fn(params, None if keys is None else keys[e])
        grads = _grads(loss, params)
        with torch.no_grad():
            for v in params.values():
                v.requires_grad_(False)
            opt.step(grads)
        losses.append(loss.detach())
    return torch.stack(losses).cpu().tolist() if losses else []


def gem_init(p: int, d: int, embedding_dim: int, seed: int) -> dict:
    """fit_gem's initial parameters (host float32): `0.1 * normal(k1, [D,
    H])` for beta and `0.1 * normal(k2, [P, H])` for the pb embeddings
    under `k1, k2 = split(key(seed))`, zeros elsewhere."""
    k1, k2 = prng.split(prng.key(seed))
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    return {
        "beta": np.float32(0.1) * prng.normal_exact(k1, (d, embedding_dim)),
        "delta": z(d, embedding_dim),
        "b_s": z(d),
        "b_u": z(d),
        "pb_e": np.float32(0.1) * prng.normal_exact(k2, (p, embedding_dim)),
        "pb_b": z(p),
    }


def fit_gem(
    spliced_pd: np.ndarray,  # [P, D] pseudobulk spliced counts
    unspliced_pd: np.ndarray,  # [P, D] pseudobulk unspliced counts
    *,
    embedding_dim: int = 16,
    epochs: int = 800,
    learning_rate: float = 0.02,
    n_negatives: float = 5.0,
    neg_alpha: float = 0.75,
    delta_l2: float = 0.01,
    objective: str = "logistic",
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
    sequential_velocity: bool = False,
    lineage_dag: bool = False,
    lineage_smooth: bool = False,
    lineage_mst: bool = True,  # dense_dag inverts this
    lineage_knn: int = 10,
    lineage_weight: float = 1.0,
    seed: int = 0,
    mesh=None,
    device="cuda",
    dtype=torch.float32,
) -> GemResult:
    """The joint spliced / unspliced fit (`objective` "logistic": binary
    NCE against the unigram noise; "softmax": the exact multinomial over
    the pb gene axis). `sequential_velocity` fits theta on the spliced
    track first, then delta with theta frozen; `lineage_dag` orients a
    velocity-kNN lineage over the rows, runs a second pass with a
    velocity-drift residual and lifts pseudotime + fate."""
    if mesh is not None:
        raise NotImplementedError("fit_gem's data-parallel mesh is not ported (ROADMAP item 11)")
    p, d = spliced_pd.shape
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)  # noqa: E731
    params = {k: as_t(v) for k, v in gem_init(p, d, embedding_dim, seed).items()}

    def neg_q(c):
        q = c.sum(0) ** neg_alpha
        return as_t((q / max(q.sum(), 1e-30)).astype(np.float32))

    s_j, u_j = as_t(spliced_pd), as_t(unspliced_pd)
    q_s, q_u = neg_q(spliced_pd), neg_q(unspliced_pd)
    m_s, m_u = s_j.sum(1), u_j.sum(1)

    def track_loss(counts, q, m, feat, bias, pb_e, pb_b):
        scores = pb_e @ feat.T + bias[None, :] + pb_b[:, None]
        if objective == "softmax":
            logp = torch.log_softmax(scores, dim=1)
            return -(counts * logp).sum() / torch.clamp_min(counts.sum(), 1.0)
        pos = counts * log_sigmoid(scores)
        neg = (n_negatives * m[:, None] * q[None, :]) * log_sigmoid(-scores)
        return -(pos.sum() + neg.sum()) / torch.clamp_min(counts.sum(), 1.0)

    def loss_full(pr, _key, *, freeze_theta=False, drift=None):
        beta, pb_e = pr["beta"], pr["pb_e"]
        if freeze_theta:
            beta, pb_e = beta.detach(), pb_e.detach()
        ls = track_loss(s_j, q_s, m_s, beta, pr["b_s"], pb_e, pr["pb_b"])
        lu = track_loss(u_j, q_u, m_u, beta + pr["delta"], pr["b_u"], pb_e, pr["pb_b"])
        loss = ls + lu + delta_l2 * torch.mean(torch.sum(pr["delta"] ** 2, dim=1))
        if drift is not None:
            # velocity-drift residual: DAG edge i -> j pulls the row state
            # e(i) = s_w[i] @ beta toward e(j) along eta * v_i
            sw_src, sw_dst, v_src = drift
            pred = sw_src @ pr["beta"] + pr["eta"] * v_src
            loss = loss + lineage_weight * torch.mean(
                torch.sum((sw_dst @ pr["beta"] - pred) ** 2, dim=1)
            )
        return loss

    def new_opt():
        return _Optimizer(params, learning_rate, weight_decay, grad_clip)

    if sequential_velocity:
        def loss_a(pr, _key):
            return track_loss(s_j, q_s, m_s, pr["beta"], pr["b_s"], pr["pb_e"], pr["pb_b"])

        ls = _fold(loss_a, params, new_opt(), epochs)
        ls += _fold(lambda pr, k: loss_full(pr, k, freeze_theta=True), params, new_opt(), epochs)
    else:
        ls = _fold(loss_full, params, new_opt(), epochs)
    losses = ls[::50]

    dag_edges = dag_pt = dag_fate = dag_leaves = None
    if lineage_dag:
        s_w = (spliced_pd / np.maximum(spliced_pd.sum(1, keepdims=True), 1e-9)).astype(np.float32)
        u_w = (unspliced_pd / np.maximum(unspliced_pd.sum(1, keepdims=True), 1e-9)).astype(np.float32)
        for _pass in range(2):
            beta_np = params["beta"].cpu().numpy().astype(np.float32)
            delta_np = params["delta"].cpu().numpy().astype(np.float32)
            e_np = s_w @ beta_np
            v_np = u_w @ (beta_np + delta_np) - e_np
            if lineage_smooth:
                from ..ops.knn import knn_search

                _, idx = knn_search(e_np, e_np, min(lineage_knn, p - 1), device=dev)
                v_np = v_np[idx].mean(1)
            dag_edges, phi = _velocity_dag(
                e_np, v_np, knn=min(lineage_knn, p - 1), mst=lineage_mst, device=dev
            )
            if _pass == 1:
                break
            params["eta"] = torch.ones((), dtype=dtype, device=dev)
            drift = (as_t(s_w[dag_edges[:, 0]]), as_t(s_w[dag_edges[:, 1]]),
                     as_t(v_np[dag_edges[:, 0]]))
            ls2 = _fold(lambda pr, k: loss_full(pr, k, drift=drift), params, new_opt(), epochs)
            losses += ls2[::50]
        dag_pt, dag_fate, dag_leaves = _dag_readout(dag_edges, p, phi)

    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    return GemResult(
        e_feat=out["beta"],
        delta=out["delta"],
        b_feat_s=out["b_s"],
        b_feat_u=out["b_u"],
        pb_e=out["pb_e"],
        pb_b=out["pb_b"],
        losses=losses,
        dag_edges=dag_edges,
        dag_pseudotime=dag_pt,
        dag_fate=dag_fate,
        dag_leaves=dag_leaves,
    )


def _velocity_dag(
    e_np: np.ndarray, v_np: np.ndarray, *, knn: int, mst: bool, device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Velocity-oriented lineage edges over the embedding rows. Edge
    orientation integrates the local velocity projections into a global
    potential phi — least squares on phi_b - phi_a ~ 0.5 (v_a + v_b) .
    (e_b - e_a) over the kNN edges — and edges point uphill in phi.
    `mst` keeps the minimum spanning tree, else the dense graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.sparse.linalg import lsqr

    from ..ops.knn import knn_search

    p = len(e_np)
    dist, idx = knn_search(e_np, e_np, min(knn + 1, p - 1), device=device)
    pairs = {}
    for i in range(p):
        for jj, dd in zip(idx[i], dist[i]):
            j = int(jj)
            if j != i:
                pairs[(min(i, j), max(i, j))] = float(dd)
    und = np.asarray(sorted(pairs), np.int64)
    # potential from local projections (gauge: mean phi = 0)
    d_ab = e_np[und[:, 1]] - e_np[und[:, 0]]
    proj = 0.5 * ((v_np[und[:, 0]] + v_np[und[:, 1]]) * d_ab).sum(1)
    ne = len(und)
    rows = np.repeat(np.arange(ne), 2)
    cols = und.reshape(-1)
    vals = np.tile([-1.0, 1.0], ne)
    a_mat = sp.csr_matrix(
        (np.concatenate([vals, np.full(p, 1e-3)]),
         (np.concatenate([rows, np.full(p, ne)]),
          np.concatenate([cols, np.arange(p)]))),
        shape=(ne + 1, p),
    )
    phi = lsqr(a_mat, np.concatenate([proj, np.zeros(1)]))[0]
    if mst:
        g = sp.csr_matrix(
            (np.maximum(list(pairs.values()), 1e-9), (und[:, 0], und[:, 1])),
            shape=(p, p),
        )
        tree = minimum_spanning_tree(g).tocoo()
        cand = np.stack([tree.row, tree.col], 1)
    else:
        cand = und
    edges = np.where((phi[cand[:, 1]] >= phi[cand[:, 0]])[:, None], cand, cand[:, ::-1])
    return edges.astype(np.int64), phi


def _dag_readout(edges: np.ndarray, p: int, phi: np.ndarray) -> tuple:
    """Pseudotime = the min-max-normalized velocity potential phi, and
    fate = the reachable-leaf distribution by equal-split forward walks
    over the oriented edges."""
    pt = (phi - phi.min()) / max(float(phi.max() - phi.min()), 1e-12)
    adj: list[list[int]] = [[] for _ in range(p)]
    for a, b in edges:
        adj[int(a)].append(int(b))
    leaves = np.asarray([i for i in range(p) if not adj[i]], np.int64)
    leaf_pos = {int(l): li for li, l in enumerate(leaves)}
    fate = np.zeros((p, max(len(leaves), 1)), np.float64)
    for l in leaves:
        fate[l, leaf_pos[int(l)]] = 1.0
    # propagate fate backward in reverse-potential order
    for a in np.argsort(-phi):
        if adj[a]:
            fate[a] = np.mean([fate[b] for b in adj[a]], axis=0)
    return pt.astype(np.float32), fate.astype(np.float32), leaves


# ----------------------------------------------------------------------------
# gem-encoder: masked generative sibling (faba gem_encoder/mod.rs:1-19)
# ----------------------------------------------------------------------------


@dataclass
class GemEncoderResult:
    rho: np.ndarray  # [D, H] shared gene embeddings
    delta: np.ndarray  # [D, H] velocity offsets (u + delta -> s)
    w1: np.ndarray
    b1: np.ndarray
    bias_s: np.ndarray
    losses: list = field(default_factory=list)

    def encode(self, unspliced_nd: np.ndarray) -> np.ndarray:
        u = np.log1p(unspliced_nd)
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-9)
        h = u @ self.rho
        return np.maximum(h @ self.w1 + self.b1, 0.0)

    def cell_velocity(self, unspliced_nd: np.ndarray) -> np.ndarray:
        w = unspliced_nd / np.maximum(unspliced_nd.sum(1, keepdims=True), 1e-9)
        return w @ self.delta


def gem_encoder_init(d: int, latent_dim: int, seed: int) -> tuple[dict, np.ndarray]:
    """(initial parameters, training key) of `fit_gem_encoder`: `k1, k2,
    key = split(key(seed), 3)`, rho = `0.1 * normal(k1, [D, L])`, w1 =
    `0.1 * normal(k2, [L, L])`."""
    k1, k2, key = prng.split(prng.key(seed), 3)
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    return {
        "rho": np.float32(0.1) * prng.normal_exact(k1, (d, latent_dim)),
        "delta": z(d, latent_dim),
        "w1": np.float32(0.1) * prng.normal_exact(k2, (latent_dim, latent_dim)),
        "b1": z(latent_dim),
        "bias_s": z(d),
    }, key


def epoch_keys(key: np.ndarray, epochs: int, chunk: int = _CHUNK) -> np.ndarray:
    """The per-epoch keys `fold_epochs` hands its steps: per chunk of
    `chunk` epochs `key, kc = split(key)`, then `split(kc, n)`."""
    out, done = [], 0
    while done < epochs:
        n_e = min(chunk, epochs - done)
        key, kc = prng.split(key)
        out.append(prng.split(kc, n_e))
        done += n_e
    return np.concatenate(out) if out else np.zeros((0, 2), np.uint32)


def fit_gem_encoder(
    spliced_pd: np.ndarray,  # [P, D]
    unspliced_pd: np.ndarray,  # [P, D]
    *,
    latent_dim: int = 16,
    epochs: int = 600,
    learning_rate: float = 0.01,
    mask_frac: float = 0.2,
    delta_l2: float = 0.01,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
    seed: int = 0,
    mesh=None,
    device="cuda",
    dtype=torch.float32,
) -> GemEncoderResult:
    """Masked generative sibling of gem (`faba gem-encoder`): encode the
    cell state from the unspliced profile through shared gene embeddings
    rho, then score the spliced counts against rho + delta. Each epoch
    masks the genes where `uniform(key_e, [P, D]) <= mask_frac` out of
    the encoder's input and scores the spliced multinomial everywhere."""
    if mesh is not None:
        raise NotImplementedError("fit_gem_encoder's data-parallel mesh is not ported "
                                  "(ROADMAP item 11)")
    p, d = spliced_pd.shape
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)  # noqa: E731
    init, key = gem_encoder_init(d, latent_dim, seed)
    params = {k: as_t(v) for k, v in init.items()}
    u_log = as_t(np.log1p(unspliced_pd))
    u_log = u_log / torch.clamp_min(torch.linalg.norm(u_log, dim=1, keepdim=True), 1e-9)
    s_j = as_t(spliced_pd)
    keys = epoch_keys(key, epochs)

    def loss_fn(pr, kmask):
        keep = prng.uniform_keys(kmask[None], p * d, dev)[0].reshape(p, d) > mask_frac
        h = (u_log * keep) @ pr["rho"]
        z = torch.relu(h @ pr["w1"] + pr["b1"])  # [P, H]
        logits = z @ (pr["rho"] + pr["delta"]).T + pr["bias_s"][None, :]
        ll = torch.sum(s_j * torch.log_softmax(logits, dim=1)) / torch.clamp_min(s_j.sum(), 1.0)
        return -ll + delta_l2 * torch.mean(torch.sum(pr["delta"] ** 2, dim=1))

    opt = _Optimizer(params, learning_rate, weight_decay, grad_clip)
    ls = _fold(loss_fn, params, opt, epochs, keys)
    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    return GemEncoderResult(
        rho=out["rho"], delta=out["delta"], w1=out["w1"], b1=out["b1"],
        bias_s=out["bias_s"], losses=ls[::50],
    )
