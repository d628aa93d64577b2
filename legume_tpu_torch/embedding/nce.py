"""Count-NCE joint (cell, feature) embedding engine behind `senna bge`
(the port of the JAX package's `embedding/nce.py`).

Bilinear score s(c, f) = e_feat[f] . e_cell[c] + b_feat[f] + b_cell[c],
trained in two phases: (1) pseudobulk axes and the feature side, (2) the
feature side frozen, one embedding per cell. The objective is the
reference's sampled NCE in exact expectation:

    L = - sum_pg [ c_pg log sigma(s_pg) + k q_g m_p log sigma(-s_pg) ] / sum c

with counts c, row masses m and the negative marginal q (count
marginal^alpha, normalised).

Which path computes the loss follows from the configuration alone, as in
the JAX package: with a dense, unstratified q and H <= 128 both phases
take kernel K4 (`nce_kernel.nce_epoch_grads`), which returns the loss and
all four gradients in one pass and needs no autograd; with a
batch-stratified q [P, D] or H > 128 they take `expected_nce_loss` under
torch autograd, the counterpart of the JAX package's XLA path.

The optimiser is optax's Adam(W) written in torch ops on one flat buffer
of parameters, and the initial weights are the JAX package's threefry
draws (`utils/prng.py`), so CPU runs follow the JAX trajectories.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..data.visitors import visit_columns_by_block
from ..ops import kernels
from ..ops.random_projection import block_to_device
from ..ops.sparse import col_ids_from_ptr, densify_block
from ..utils import prng
from .nce_kernel import nce_epoch_grads

log = logging.getLogger(__name__)


class FeatSide(NamedTuple):
    e_feat: torch.Tensor  # [D, H]
    b_feat: torch.Tensor  # [D]


class AxisSide(NamedTuple):
    e: torch.Tensor  # [P, H]
    b: torch.Tensor  # [P]


@dataclass
class NceConfig:
    """The JAX package's `NceConfig`, same names and defaults, without
    `use_pallas` (the path follows from the configuration)."""

    embedding_dim: int = 16
    epochs: int = 1000
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    n_negatives: float = 5.0  # expected negatives per positive count unit
    neg_alpha: float = 0.75  # marginal^alpha negative distribution
    cell_batch: int = 2048
    phase2_epochs: int = 100
    seed: int = 0
    ridge: float = 0.0  # feature-embedding L2, sum(1).mean() form
    gene_chunk: int = 0  # > 0 is not ported
    feature_qc: bool = False
    hvg_min_excess: float = 0.0
    min_nnz_rows: float = 0.0
    # "bfloat16" stores the [P, D] count planes in bf16; row masses and
    # totals are reduced in f32 before the downcast
    compute_dtype: str = "float32"


@dataclass
class BgeResult:
    e_feat: np.ndarray  # [D, H]
    b_feat: np.ndarray  # [D]
    pb_embeddings: list  # per level [P_l, H]
    e_cell: np.ndarray  # [N, H]
    b_cell: np.ndarray  # [N]
    pb_biases: list = field(default_factory=list)  # per level [P_l]
    phase1_losses: list = field(default_factory=list)
    phase2_losses: list = field(default_factory=list)
    timings: dict = field(default_factory=dict)  # phase1_s, phase2_s


def _store_dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _device_counts(pc: np.ndarray, device) -> torch.Tensor:
    """A count plane on `device` as f32, shipped as uint8/uint16 when its
    values are small non-negative integers (4x/2x fewer bytes) and cast
    on the device."""
    a = np.asarray(pc)
    if a.size and a.dtype.kind in "iuf":
        mn, mx = float(a.min()), float(a.max())
        if 0.0 <= mn and mx < 65536.0:
            cast = np.ascontiguousarray(a, np.uint8 if mx < 256.0 else np.uint16)
            if a.dtype.kind in "iu" or np.array_equal(cast, a):
                return torch.from_numpy(cast).to(device).float()
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _neg_marginal(counts_pd: np.ndarray, alpha: float) -> np.ndarray:
    q = counts_pd.sum(axis=0) ** alpha
    return (q / max(q.sum(), 1e-30)).astype(np.float32)


def _neg_marginal_stratified(counts_pd: np.ndarray, batches: np.ndarray, alpha: float) -> np.ndarray:
    """Per-row negative marginal [P, D]: row p in batch b uses the
    marginal^alpha over batch b's rows only (negatives from the positive
    row's own batch)."""
    batches = np.asarray(batches)
    out = np.zeros_like(np.asarray(counts_pd, np.float32))
    for b in np.unique(batches):
        m = batches == b
        out[m] = _neg_marginal(counts_pd[m], alpha)[None, :]
    return out


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


def expected_nce_loss(
    feat: FeatSide,
    axis: AxisSide,
    counts_pd: torch.Tensor,  # [P, D]
    q_d: torch.Tensor,  # [D], or [P, D] when stratified
    m_p: torch.Tensor,  # [P] row masses
    *,
    k_neg: float,
    ridge: float,
    dtype: str = "float32",
) -> torch.Tensor:
    """The objective in torch ops (the counterpart of the JAX package's
    `_expected_nce_loss`): scores in `dtype`, reductions in f32."""
    dt = _store_dtype(dtype)
    scores = (
        axis.e.to(dt) @ feat.e_feat.to(dt).T
        + feat.b_feat.to(dt)[None, :]
        + axis.b.to(dt)[:, None]
    )
    pos = counts_pd.to(dt) * _log_sigmoid(scores)
    q2 = q_d if q_d.dim() == 2 else q_d[None, :]
    neg = (k_neg * m_p[:, None] * q2).to(dt) * _log_sigmoid(-scores)
    total = torch.clamp_min(counts_pd.sum(dtype=torch.float32), 1.0)
    loss = -(pos.sum(dtype=torch.float32) + neg.sum(dtype=torch.float32)) / total
    if ridge > 0:
        loss = loss + ridge * (feat.e_feat**2).sum(dim=1).mean()
    return loss


class _Adam:
    """optax's `adam` / `adamw` on one flat f32 buffer, updated in place:
    m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps), plus decoupled decay, times
    -lr (no `torch.optim`, whose import pulls in `torch._dynamo`)."""

    def __init__(self, theta: torch.Tensor, lr: float, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.theta, self.lr, self.wd = theta, lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = torch.zeros_like(theta)
        self.nu = torch.zeros_like(theta)
        self.t = 0

    def step(self, g: torch.Tensor):
        self.t += 1
        b1, b2 = self.b1, self.b2
        self.mu.mul_(b1).add_(g * (1.0 - b1))
        self.nu.mul_(b2).add_(g * g * (1.0 - b2))
        # optax takes the bias corrections in f32
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.t))
        upd = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        if self.wd:
            upd = upd + self.wd * self.theta
        self.theta.add_(upd * -self.lr)


def _flat(arrays: Sequence[np.ndarray], device) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """One flat f32 buffer on `device` holding `arrays`, and a view of it
    in the shape of each."""
    theta = torch.from_numpy(
        np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    ).to(device)
    return theta, _views(theta, [a.shape for a in arrays])


def _views(theta: torch.Tensor, shapes) -> list[torch.Tensor]:
    out, off = [], 0
    for shp in shapes:
        n = int(np.prod(shp, dtype=np.int64))
        out.append(theta[off : off + n].view(shp))
        off += n
    return out


def params_from_jax(params: dict, device="cuda") -> dict:
    """The JAX package's `{"feat": FeatSide, "axes": [AxisSide, ...]}`
    (arrays as numpy) as the port's tensors on `device`."""

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    feat = params["feat"]
    return {
        "feat": FeatSide(e_feat=t(feat.e_feat), b_feat=t(feat.b_feat)),
        "axes": [AxisSide(e=t(a.e), b=t(a.b)) for a in params["axes"]],
    }


def fit_bge(
    pb_counts: Sequence[np.ndarray],  # per level [P_l, D] pseudobulk counts
    data=None,  # backend/vec for the phase-2 per-cell fit (optional)
    *,
    config: NceConfig | None = None,
    pb_batches: Sequence[np.ndarray] | None = None,  # per level [P_l] labels
    cell_batches: np.ndarray | None = None,  # [N] phase-2 labels
    device="cuda",
) -> BgeResult:
    """Two-phase fit. `pb_batches` / `cell_batches` switch the negative
    marginal to the batch-stratified form (negatives from the row's own
    batch, in exact expectation)."""
    cfg = config or NceConfig()
    if cfg.gene_chunk > 0:
        raise NotImplementedError("NceConfig.gene_chunk > 0 is not ported")
    device = torch.device(device)
    store_dt = _store_dtype(cfg.compute_dtype)
    timings: dict[str, float] = {}
    t_p1 = time.time()
    h = cfg.embedding_dim
    d_full = pb_counts[0].shape[1]

    # ---- feature QC: train on kept genes, scatter back
    keep = np.ones(d_full, bool)
    if cfg.feature_qc:
        from ..ops.gene_stats import hvg_feature_qc

        keep = hvg_feature_qc(
            np.concatenate([np.asarray(pc, np.float32) for pc in pb_counts]),
            min_excess=cfg.hvg_min_excess,
            min_nnz=cfg.min_nnz_rows,
        )
        if not keep.all():
            log.info("feature QC: keeping %d/%d genes", keep.sum(), d_full)
            pb_counts = [np.asarray(pc, np.float32)[:, keep] for pc in pb_counts]
    keep_idx = np.flatnonzero(keep)
    d = pb_counts[0].shape[1]
    n_lv = len(pb_counts)
    use_kernel = pb_batches is None and h <= kernels.MAX_H

    # initial weights: the JAX package's draws (its kernel path draws
    # e_feat at (D rounded up to 128, H); the first D*H draws are these)
    k_f, *k_axes = prng.split(prng.key(cfg.seed), 1 + n_lv)
    init = [0.1 * prng.normal(k_f, (d, h)), np.zeros(d, np.float32)]
    for k, pc in zip(k_axes, pb_counts):
        init += [0.1 * prng.normal(k, (pc.shape[0], h)), np.zeros(pc.shape[0], np.float32)]
    theta, views = _flat(init, device)

    # count planes on the device in the storage dtype; masses and totals
    # reduced in f32 before the downcast
    counts, ms, totals, qs = [], [], [], []
    for i, pc in enumerate(pb_counts):
        c32 = _device_counts(pc, device)
        ms.append(c32.sum(dim=1))
        totals.append(torch.clamp_min(c32.sum(), 1.0))
        counts.append(c32.to(store_dt))
        if pb_batches is not None:
            q = _neg_marginal_stratified(pc, pb_batches[i], cfg.neg_alpha)
            qs.append(torch.from_numpy(q).to(device).to(store_dt))
        else:
            qs.append(torch.from_numpy(_neg_marginal(pc, cfg.neg_alpha)).to(device))
        del c32

    # ---- phase 1: one AdamW step per epoch, all levels, shared feat side
    opt = _Adam(theta, cfg.learning_rate, weight_decay=cfg.weight_decay)
    loss_trace = torch.zeros(cfg.epochs, dtype=torch.float32, device=device)
    inv_lv = 1.0 / n_lv
    shapes = [v.shape for v in views]
    for ep in range(cfg.epochs):
        if use_kernel:
            e_f, b_f = views[0], views[1]
            loss_t, gf_e, gf_b, g_axes = 0.0, 0.0, 0.0, []
            for i in range(n_lv):
                li, g_ef, g_bf, g_ea, g_ba = nce_epoch_grads(
                    e_f, b_f, views[2 + 2 * i], views[3 + 2 * i], counts[i], qs[i], ms[i],
                    k_neg=cfg.n_negatives, total=totals[i], ridge=cfg.ridge, d_real=d,
                )
                loss_t = loss_t + li
                gf_e = gf_e + g_ef
                gf_b = gf_b + g_bf
                g_axes += [g_ea.reshape(-1), g_ba]
            g = torch.cat([gf_e.reshape(-1), gf_b, *g_axes]) * inv_lv
            loss = loss_t * inv_lv
        else:
            th = theta.detach().requires_grad_(True)
            tv = _views(th, shapes)
            feat = FeatSide(tv[0], tv[1])
            loss = 0.0
            for i in range(n_lv):
                loss = loss + expected_nce_loss(
                    feat, AxisSide(tv[2 + 2 * i], tv[3 + 2 * i]), counts[i], qs[i], ms[i],
                    k_neg=cfg.n_negatives, ridge=cfg.ridge, dtype=cfg.compute_dtype,
                )
            loss = loss / n_lv
            (g,) = torch.autograd.grad(loss, th)
            loss = loss.detach()
        loss_trace[ep] = loss
        opt.step(g)
    p1_losses = loss_trace.cpu().numpy()[::50].tolist()
    e_feat = views[0].cpu().numpy()
    b_feat = views[1].cpu().numpy()
    pb_embeddings = [views[2 + 2 * i].cpu().numpy() for i in range(n_lv)]
    pb_biases = [views[3 + 2 * i].cpu().numpy() for i in range(n_lv)]
    del counts, qs, ms
    timings["phase1_s"] = time.time() - t_p1

    # ---- phase 2: freeze features, fit per-cell embeddings
    t_p2 = time.time()
    p2_losses: list[float] = []
    if data is not None:
        e_cell, b_cell, p2_losses = _fit_cells(
            data, cfg, pb_counts, views[0], views[1], keep, keep_idx, d_full,
            pb_batches, cell_batches, device,
        )
    else:
        e_cell = np.zeros((0, h), np.float32)
        b_cell = np.zeros(0, np.float32)
    timings["phase2_s"] = time.time() - t_p2

    e_feat_full = np.zeros((d_full, h), np.float32)
    b_feat_full = np.zeros(d_full, np.float32)
    e_feat_full[keep_idx] = e_feat
    b_feat_full[keep_idx] = b_feat
    return BgeResult(
        e_feat=e_feat_full,
        b_feat=b_feat_full,
        pb_embeddings=pb_embeddings,
        e_cell=e_cell,
        b_cell=b_cell,
        pb_biases=pb_biases,
        phase1_losses=p1_losses,
        phase2_losses=p2_losses,
        timings=timings,
    )


def _fit_cells(data, cfg: NceConfig, pb_counts, e_feat, b_feat, keep, keep_idx, d_full,
               pb_batches, cell_batches, device):
    """Phase 2: blocks of `cfg.cell_batch` cells, each fitted by
    `phase2_epochs` Adam steps against the frozen feature side (separable
    per cell). Returns `(e_cell [N, H], b_cell [N], last loss per block)`."""
    n, h = data.num_columns, cfg.embedding_dim
    store_dt = _store_dtype(cfg.compute_dtype)
    d = e_feat.shape[0]
    all_pb = np.concatenate([np.asarray(pc, np.float32)[:, :d] for pc in pb_counts], axis=0)
    q_global = torch.from_numpy(_neg_marginal(all_pb, cfg.neg_alpha)).to(device)
    # per-batch marginals for the stratified form, from that batch's pb
    # rows at every level
    q_batch_ids = q_table = None
    if cell_batches is not None and pb_batches is not None:
        cat_b = np.concatenate([np.asarray(b) for b in pb_batches])
        q_batch_ids = np.unique(cat_b)
        q_table = torch.from_numpy(
            np.stack([_neg_marginal(all_pb[cat_b == b], cfg.neg_alpha) for b in q_batch_ids])
        ).to(device)
    use_kernel = q_table is None and h <= kernels.MAX_H
    feat = FeatSide(e_feat, b_feat)
    keep_t = None if keep.all() else torch.from_numpy(keep_idx).to(device)

    e_cell = torch.zeros(n, h, dtype=torch.float32, device=device)
    b_cell = torch.zeros(n, dtype=torch.float32, device=device)
    last_losses = []
    key2 = prng.key(cfg.seed + 1)
    for blk in visit_columns_by_block(data, block_size=cfg.cell_batch):
        key2, kb = prng.split(key2)
        rows, ptr, vals = block_to_device(blk, device)
        x = densify_block(rows, col_ids_from_ptr(ptr), vals, ncols=blk.ncols, num_genes=d_full)
        if keep_t is not None:
            x = x[:, keep_t].contiguous()
        m_b = x.sum(dim=1)
        if q_table is not None:
            bl = np.asarray(cell_batches)[blk.lb : blk.lb + blk.ncols]
            pos = np.searchsorted(q_batch_ids, bl).clip(0, len(q_batch_ids) - 1)
            if not np.array_equal(q_batch_ids[pos], bl):
                raise KeyError("a cell's batch has no pseudobulk rows")
            q_bd = q_table[torch.from_numpy(pos).to(device)]
        else:
            q_bd = q_global
        theta, (e_a, b_a) = _flat(
            [0.01 * prng.normal(kb, (blk.ncols, h)), np.zeros(blk.ncols, np.float32)], device
        )
        opt = _Adam(theta, cfg.learning_rate * 2)
        if use_kernel:
            total_b = torch.clamp_min(x.sum(), 1.0)
            x = x.to(store_dt)
        for _ in range(cfg.phase2_epochs):
            if use_kernel:  # the feature side is frozen: axis gradients only
                loss, _, _, g_ea, g_ba = nce_epoch_grads(
                    feat.e_feat, feat.b_feat, e_a, b_a, x, q_bd, m_b,
                    k_neg=cfg.n_negatives, total=total_b, need_feat=False,
                )
                g = torch.cat([g_ea.reshape(-1), g_ba])
            else:
                th = theta.detach().requires_grad_(True)
                ta, tb = _views(th, [e_a.shape, b_a.shape])
                loss = expected_nce_loss(
                    feat, AxisSide(ta, tb), x, q_bd, m_b,
                    k_neg=cfg.n_negatives, ridge=0.0, dtype=cfg.compute_dtype,
                )
                (g,) = torch.autograd.grad(loss, th)
            opt.step(g)
        last_losses.append(loss.detach())
        e_cell[blk.lb : blk.lb + blk.ncols] = e_a
        b_cell[blk.lb : blk.lb + blk.ncols] = b_a
    losses = torch.stack(last_losses).cpu().tolist() if last_losses else []
    return e_cell.cpu().numpy(), b_cell.cpu().numpy(), losses
