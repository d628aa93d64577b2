"""Indexed top-K topic models, the masked-ETM path (the port of the JAX
package's `models/indexed.py`).

Each cell carries a packed top-K gene window `[N, K]` of (gene id,
value). Training scores a sampled softmax over the minibatch's gene-id
union with the importance correction `-log q_g` (selection frequency),
so the full [*, D] dictionary never forms, and learns by masked-gene
imputation: the encoder sees the unmasked window positions, the masked
ones are scored under the union reconstruction.

What must equal the JAX package's exactly, on any device:

- the windows: `jax.lax.top_k` keeps the lower gene id on ties, which a
  stable descending sort of the score reproduces (`torch.topk` promises
  no order on ties);
- the union: `jnp.unique(ids, size=U, fill_value=D)`, sorted, the
  smallest U ids when more are present, padded with D;
- the random streams of training and evaluation: the JAX key schedule
  (per epoch `split(ek)` -> permutation, minibatch keys; per minibatch
  `split(kb, 3)` -> mask, rate, noise) drawn with the port's threefry.
  The JAX package folds epochs into one dispatch (`utils/scan_train.py`);
  the port loops over them with the same keys.

On the card the gathers of rho and log phi by the windows' gene ids take
their backward through K3 (`gather_rows`), so two runs from the same
seed give the same bits: autograd's own scatter adds a gene's gradients
from many cells with float atomics, in another order each run.

Under a data-parallel mesh (`MaskedTrainConfig.mesh`, one rank a GPU)
every rank holds every window and draws the same permutation, mask
rate, mask and noise over the whole minibatch, takes its share
(`data_sharding`) of the minibatch's rows and scores them against the
union of the whole minibatch; the loss is the mean over the minibatch's
rows, the rho L2 counts on rank 0 alone, the BatchNorm statistics span
the ranks, and the gradients are summed across the ranks before the
clip, the non-finite skip and the AdamW step. A world of one is the
plain run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..data.visitors import visit_columns_by_block
from ..ops import kernels
from ..ops import sparse as sparse_ops
from ..ops.random_projection import block_to_device
from ..ops.transforms import anscombe_lite
from ..parallel.mesh import data_sharding, live, replicate, sum_grads_
from ..utils import prng
from . import losses
from .encoders import FlaxBatchNorm, dense, soft_clamp
from .train import clip_grads_nonfinite_


# ---- gathers by gene id with a fixed-order backward --------------------------


class _RowGather(torch.autograd.Function):
    """`table[ids]`; the backward sums each table row's gradients as K3's
    group sum (`out[h, seg[c]] += v`, a flat position c being a cell with
    the gradient row as its column and its id as its group), which adds in
    an order fixed by the inputs."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        m = ids.numel()
        h = grad.numel() // max(m, 1)
        dev = grad.device
        g = grad.reshape(m, h).to(torch.float32).contiguous()
        col_ptr = torch.arange(0, (m + 1) * h, h, dtype=torch.int32, device=dev)
        row_ids = torch.arange(h, dtype=torch.int32, device=dev).repeat(m)
        plane = kernels.collapse(row_ids, col_ptr, g.reshape(-1),
                                 ids.reshape(-1).to(torch.int32), num_genes=h,
                                 num_groups=ctx.rows, also_count="collapse_gather")  # [h, rows]
        return plane.T.reshape((ctx.rows,) + tuple(grad.shape[ids.dim():])).to(grad.dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]`. A card tensor's backward goes through K3 (the same
    bits in every run); a CPU tensor keeps plain indexing, whose backward
    already adds in index order."""
    if table.device.type == "cpu" or not torch.is_grad_enabled() or not table.requires_grad:
        return table[ids.long()]
    return _RowGather.apply(table, ids)


# ---- packed top-K windows -----------------------------------------------------


@dataclass
class IndexedData:
    ids: np.ndarray  # [N, K] int32 gene ids (pad = D)
    vals: np.ndarray  # [N, K] float32 counts (pad = 0)
    log_q: np.ndarray  # [D + 1] log selection frequency (pad slot tiny)
    n_genes: int


def topk_rows(x_bd: torch.Tensor, k: int, gene_weights: torch.Tensor | None = None):
    """(ids [B, k] int32, vals [B, k]) of each row's top-k genes by
    `x * gene_weights`, lower gene id first on ties; slots whose score
    is not positive take the pad id D and value 0."""
    d = x_bd.shape[1]
    score = x_bd if gene_weights is None else x_bd * gene_weights[None, :]
    top_v, top_i = torch.sort(score, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :k], top_i[:, :k]
    valid = top_v > 0
    got = torch.gather(x_bd, 1, top_i)
    return (torch.where(valid, top_i, d).to(torch.int32),
            torch.where(valid, got, torch.zeros_like(got)))


def selection_log_q(ids: np.ndarray, d: int) -> np.ndarray:
    """[D + 1] log selection frequency of the window ids (pad slot last)."""
    counts = np.bincount(ids.reshape(-1), minlength=d + 1).astype(np.float64)
    freq = counts / max(counts[:d].sum(), 1.0)
    return np.log(np.maximum(freq, 1e-12)).astype(np.float32)


def build_topk_windows(data, k: int, *, gene_weights: np.ndarray | None = None,
                       block_size: int = 4096, device="cuda") -> IndexedData:
    """Per-cell weighted top-K gene windows and the selection-frequency
    log q."""
    d, n = data.num_rows, data.num_columns
    w = (None if gene_weights is None
         else torch.from_numpy(np.asarray(gene_weights, np.float32)).to(device))
    ids = np.full((n, k), d, np.int32)
    vals = np.zeros((n, k), np.float32)
    for blk in visit_columns_by_block(data, block_size=block_size):
        rows, ptr, v = block_to_device(blk, device)
        x = sparse_ops.densify_block(rows, sparse_ops.col_ids_from_ptr(ptr), v,
                                     ncols=blk.ncols, num_genes=d)
        bi, bv = topk_rows(x, k, w)
        ids[blk.lb : blk.lb + blk.ncols] = bi.cpu().numpy()
        vals[blk.lb : blk.lb + blk.ncols] = bv.cpu().numpy()
    return IndexedData(ids=ids, vals=vals, log_q=selection_log_q(ids, d), n_genes=d)


def union_ids(ids: torch.Tensor, u_cap: int, d: int) -> torch.Tensor:
    """`jnp.unique(ids, size=u_cap, fill_value=d)`: the sorted distinct
    ids, the smallest `u_cap` of them, padded with `d` (no host sync)."""
    s = torch.sort(ids.reshape(-1).long()).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.long(), 0) - 1
    keep = first & (pos < u_cap)
    out = torch.full((u_cap,), d, dtype=torch.long, device=ids.device)
    out[pos[keep]] = s[keep]
    return out


# ---- modules ------------------------------------------------------------------

# Softmax temperature of the gene-module membership (cosine logits in [-1, 1])
_MODULE_TEMP = 0.1
# floor on a module's coverage used as a divisor
_EPS_COVERAGE = 1e-2


class IndexedEmbeddingEncoder(nn.Module):
    """Pools `rho[ids]` weighted by the normalised Anscombe values into a
    latent head. `rho` comes from the model (the ETM tie). With
    `with_null` the batch-null stream on the window genes pools through
    the same rho and concatenates. `n_gene_modules = M > 0` adds M learned
    centroids over the embedding space and, per cell and module, the
    coverage-floored level `log u` and `log1p` coverage (2M inputs).
    The BatchNorm is flax's (`momentum=0.9, epsilon=1e-4`)."""

    def __init__(self, embed_dim: int, n_topics: int, hidden: int, n_gene_modules: int = 0,
                 with_null: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.n_gene_modules = n_gene_modules
        self.with_null = with_null
        in_dim = embed_dim * (2 if with_null else 1) + 2 * n_gene_modules
        if n_gene_modules > 0:
            self.module_centroids = nn.Parameter(
                0.1 * torch.randn(embed_dim, n_gene_modules, generator=generator))
        self.hidden = dense(in_dim, hidden, generator)
        self.bn = FlaxBatchNorm(hidden)
        self.z_mean = dense(hidden, n_topics, generator)
        self.z_lnvar = dense(hidden, n_topics, generator)

    def forward(self, rho_dh, ids, vals, *, train: bool, null_vals=None):
        if (null_vals is not None) != self.with_null:
            raise ValueError("the encoder was built with_null=%s but got %s null stream"
                             % (self.with_null, "a" if null_vals is not None else "no"))
        a_raw = anscombe_lite(vals)
        a = a_raw / torch.clamp(a_raw.sum(-1, keepdim=True), min=1e-6)
        emb = gather_rows(rho_dh, ids)  # [B, K, H]
        pooled = torch.einsum("bk,bkh->bh", a, emb)
        if null_vals is not None:
            a0 = anscombe_lite(null_vals)
            a0 = a0 / torch.clamp(a0.sum(-1, keepdim=True), min=1e-6)
            pooled = torch.cat([pooled, torch.einsum("bk,bkh->bh", a0, emb)], dim=-1)
        if self.n_gene_modules > 0:
            visible = vals > 0.0  # pads and masked slots carry 0
            e_n = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)
            c = self.module_centroids
            c_n = c / torch.clamp(torch.linalg.vector_norm(c, dim=0, keepdim=True), min=1e-8)
            mem = torch.softmax(torch.einsum("bkh,hm->bkm", e_n, c_n) / _MODULE_TEMP, dim=-1)
            mem_vis = mem * visible[..., None]
            cov = mem_vis.sum(1)  # [B, M]
            u = torch.einsum("bkm,bk->bm", mem_vis, a_raw) / torch.clamp(cov, min=_EPS_COVERAGE)
            has_visible = visible.any(-1, keepdim=True).to(pooled.dtype)
            feats = torch.cat([torch.log(u + 1e-6), torch.log1p(cov)], dim=-1)
            pooled = torch.cat([pooled, feats * has_visible], dim=-1)
        h = self.bn(torch.relu(self.hidden(pooled)), train=train)
        return soft_clamp(self.z_mean(h)), soft_clamp(self.z_lnvar(h))


class MaskedTopicModel(nn.Module):
    """Shared-rho ETM with masked-gene imputation: beta = softmax(alpha
    rho^T) over the union. `latent`: simplex (masked-topic), gaussian
    (masked-vae, a `theta_readout` maps the latent to mixture weights,
    weak KL) or sbp (masked-sbp, stick breaking). `masked_likelihood`:
    nb (library-scaled) or multinomial on the masked positions. Inits
    are flax's: rho, alpha, the centroids N(0, 0.1^2), log_phi 0.693."""

    def __init__(self, n_genes: int, n_topics: int, embed_dim: int = 64, hidden: int = 128,
                 latent: str = "simplex", kl_weight: float = 1e-3, n_gene_modules: int = 0,
                 masked_likelihood: str = "nb", with_null: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if latent not in ("simplex", "gaussian", "sbp"):
            raise ValueError(f"unknown latent {latent!r}")
        if masked_likelihood not in ("nb", "multinomial"):
            raise ValueError(f"unknown masked likelihood {masked_likelihood!r}")
        self.n_genes, self.n_topics = n_genes, n_topics
        self.latent, self.kl_weight = latent, kl_weight
        self.masked_likelihood = masked_likelihood
        self.rho = nn.Parameter(0.1 * torch.randn(n_genes + 1, embed_dim, generator=generator))
        self.alpha = nn.Parameter(0.1 * torch.randn(n_topics, embed_dim, generator=generator))
        self.log_phi = nn.Parameter(torch.full((n_genes + 1,), 0.693))
        self.encoder = IndexedEmbeddingEncoder(embed_dim, n_topics, hidden, n_gene_modules,
                                               with_null, generator)
        if latent == "gaussian":
            self.theta_readout = dense(n_topics, n_topics, generator)

    def encode(self, ids, vals, *, train: bool, null_vals=None):
        return self.encoder(self.rho, ids, vals, train=train, null_vals=null_vals)

    def latent_log_simplex(self, z):
        if self.latent == "sbp":
            return losses.stick_breaking_log_simplex(z)
        if self.latent == "gaussian":
            return torch.log_softmax(self.theta_readout(z), dim=-1)
        return torch.log_softmax(z, dim=-1)

    def union_log_softmax(self, union, log_q_u, valid_u):
        """log_softmax(alpha rho_u^T - log q_u) over the union's valid ids."""
        # the union's ids are distinct but for the pad id D, whose columns
        # are masked out (zero gradient): plain indexing adds in any order
        # to the same bits
        w_ku = self.alpha @ self.rho[union].T - log_q_u[None, :]
        return torch.log_softmax(torch.where(valid_u[None, :], w_ku, -1e30), dim=-1)

    def forward(self, ids, vals, union, log_q_u, valid_u, mask, *, train: bool,
                eps: torch.Tensor | None = None, null_vals=None):
        """(per-cell loss, log theta): encode from the unmasked window
        positions (with the caller's standard-normal `eps` when
        training), score the masked positions under the union
        reconstruction."""
        keep_vals = torch.where(mask, torch.zeros_like(vals), vals)
        z_mean, z_lnvar = self.encode(ids, keep_vals, train=train, null_vals=null_vals)
        z = losses.gaussian_reparameterize(z_mean, z_lnvar, eps) if train and eps is not None else z_mean
        log_theta = self.latent_log_simplex(z)
        log_beta_u = self.union_log_softmax(union, log_q_u, valid_u)  # [T, U]
        log_recon_u = torch.log(torch.exp(log_theta) @ torch.exp(log_beta_u) + 1e-30)
        ids_l = ids.long()
        slot = torch.clamp(torch.searchsorted(union, ids_l), 0, union.shape[0] - 1)
        hit = union[slot] == ids_l
        log_p = torch.gather(log_recon_u, 1, slot)
        scored = mask & hit
        zero = torch.zeros_like(vals)
        if self.masked_likelihood == "multinomial":
            llik = torch.where(scored, vals * log_p, zero).sum(-1)
            n_scored = torch.clamp(torch.where(scored, vals, zero).sum(-1), min=1.0)
        else:
            mu = torch.exp(log_p) * vals.sum(-1, keepdim=True)
            elem = losses.nb_log_likelihood_elem(vals, mu, gather_rows(self.log_phi, ids_l))
            llik = torch.where(scored, elem, zero).sum(-1)
            n_scored = torch.clamp(scored.sum(-1), min=1).to(vals.dtype)
        loss = -(llik / n_scored)
        if self.latent == "gaussian":
            loss = loss + self.kl_weight * losses.gaussian_kl(z_mean, z_lnvar)
        return loss, log_theta


# ---- trainer ------------------------------------------------------------------


@dataclass
class MaskedTrainConfig:
    """The JAX package's `MaskedTrainConfig`; `mesh` is the port's
    (`parallel/mesh.py::Mesh`)."""

    epochs: int = 100
    minibatch: int = 256
    learning_rate: float = 1e-3
    mask_frac: float = 0.15
    mask_schedule: str = "fixed"  # fixed | uniform (a rate per minibatch)
    mask_rate_lo: float = 0.05
    mask_rate_hi: float = 0.5
    union_size: int = 4096
    weight_decay: float = 0.01
    grad_clip: float = 0.0  # 0 = off
    feature_embedding_l2: float = 0.0
    eval_mask_frac: float = 0.0  # held-out masked eval after training (0 = skip)
    eval_seed: int = 0
    seed: int = 0
    # rows of rho initialised from a prior run and held fixed (mask 1)
    frozen_rho_init: "np.ndarray | None" = None  # [n_genes + 1, H]
    frozen_rho_mask: "np.ndarray | None" = None  # [n_genes + 1]
    init_rho: "np.ndarray | None" = None  # [n_genes + 1, H], trainable
    # batch-null stream: plane [n_genes + 1, M] indexed per cell by membership [N]
    null_plane: "np.ndarray | None" = None
    null_membership: "np.ndarray | None" = None
    mesh: "object | None" = None


def masked_keys(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(init key, training key) of `train_masked`: `split(key(seed))`."""
    k_init, key = prng.split(prng.key(seed))
    return k_init, key


def _epoch_keys(key: np.ndarray, epochs: int, chunk: int = 10):
    """Per-epoch keys of the JAX package's chunked fold: per chunk of 10
    `key, kc = split(key)`, then `split(kc, n)`."""
    done = 0
    while done < epochs:
        n_e = min(chunk, epochs - done)
        key, kc = prng.split(key)
        yield from prng.split(kc, n_e)
        done += n_e


class _Batcher:
    """A minibatch's union, log q and null stream on the device."""

    def __init__(self, data: IndexedData, cfg: MaskedTrainConfig, device):
        self.d = data.n_genes
        self.u_cap = min(cfg.union_size, self.d + 1)
        self.log_q = torch.from_numpy(data.log_q).to(device)
        self.use_null = cfg.null_plane is not None and cfg.null_membership is not None
        n = data.ids.shape[0]
        self.plane = (torch.from_numpy(np.asarray(cfg.null_plane, np.float32)).to(device)
                      if self.use_null else None)
        self.memb = torch.from_numpy(
            np.asarray(cfg.null_membership if self.use_null else np.zeros(n), np.int64)).to(device)

    def __call__(self, ids_b, memb_b, union_of=None):
        """`union_of`: the ids whose union is taken (the whole minibatch's
        when `ids_b` is a rank's share of it)."""
        union = union_ids(ids_b if union_of is None else union_of, self.u_cap, self.d)
        null_b = self.plane[ids_b.long(), memb_b[:, None]] if self.use_null else None
        return union, self.log_q[union], union < self.d, null_b


def masked_eval_loss(model: MaskedTopicModel, data: IndexedData, cfg: MaskedTrainConfig, *,
                     device="cuda") -> float:
    """Held-out masked scoring at a fixed seed and rate: the first
    `nb * minibatch` cells (nb = max(N // minibatch, 1)), minibatch b
    masked by `uniform(split(key(eval_seed), nb)[b], [mb, K]) <
    eval_mask_frac` on its nonzero slots, the model at eval; the mean of
    the minibatch means."""
    device = torch.device(device)
    n, k = data.ids.shape
    mb = cfg.minibatch
    nb = max(n // mb, 1)
    batch = _Batcher(data, cfg, device)
    keys = prng.split(prng.key(cfg.eval_seed), nb)
    u = prng.uniform_keys(keys, mb * k, device).view(nb, mb, k)
    ids = torch.from_numpy(data.ids).to(device)
    vals = torch.from_numpy(data.vals).to(device)
    model.eval()
    total = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        for b in range(nb):
            sl = slice(b * mb, (b + 1) * mb)
            ids_b, vals_b = ids[sl], vals[sl]
            mask = (u[b, : ids_b.shape[0]] < cfg.eval_mask_frac) & (vals_b > 0)
            union, lq, valid, null_b = batch(ids_b, batch.memb[sl])
            loss, _ = model(ids_b, vals_b, union, lq, valid, mask, train=False, null_vals=null_b)
            total = total + loss.mean()
    return float(total / nb)


def train_masked(model: MaskedTopicModel, data: IndexedData,
                 config: MaskedTrainConfig | None = None, *, device="cuda"):
    """Masked-imputation training of `model` in place with AdamW (decoupled
    weight decay on every parameter), an optional non-finite-safe
    global-norm clip (a non-finite norm skips the step), the optional
    L2 on rho, and rows of rho held fixed (their whole update zeroed,
    decay included). Returns (model, per-epoch mean loss trace, held-out
    eval loss or None; under a mesh the eval runs on rank 0 alone)."""
    cfg = config or MaskedTrainConfig()
    device = torch.device(device)
    mesh = live(cfg.mesh)
    n, k = data.ids.shape
    mb = cfg.minibatch
    model.to(device)
    _, key = masked_keys(cfg.seed)
    frozen = None
    with torch.no_grad():
        if cfg.init_rho is not None and cfg.frozen_rho_init is None:
            model.rho.copy_(torch.from_numpy(np.asarray(cfg.init_rho, np.float32)))
        if cfg.frozen_rho_init is not None:
            model.rho.copy_(torch.from_numpy(np.asarray(cfg.frozen_rho_init, np.float32)))
            frozen = torch.from_numpy(np.asarray(cfg.frozen_rho_mask) > 0).to(device)
    params = list(model.parameters())
    if mesh is not None:
        model.encoder.bn.mesh = mesh  # the batch statistics span the ranks
        with torch.no_grad():  # rank 0's initial state on every rank
            for t in [*params, *model.buffers()]:
                replicate(mesh, t)
    a, b_ = (0, mb) if mesh is None else data_sharding(mesh, mb)
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    batch = _Batcher(data, cfg, device)
    ids_all = torch.from_numpy(data.ids).to(device)
    vals_all = torch.from_numpy(data.vals).to(device)
    num_mb = max(n // mb, 1)
    t = model.n_topics
    trace = []
    model.train()
    for ek in _epoch_keys(key, cfg.epochs):
        kperm, kscan = prng.split(ek)
        perm = torch.from_numpy(prng.permutation(kperm, n)[: num_mb * mb]).to(device)
        # per minibatch: split(kb, 3) -> (mask, rate, noise) keys
        sub = np.stack([prng.split(kb, 3) for kb in prng.split(kscan, num_mb)])
        mask_u = prng.uniform_keys(sub[:, 0], mb * k, device).view(num_mb, mb, k)
        noise = prng.normal_keys(sub[:, 2], mb * t, device).view(num_mb, mb, t)
        if cfg.mask_schedule == "uniform":
            rates = prng.uniform_keys(sub[:, 1], 1, device, cfg.mask_rate_lo, cfg.mask_rate_hi)[:, 0]
        else:
            rates = torch.full((num_mb,), cfg.mask_frac, dtype=torch.float32, device=device)
        losses_mb = torch.zeros(num_mb, dtype=torch.float32, device=device)
        for b in range(num_mb):
            whole = perm[b * mb : (b + 1) * mb]
            idx = whole if mesh is None else whole[a:b_]
            ids_b, vals_b = ids_all[idx], vals_all[idx]
            rows = ids_b.shape[0]
            mask = (mask_u[b, a : a + rows] < rates[b]) & (vals_b > 0)
            union, lq, valid, null_b = batch(ids_b, batch.memb[idx],
                                             None if mesh is None else ids_all[whole])
            loss, _ = model(ids_b, vals_b, union, lq, valid, mask, train=True,
                            eps=noise[b, a : a + rows], null_vals=null_b)
            loss = loss.mean() if mesh is None else loss.sum() / whole.shape[0]
            if cfg.feature_embedding_l2 > 0 and (mesh is None or mesh.primary):
                loss = loss + cfg.feature_embedding_l2 * torch.mean(torch.sum(model.rho**2, dim=1))
            opt.zero_grad(set_to_none=False)
            loss.backward()
            if mesh is not None:  # the gradients and the loss, summed across the ranks
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                loss = loss.detach().reshape(1).clone()
                sum_grads_(mesh, [*(p.grad for p in params), loss])
                loss = loss[0]
            if cfg.grad_clip > 0:
                clip_grads_nonfinite_(params, cfg.grad_clip)
            if frozen is not None:
                kept = model.rho.detach()[frozen].clone()
            opt.step()
            if frozen is not None:
                with torch.no_grad():
                    model.rho[frozen] = kept
            losses_mb[b] = loss.detach()
        trace.append(losses_mb.mean())
    trace = torch.stack(trace).cpu().numpy().tolist() if trace else []
    eval_loss = (masked_eval_loss(model, data, cfg, device=device)
                 if cfg.eval_mask_frac > 0 and (mesh is None or mesh.primary) else None)
    return model, trace, eval_loss


@torch.no_grad()
def encode_all(model: MaskedTopicModel, data: IndexedData, *, batch: int = 4096,
               raw_latent: bool = False, null_plane: np.ndarray | None = None,
               null_membership: np.ndarray | None = None, device="cuda") -> np.ndarray:
    """Eval-mode log topic proportions (or, with `raw_latent`, the
    Gaussian latent means: masked-vae's output) of every cell."""
    device = torch.device(device)
    model.to(device).eval()
    use_null = null_plane is not None and null_membership is not None
    plane = torch.from_numpy(np.asarray(null_plane, np.float32)).to(device) if use_null else None
    memb = torch.from_numpy(np.asarray(null_membership, np.int64)).to(device) if use_null else None
    pieces = []
    for lb in range(0, data.ids.shape[0], batch):
        ids = torch.from_numpy(data.ids[lb : lb + batch]).to(device)
        vals = torch.from_numpy(data.vals[lb : lb + batch]).to(device)
        null = plane[ids.long(), memb[lb : lb + batch, None]] if use_null else None
        z_mean, _ = model.encode(ids, vals, train=False, null_vals=null)
        pieces.append(z_mean if raw_latent else model.latent_log_simplex(z_mean))
    if not pieces:
        return np.zeros((0, model.n_topics), np.float32)
    return torch.cat(pieces).cpu().numpy()
