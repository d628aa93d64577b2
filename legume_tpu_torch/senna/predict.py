"""`senna predict` / `eval-topic`: held-out latent inference (the port of
the JAX package's `senna/predict.py`).

Loads a model saved in either package (weights, metadata, training gene
names) and maps the held-out backend's gene rows onto the training
vocabulary (case-insensitive exact match, then `_` tokens; many-to-one).
By the model's type:

- `topic` (every decoder family, coarsened and multi-decoder models too,
  though only the encoder scores): cell blocks stream through the
  encoder at eval, optionally with a per-batch null stream, per-batch
  delta estimation and per-cell refinement against the frozen
  dictionary;
- `vae`: the same blocks through the Gaussian encoder (latent `z{k}`);
- `masked-*`: top-K windows on the held-out genes, remapped to the
  training vocabulary, through the indexed encoder.

Outputs `{out}.latent` (and `{out}.delta`) tables and a manifest.

Every entry point runs on the card unless the caller passes
`device="cpu"`. The refinement's product keeps full float32 on the card
(`refine_topic_proportions` turns TF32 off around it).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..data import SparseIoVec
from ..data.visitors import visit_columns_by_block
from ..models.convert import masked_params_from_jax
from ..models.indexed import (
    IndexedData,
    MaskedTopicModel,
    build_topk_windows,
    encode_all,
    selection_log_q,
)
from ..ops import sparse as sparse_ops
from ..utils.manifest import RunManifest
from ..utils.output import matrix_columns, read_table, table_path, write_table
from ..utils.precision import full_f32_matmul
from .topic import build_encoder, build_model, load_data_vec, load_model

log = logging.getLogger(__name__)


@dataclass
class GeneRemap:
    """new-data row -> training gene position."""

    new_to_train: np.ndarray  # [D_new] int64, -1 = unmapped
    d_train: int

    @property
    def n_mapped(self) -> int:
        return int((self.new_to_train >= 0).sum())

    @property
    def row_map(self) -> np.ndarray:
        """[D_new] training position of each row, `d_train` where unmapped."""
        return np.where(self.new_to_train >= 0, self.new_to_train, self.d_train)


def build_gene_remap(training_genes: Sequence[str], new_genes: Sequence[str]) -> GeneRemap:
    """Case-insensitive exact match with a fallback on `_`-delimited
    tokens (ENSG..._CD8A <-> CD8A)."""
    train_pos = {str(g).lower(): i for i, g in enumerate(training_genes)}
    token_pos: dict[str, int] = {}
    for i, g in enumerate(training_genes):
        for tok in str(g).lower().split("_"):
            token_pos.setdefault(tok, i)

    out = np.full(len(new_genes), -1, np.int64)
    for j, g in enumerate(new_genes):
        gl = str(g).lower()
        if gl in train_pos:
            out[j] = train_pos[gl]
            continue
        for tok in gl.split("_"):
            if tok in token_pos:
                out[j] = token_pos[tok]
                break
    return GeneRemap(new_to_train=out, d_train=len(training_genes))


def refine_topic_proportions(
    log_z: torch.Tensor,  # [N, K] encoder log-softmax output
    x: torch.Tensor,  # [N, D] counts (training-vocab aligned)
    log_dict: torch.Tensor,  # [D, K] bias-free log dictionary
    *,
    steps: int = 10,
    lr: float = 0.01,
    reg: float = 1.0,
) -> torch.Tensor:
    """Per-cell refinement: `steps` gradient steps on the topic logits of
    `reg * sum (logits - init)^2 - mean_N sum_D x log(softmax(logits) @
    exp(log_dict).T + 1e-30)`, from init = `log_z`; returns the refined
    log-proportions. The gradient is the closed form of that loss (the
    JAX package takes it by autodiff): with p = softmax(logits) and
    G = (x / recon) @ exp(log_dict), d/dlogits = 2 reg (logits - init)
    - p * (G - sum_k p G) / N. The mean runs over the rows given, so the
    result depends on how the caller blocks the cells."""
    init = log_z.detach()
    beta_kd = torch.exp(log_dict.T)  # [K, D]
    x_pos = torch.clamp(x, min=0.0)
    n = x.shape[0]
    logits = init.clone()
    with full_f32_matmul():
        for _ in range(steps):
            p = torch.softmax(logits, dim=1)
            recon = p @ beta_kd + 1e-30  # one product in linear space
            g = (x_pos / recon) @ beta_kd.T  # [N, K]
            g_logits = p * (g - (p * g).sum(1, keepdim=True))
            logits = logits - lr * (2.0 * reg * (logits - init) - g_logits / n)
    return torch.log_softmax(logits, dim=1)


@dataclass
class PredictArgs:
    data_files: Sequence[str] = ()
    model: str = ""  # output prefix of a `senna topic` run
    out: str = "predict"
    block_size: int = 4096
    # per-batch null stream + refinement against the frozen dictionary
    batch_files: Optional[Sequence[str]] = None
    refine_steps: int = 0
    refine_lr: float = 0.01
    refine_reg: float = 1.0
    # skip the encoder: optimise theta against the frozen dictionary from
    # a uniform start (steps default 100, lr default 0.05)
    decoder_only: bool = False
    # delta refinement sweeps over the plug-in per-batch delta (0 = plug-in)
    delta_iters: int = 0
    # residual expression x / (mu * lambda) per cell, entries > threshold
    # written to a new .zarr / .zarr.zip / .h5
    residual_out: Optional[str] = None
    residual_include_delta: bool = False
    residual_threshold: float = 0.0


# delta estimation guards
_DELTA_CLAMP_MIN = 0.01
_DELTA_CLAMP_MAX = 100.0
_DELTA_PRED_EPS = 1e-10


def _mapped_entries(blk, remap: GeneRemap):
    """(training row, local cell, value) of a block's mapped entries."""
    mapped = remap.row_map[blk.row_ids]
    keep = mapped < remap.d_train
    return mapped[keep], blk.col_ids[keep], blk.vals[keep]


def estimate_plugin_delta(
    vec: SparseIoVec,
    remap: GeneRemap,
    cell_batch: np.ndarray,
    log_dict: np.ndarray,  # [D_train, K]
    theta_mean: np.ndarray | None,
    *,
    block_size: int = 4096,
) -> np.ndarray:
    """Plug-in per-batch delta on the training gene axis: delta[d, b] =
    (pb[d, b] / lib_b) / predicted[d], with predicted the theta-bar
    weighted dictionary marginal, clamped to [0.01, 100]."""
    d_train, k = log_dict.shape
    n_batches = int(cell_batch.max()) + 1
    w = (
        theta_mean / max(float(theta_mean.sum()), 1e-12)
        if theta_mean is not None and theta_mean.sum() > 0
        else np.full(k, 1.0 / k, np.float32)
    )
    predicted = np.exp(log_dict) @ w.astype(np.float32)  # [D_train]
    s = float(predicted.sum())
    if s > 0:
        predicted = predicted / s

    pb = np.zeros(d_train * n_batches, np.float64)
    for blk in visit_columns_by_block(vec, block_size=block_size):
        rows, cols, vals = _mapped_entries(blk, remap)
        b = cell_batch[blk.lb + cols]
        pb += np.bincount(rows * n_batches + b, weights=vals, minlength=pb.size)
    pb = pb.reshape(d_train, n_batches)

    delta = np.ones((d_train, n_batches), np.float32)
    for b in range(n_batches):
        lib = pb[:, b].sum()
        if lib <= 0:
            continue
        delta[:, b] = np.clip(
            (pb[:, b] / lib) / np.maximum(predicted, _DELTA_PRED_EPS),
            _DELTA_CLAMP_MIN, _DELTA_CLAMP_MAX,
        ).astype(np.float32)
    return delta


def _dense_block(blk, remap: GeneRemap, device) -> torch.Tensor:
    """[ncols, D_train] counts of a block on the training gene axis
    (unmapped genes dropped, many-to-one genes summed)."""
    rows, cols, vals = _mapped_entries(blk, remap)
    return sparse_ops.densify_block(
        torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device),
        torch.from_numpy(vals).to(device), ncols=blk.ncols, num_genes=remap.d_train,
    )


@torch.no_grad()
def iterate_delta_dense(
    n_iters: int,
    delta: np.ndarray,  # [D_train, B]
    vec: SparseIoVec,
    encoder,
    remap: GeneRemap,
    log_dict: np.ndarray,  # [D_train, K]
    phi: np.ndarray | None,  # [D_train] NB dispersion or None
    cell_batch: np.ndarray,
    *,
    block_size: int = 4096,
    device="cuda",
) -> np.ndarray:
    """Delta sweeps: each encodes every cell with the current delta as
    its null row, forms mu = lib * (theta @ exp(log_dict).T), and
    re-solves delta[d, b] = sum_b w x / sum_b w mu with NB weights
    w = phi / (mu + phi) (uniform when phi is None)."""
    n_batches = delta.shape[1]
    exp_beta = torch.exp(torch.from_numpy(log_dict).to(device))  # [D_train, K]
    phi_t = torch.from_numpy(phi).to(device) if phi is not None else None
    batch_t = torch.from_numpy(np.asarray(cell_batch, np.int64)).to(device)
    encoder.eval()
    for _ in range(max(n_iters, 0)):
        delta_bd = torch.from_numpy(np.ascontiguousarray(delta.T)).to(device)
        obs = torch.zeros(n_batches, remap.d_train, dtype=torch.float64, device=device)
        pred = torch.zeros_like(obs)
        for blk in visit_columns_by_block(vec, block_size=block_size):
            x = _dense_block(blk, remap, device)
            b_ids = batch_t[blk.lb : blk.lb + blk.ncols]
            log_z, _ = encoder(x, delta_bd[b_ids], train=False)
            mu = x.sum(1, keepdim=True) * (torch.exp(log_z) @ exp_beta.T)  # [N, D_train]
            w = phi_t / (mu + phi_t) if phi_t is not None else torch.ones_like(mu)
            obs.index_add_(0, b_ids, (w * x).double())
            pred.index_add_(0, b_ids, (w * mu).double())
        delta = np.clip(
            (obs / torch.clamp(pred, min=_DELTA_PRED_EPS)).T.cpu().numpy(),
            _DELTA_CLAMP_MIN, _DELTA_CLAMP_MAX,
        ).astype(np.float32)
    return delta


@torch.no_grad()
def residual_csc(
    vec: SparseIoVec,
    z_nk: np.ndarray,  # [N, K] log-topic proportions
    log_dict: np.ndarray,  # [D_train, K]
    remap: GeneRemap,
    *,
    delta_db: np.ndarray | None = None,  # [D_train, B], folded in when given
    cell_batch: np.ndarray | None = None,
    threshold: float = 0.0,
    block_size: int = 4096,
    device="cuda",
) -> sp.csc_matrix:
    """Residual expression on the held-out gene axis: per cell j,
    x_dj / (mu_dj l_j) with mu = exp(log_dict) theta_j through the gene
    map (genes outside the model pass through unchanged) and l_j =
    sum x / sum mu over the cell's entries; optionally mu times the
    cell's batch delta. Entries <= `threshold` are dropped when it is
    positive."""
    exp_beta = torch.exp(torch.from_numpy(log_dict).to(device))  # [D_train, K]
    theta = torch.exp(torch.from_numpy(np.ascontiguousarray(z_nk)).to(device))
    new_to_train = torch.from_numpy(remap.new_to_train).to(device)
    fold = delta_db is not None and cell_batch is not None
    if fold:
        delta_t = torch.from_numpy(delta_db).to(device)
        batch_t = torch.from_numpy(np.asarray(cell_batch, np.int64)).to(device)
    n = vec.num_columns
    blocks = []
    for lb in range(0, n, block_size):
        ub = min(lb + block_size, n)
        csc = sp.csc_matrix(vec.read_columns_csc(np.arange(lb, ub)))
        x = torch.from_numpy(csc.data.astype(np.float32)).to(device)
        cols = torch.from_numpy(np.repeat(np.arange(ub - lb), np.diff(csc.indptr))).to(device)
        tr = new_to_train[torch.from_numpy(csc.indices.astype(np.int64)).to(device)]
        known = tr >= 0
        trc = torch.clamp(tr, min=0)
        with full_f32_matmul():
            pred = theta[lb:ub] @ exp_beta.T  # [n_block, D_train]
        mu = torch.where(known, pred[cols, trc], 0.0)
        if fold:
            mu = mu * torch.where(known, delta_t[trc, batch_t[lb + cols]], 1.0)
        mu_sum = torch.zeros(ub - lb, dtype=torch.float64, device=device).index_add_(0, cols, mu.double())
        x_sum = torch.zeros_like(mu_sum).index_add_(0, cols, x.double())
        lam = torch.where(mu_sum > 0, x_sum / torch.where(mu_sum > 0, mu_sum, 1.0), 1.0)
        denom = mu.double() * lam[cols]
        data = torch.where(denom > 0, x.double() / torch.clamp(denom, min=1e-30), x.double()).float()
        out = sp.csc_matrix((data.cpu().numpy(), csc.indices.copy(), csc.indptr.copy()), shape=csc.shape)
        if threshold > 0:
            out.data[out.data <= threshold] = 0.0
            out.eliminate_zeros()
        blocks.append(out)
    return sp.hstack(blocks, format="csc") if blocks else sp.csc_matrix((vec.num_rows, 0))


def write_residual_backend(
    args: PredictArgs,
    vec: SparseIoVec,
    z_nk: np.ndarray,
    log_dict: np.ndarray,
    delta_db: np.ndarray | None,
    remap: GeneRemap,
    cell_batch: np.ndarray | None,
    *,
    device="cuda",
) -> None:
    """`residual_csc` written to `args.residual_out` with the held-out
    names (`.h5` needs h5py)."""
    from ..data.sparse_io import create_sparse_from_csc

    residual = residual_csc(
        vec, z_nk, log_dict, remap,
        delta_db=delta_db if args.residual_include_delta else None, cell_batch=cell_batch,
        threshold=args.residual_threshold, block_size=args.block_size, device=device,
    )
    create_sparse_from_csc(residual, args.residual_out, vec.row_names(), vec.column_names())
    log.info("wrote residual backend %s (%d x %d, %d nnz)", args.residual_out,
             residual.shape[0], residual.shape[1], residual.nnz)


def read_batch_labels(batch_files: Sequence[str], n_cells: int) -> np.ndarray:
    """Per-cell batch ids, numbered in `np.unique` order of the labels."""
    labels = []
    for bf in batch_files:
        with open(bf) as f:
            labels.extend(line.strip() for line in f if line.strip())
    if len(labels) != n_cells:
        raise ValueError(f"batch files list {len(labels)} cells, backend has {n_cells}")
    _, cell_batch = np.unique(np.asarray(labels), return_inverse=True)
    return cell_batch.astype(np.int64)


def predict_model(args: PredictArgs, *, vec: SparseIoVec | None = None,
                  device="cuda") -> np.ndarray:
    """End-to-end `senna predict` / `eval-topic`; returns the [N, K]
    latent (log-proportions). `vec` overrides `args.data_files`. The
    manifest's `timings` hold the stage seconds."""
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = t0 = time.time()
    meta, flat, train_genes = load_model(args.model)
    kind = meta.get("model_type", "topic")
    if vec is None:
        vec = load_data_vec(args.data_files)
    remap = build_gene_remap(train_genes, vec.row_names())
    log.info("predict: %d/%d held-out genes map to training vocab",
             remap.n_mapped, len(remap.new_to_train))
    log_dict = None
    if (args.refine_steps > 0 or args.decoder_only or args.residual_out
            or (args.batch_files and args.delta_iters > 0)):
        log_dict = _load_log_dictionary(args.model, train_genes)
    timings["load_s"] = time.time() - t0

    t0 = time.time()
    cell_batch = batch_profiles = None
    if args.batch_files:
        cell_batch = read_batch_labels(args.batch_files, vec.num_columns)
        batch_profiles = _batch_mean_profiles(vec, remap, cell_batch, block_size=args.block_size)
    timings["batch_profiles_s"] = time.time() - t0

    delta_db = None
    col = "topic"
    t0 = time.time()
    if kind.startswith("masked"):
        z = score_masked_backend(vec, meta, flat, remap, device=device)
        col = "z" if meta.get("latent") == "gaussian" else "topic"
        timings["score_s"] = time.time() - t0
    elif kind == "vae":
        encoder = build_encoder(meta, flat, device=device)
        z = score_dense_backend(vec, encoder, remap, block_size=args.block_size,
                                cell_batch=cell_batch, batch_profiles=batch_profiles, device=device)
        col = "z"
        timings["score_s"] = time.time() - t0
    else:
        z, delta_db = _predict_topic(args, vec, meta, flat, train_genes, remap, log_dict,
                                     cell_batch, batch_profiles, timings, device)

    t0 = time.time()
    if delta_db is not None:
        write_table(f"{args.out}.delta", {
            "gene": np.asarray([str(g) for g in train_genes]),
            **{f"batch{b}": delta_db[:, b] for b in range(delta_db.shape[1])},
        })
    outputs = {"latent": write_table(f"{args.out}.latent",
                                     matrix_columns(z, col, "cell", vec.column_names()))}
    if args.residual_out:
        outputs["residual"] = str(args.residual_out)
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    RunManifest(
        command="predict",
        inputs={"data_files": list(args.data_files), "model": args.model},
        outputs=outputs,
        params={"n_mapped": remap.n_mapped},
        timings=timings,
        engine="legume-tpu-torch",
    ).save(args.out)
    return z


def _predict_topic(args: PredictArgs, vec, meta, flat, train_genes, remap: GeneRemap, log_dict,
                   cell_batch, batch_profiles, timings: dict, device):
    """A topic model's latent (and per-batch delta, or None): delta
    estimation, the encoder with refinement, the residual backend."""
    encoder, _ = build_model(meta, flat, device=device)
    t0 = time.time()
    delta_db = None
    if cell_batch is not None and log_dict is not None and args.delta_iters >= 0:
        delta_db = estimate_plugin_delta(
            vec, remap, cell_batch, log_dict, _load_theta_mean(args.model),
            block_size=args.block_size,
        )
        if args.delta_iters > 0:
            delta_db = iterate_delta_dense(
                args.delta_iters, delta_db, vec, encoder, remap, log_dict,
                _load_dispersion(args.model, train_genes), cell_batch,
                block_size=args.block_size, device=device,
            )
    timings["delta_s"] = time.time() - t0

    t0 = time.time()
    refine_steps, refine_lr = args.refine_steps, args.refine_lr
    if args.decoder_only:  # decoder-only defaults
        refine_steps = refine_steps or 100
        refine_lr = 0.05 if refine_lr <= 0.01 else refine_lr
    z = score_dense_backend(
        vec, encoder, remap, block_size=args.block_size, cell_batch=cell_batch,
        batch_profiles=batch_profiles, log_dict=log_dict, refine_steps=refine_steps,
        refine_lr=refine_lr, refine_reg=args.refine_reg, decoder_only=args.decoder_only,
        device=device,
    )
    timings["score_s"] = time.time() - t0

    t0 = time.time()
    if args.residual_out:
        write_residual_backend(args, vec, z, log_dict, delta_db, remap, cell_batch, device=device)
    timings["residual_s"] = time.time() - t0
    return z, delta_db


def score_masked_backend(vec: SparseIoVec, meta: dict, flat: dict, remap: GeneRemap, *,
                         device="cuda") -> np.ndarray:
    """Held-out inference of a masked model: top-K windows on the held-out
    genes, ids remapped to the training vocabulary (unmapped genes and
    the pad to `d_train`), log q over the training axis, the indexed
    encoder at eval. A model trained with a batch-null stream
    (`--batch-files`) raises: predict has no null stream for it, and the
    JAX package's predict fails on such a model too."""
    state = masked_params_from_jax(flat)
    embed_dim, modules = int(meta.get("embed_dim", 64)), int(meta.get("gene_modules", 0))
    hidden, in_dim = state["encoder.hidden.weight"].shape
    if in_dim != embed_dim + 2 * modules:
        raise ValueError(
            f"masked model {meta.get('model_type')} was trained with a batch-null stream "
            "(--batch-files): its encoder pools a null stream that senna predict does not "
            f"form ({in_dim} inputs, {embed_dim + 2 * modules} without it)")
    d_train = remap.d_train
    win = build_topk_windows(vec, int(meta.get("window", 128)), device=device)
    pad = win.ids >= vec.num_rows
    ids = remap.row_map[np.clip(win.ids, 0, vec.num_rows - 1)]
    ids[pad] = d_train
    ids = ids.astype(np.int32)
    data = IndexedData(ids=ids, vals=win.vals, log_q=selection_log_q(ids, d_train),
                       n_genes=d_train)
    model = MaskedTopicModel(d_train, int(meta["n_topics"]), embed_dim=embed_dim, hidden=hidden,
                             latent=meta.get("latent", "simplex"), n_gene_modules=modules)
    model.load_state_dict(state)
    return encode_all(model, data, raw_latent=meta.get("latent") == "gaussian", device=device)


def _model_table(model_prefix: str, name: str) -> dict[str, np.ndarray] | None:
    path = table_path(f"{model_prefix}.{name}")
    return read_table(path) if path else None


def _load_theta_mean(model_prefix: str) -> np.ndarray | None:
    """Training topic marginal theta-bar from `{model}.pb_latent` (linear
    space); None -> uniform."""
    t = _model_table(model_prefix, "pb_latent")
    cols = [c for c in t if c.startswith("topic")] if t else []
    return np.stack([t[c] for c in cols], 1).astype(np.float32).mean(0) if cols else None


def _load_dispersion(model_prefix: str, train_genes) -> np.ndarray | None:
    """Per-gene NB dispersion from `{model}.dispersion`, on the training
    gene order (2.0 where a gene is missing)."""
    t = _model_table(model_prefix, "dispersion")
    if t is None:
        return None
    pos = {str(g): float(v) for g, v in zip(t["gene"], t["dispersion"])}
    return np.asarray([pos.get(str(g), 2.0) for g in train_genes], np.float32)


def _load_log_dictionary(model_prefix: str, train_genes) -> np.ndarray:
    """[D_train, K] log dictionary from `{model}.dictionary`, on the
    training gene order."""
    t = _model_table(model_prefix, "dictionary")
    if t is None:
        raise FileNotFoundError(f"{model_prefix}.dictionary.parquet / .npz")
    names = list(t)
    genes = t[names[0]]
    mat = np.stack([t[c] for c in names[1:]], 1).astype(np.float32)
    logd = mat if np.all(mat <= 0) else np.log(np.maximum(mat, 1e-12))  # log already?
    pos = {str(g): i for i, g in enumerate(genes)}
    out = np.full((len(train_genes), mat.shape[1]), np.log(1e-12), np.float32)
    for i, g in enumerate(train_genes):
        j = pos.get(str(g))
        if j is not None:
            out[i] = logd[j]
    return out


def _batch_mean_profiles(
    vec: SparseIoVec, remap: GeneRemap, cell_batch: np.ndarray, *, block_size: int
) -> np.ndarray:
    """[B, D_train] per-batch mean expression on the training gene axis
    (the encoder's null rows for held-out batches)."""
    n_batches = int(cell_batch.max()) + 1
    sums = np.zeros(n_batches * remap.d_train, np.float64)
    for blk in visit_columns_by_block(vec, block_size=block_size):
        rows, cols, vals = _mapped_entries(blk, remap)
        b = cell_batch[blk.lb + cols]
        sums += np.bincount(b * remap.d_train + rows, weights=vals, minlength=sums.size)
    counts = np.bincount(cell_batch, minlength=n_batches)
    sums = sums.reshape(n_batches, remap.d_train)
    return (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)


@torch.no_grad()
def score_dense_backend(
    vec: SparseIoVec,
    encoder,
    remap: GeneRemap,
    *,
    block_size: int = 4096,
    cell_batch: np.ndarray | None = None,
    batch_profiles: np.ndarray | None = None,
    log_dict: np.ndarray | None = None,
    refine_steps: int = 0,
    refine_lr: float = 0.01,
    refine_reg: float = 1.0,
    decoder_only: bool = False,
    device="cuda",
) -> np.ndarray:
    """Blocks of cells -> counts on the training gene axis -> encoder at
    eval (null row: the cell's batch profile), optionally refined per
    block against the frozen dictionary. `decoder_only` skips the
    encoder and refines from the uniform simplex."""
    if decoder_only and log_dict is None:
        raise ValueError("decoder-only inference needs the model dictionary")
    ld = torch.from_numpy(log_dict).to(device) if log_dict is not None else None
    prof = torch.from_numpy(batch_profiles).to(device) if batch_profiles is not None else None
    batch_t = (torch.from_numpy(np.asarray(cell_batch, np.int64)).to(device)
               if prof is not None else None)
    encoder.eval()
    pieces = []
    for blk in visit_columns_by_block(vec, block_size=block_size):
        x = _dense_block(blk, remap, device)
        if decoder_only:
            k = ld.shape[1]
            log_z = torch.full((x.shape[0], k), -float(np.log(k)), device=device)
        else:
            null = prof[batch_t[blk.lb : blk.lb + blk.ncols]] if prof is not None else None
            log_z, _ = encoder(x, null, train=False)
        if refine_steps > 0 and ld is not None:
            log_z = refine_topic_proportions(log_z, x, ld, steps=refine_steps,
                                             lr=refine_lr, reg=refine_reg)
        pieces.append(log_z)
    if not pieces:
        return np.zeros((0, 0), np.float32)
    return torch.cat(pieces).cpu().numpy()
