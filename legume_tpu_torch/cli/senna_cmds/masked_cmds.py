"""`senna masked-topic`, `masked-vae` and `masked-sbp`: the indexed top-K
window models (the port of the JAX package's
`cli/senna_cmds/masked_cmds.py`).

1. load backends; with `--batch-files`, a single-level collapse
   (projection K1, collapse K3) gives the null plane of `--adj-method`
   (per-batch delta or per-group residual), restricted to each cell's
   window genes for the encoder's second pool;
2. per-cell top-K windows (`--window`), optionally restricted to the
   genes of `--feature-network`;
3. optional rho rows from `--frozen-features` (held fixed) or
   `--init-feature-embedding` (trainable);
4. `train_masked`, the held-out masked eval with `--eval-mask-fraction`
   (`{out}.eval.json`), `encode_all`;
5. outputs: `{out}.latent` (`topic{k}`, or `z{k}` for masked-vae),
   `{out}.loss`, `{out}.model.{npz,json}` and `{out}.senna.json`.

Runs on the card unless `--device cpu`. `--data-parallel` runs one rank
a GPU (`parallel/`): every rank repeats steps 1-3 (the window build and
the null stream), the trainer shares each minibatch over the ranks
(`models/indexed.py`), and rank 0 alone runs the eval, encodes and
writes. A world of one is the plain run.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from ...models.convert import masked_params_to_jax
from ...models.indexed import (
    MaskedTopicModel,
    MaskedTrainConfig,
    build_topk_windows,
    encode_all,
    masked_keys,
    train_masked,
)
from ...senna.topic import TopicArgs, load_and_collapse, load_data_vec, read_batch_labels, save_model
from ...utils import prng
from ...utils.manifest import RunManifest
from ...utils.output import matrix_columns, write_table

log = logging.getLogger(__name__)

LATENTS = {"masked-vae": "gaussian", "masked-sbp": "sbp"}


def add_masked_parsers(sub) -> None:
    """The three parsers, with the JAX package's flags and defaults."""
    for name, help_ in (("masked-topic", "indexed top-K masked ETM (simplex latent)"),
                        ("masked-vae", "masked indexed model, Gaussian latent"),
                        ("masked-sbp", "masked indexed model, stick-breaking simplex")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--data-files", nargs="+", required=True)
        p.add_argument("--out", required=True)
        p.add_argument("-k", "--n-latent-topics", type=int, default=10)
        p.add_argument("--window", type=int, default=128, help="top-K genes per cell")
        p.add_argument("--embed-dim", type=int, default=64)
        p.add_argument("--gene-modules", type=int, default=0)
        p.add_argument("--epochs", type=int, default=100)
        p.add_argument("--minibatch-size", type=int, default=256)
        p.add_argument("--mask-frac", type=float, default=0.15)
        p.add_argument("--mask-schedule", choices=["fixed", "uniform"], default="fixed")
        p.add_argument("--mask-rate-lo", type=float, default=0.05)
        p.add_argument("--mask-rate-hi", type=float, default=0.5)
        p.add_argument("--masked-likelihood", choices=["nb", "multinomial"], default="nb")
        p.add_argument("--learning-rate", "--lr", type=float, default=1e-3)
        p.add_argument("--weight-decay", type=float, default=0.01)
        p.add_argument("--grad-clip", type=float, default=0.0)
        p.add_argument("--feature-embedding-l2", type=float, default=0.0)
        p.add_argument("--kl-weight", type=float, default=1e-3)
        p.add_argument("--eval-mask-fraction", type=float, default=0.0)
        p.add_argument("--eval-seed", type=int, default=0)
        p.add_argument("--data-parallel", action="store_true")
        p.add_argument("--frozen-features", default=None)
        p.add_argument("--init-feature-embedding", default=None)
        p.add_argument("--batch-files", nargs="+", default=None)
        p.add_argument("--adj-method", choices=["batch", "residual"], default="residual")
        p.add_argument("--sort-dim", type=int, default=6)
        p.add_argument("--iter-opt", type=int, default=10)
        p.add_argument("--feature-network", default=None)
        p.add_argument("--feature-network-min-degree", type=int, default=0)
        p.add_argument("--feature-network-max-degree", type=int, default=0)
        p.add_argument("--no-feature-network-restrict", action="store_true")
        p.add_argument("--seed", type=int, default=0)
        if name == "masked-topic":
            p.add_argument("--latent", choices=["simplex", "sbp"], default="simplex")
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def null_stream(vec, args, device, timings: dict):
    """(plane [D + 1, M] with a zero pad row, per-cell membership [N]) of
    `--adj-method` from a single-level collapse, or (None, None)."""
    t0 = time.time()
    lv = load_and_collapse(vec, TopicArgs(num_levels=1, sort_dim=args.sort_dim,
                                          iter_opt=args.iter_opt), timings=timings, device=device)
    fin = lv.collapsed[0]
    if args.adj_method == "batch" and fin.delta is not None:
        plane, memb = fin.delta.mean().cpu().numpy(), vec.batch_membership()
    elif fin.mu_residual is not None:
        plane, memb = fin.mu_residual.mean().cpu().numpy(), lv.groups_per_level[0]
    else:
        return None, None
    null_plane = np.zeros((vec.num_rows + 1, plane.shape[1]), np.float32)
    null_plane[:-1] = plane
    log.info("masked null stream: %s plane [%d x %d]", args.adj_method, *plane.shape)
    timings["null_stream_s"] = time.time() - t0
    return null_plane, memb


def network_gene_weights(vec, args) -> np.ndarray | None:
    """0/1 weights of the genes in `--feature-network` (a TSV edge list)
    within its degree bounds, or None to keep every gene."""
    names = {str(g): i for i, g in enumerate(vec.row_names())}
    deg = np.zeros(vec.num_rows, np.int64)
    with open(args.feature_network) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            a, b = names.get(parts[0]), names.get(parts[1])
            if a is not None and b is not None and a != b:
                deg[a] += 1
                deg[b] += 1
    in_net = deg > 0
    if args.feature_network_min_degree > 0:
        in_net &= deg >= args.feature_network_min_degree
    if args.feature_network_max_degree > 0:
        in_net &= deg <= args.feature_network_max_degree
    log.info("feature network: %d/%d genes kept", int(in_net.sum()), vec.num_rows)
    return None if args.no_feature_network_restrict else in_net.astype(np.float32)


def _prior_rho(path: str, vec) -> tuple[np.ndarray, np.ndarray, int]:
    """(rho init [D + 1, H]: N(0, 0.1^2) from numpy seed 0 with the
    matched genes' rows from `path`, the matched rows, H)."""
    from ...data.knowledge import load_frozen_features

    ff = load_frozen_features(path, vec.row_names())
    rho = 0.1 * np.random.default_rng(0).standard_normal((vec.num_rows + 1, ff.h)).astype(np.float32)
    rho[ff.keep_target_indices] = ff.e_feat
    return rho, ff.keep_target_indices, ff.h


def run_masked(args, *, vec=None) -> dict:
    """One masked command from its parsed arguments; `vec` overrides
    `--data-files` (with `--batch-files`, their labels are registered on it)."""
    from ...parallel.mesh import live, make_mesh
    from ...parallel.multihost import barrier

    device = torch.device(args.device)
    mesh = make_mesh(device) if args.data_parallel else None
    shared = live(mesh)
    timings: dict[str, float] = {}
    t_all = time.time()
    latent = LATENTS.get(args.cmd, getattr(args, "latent", "simplex"))
    if vec is None:
        vec = load_data_vec(args.data_files, args.batch_files)
    elif args.batch_files:
        vec.register_batches(read_batch_labels(args.batch_files))
    null_plane = null_membership = None
    if args.batch_files:
        null_plane, null_membership = null_stream(vec, args, device, timings)
    gene_weights = network_gene_weights(vec, args) if args.feature_network else None
    t0 = time.time()
    data = build_topk_windows(vec, args.window, gene_weights=gene_weights, device=device)
    timings["windows_s"] = time.time() - t0
    embed_dim = args.embed_dim
    frozen_init = frozen_mask = init_rho = None
    if args.frozen_features:
        frozen_init, keep, embed_dim = _prior_rho(args.frozen_features, vec)
        frozen_mask = np.zeros(vec.num_rows + 1, np.float32)
        frozen_mask[keep] = 1.0
        log.info("frozen features: %d/%d genes pinned (H=%d)", len(keep), vec.num_rows, embed_dim)
    if args.init_feature_embedding:
        init_rho, _, embed_dim = _prior_rho(args.init_feature_embedding, vec)
    model = MaskedTopicModel(
        vec.num_rows, args.n_latent_topics, embed_dim=embed_dim, latent=latent,
        kl_weight=args.kl_weight, masked_likelihood=args.masked_likelihood,
        n_gene_modules=args.gene_modules, with_null=null_plane is not None,
        generator=prng.generator_from_key(masked_keys(args.seed)[0]),
    )
    cfg = MaskedTrainConfig(
        epochs=args.epochs, minibatch=args.minibatch_size, learning_rate=args.learning_rate,
        mask_frac=args.mask_frac, mask_schedule=args.mask_schedule,
        mask_rate_lo=args.mask_rate_lo, mask_rate_hi=args.mask_rate_hi,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        feature_embedding_l2=args.feature_embedding_l2, eval_mask_frac=args.eval_mask_fraction,
        eval_seed=args.eval_seed, seed=args.seed, frozen_rho_init=frozen_init,
        frozen_rho_mask=frozen_mask, init_rho=init_rho, null_plane=null_plane,
        null_membership=null_membership, mesh=mesh,
    )
    t0 = time.time()
    model, trace, eval_loss = train_masked(model, data, cfg, device=device)
    timings["train_s"] = time.time() - t0
    result = {"model": model, "data": data, "trace": trace, "eval_loss": eval_loss,
              "null_plane": null_plane, "null_membership": null_membership, "timings": timings}
    if shared is not None and not shared.primary:  # rank 0 encodes and writes
        barrier(shared)
        return result
    if eval_loss is not None:
        with open(f"{args.out}.eval.json", "w") as f:
            json.dump({"eval_mask_fraction": args.eval_mask_fraction, "eval_seed": args.eval_seed,
                       "masked_eval_loss": eval_loss}, f, indent=2)
        log.info("held-out masked eval loss: %.4f", eval_loss)
    t0 = time.time()
    raw = latent == "gaussian"
    z = encode_all(model, data, raw_latent=raw, null_plane=null_plane,
                   null_membership=null_membership, device=device)
    timings["encode_s"] = time.time() - t0
    outputs = {
        "latent": write_table(f"{args.out}.latent", matrix_columns(
            z, "z" if raw else "topic", "cell", vec.column_names())),
        "model": f"{args.out}.model.npz",
    }
    write_table(f"{args.out}.loss", {"epoch": np.arange(len(trace)), "loss": np.asarray(trace)})
    save_model(args.out, masked_params_to_jax(model.state_dict()), args, vec.num_rows,
               vec.row_names(), model_type=args.cmd,
               extra_meta={"window": args.window, "embed_dim": embed_dim, "latent": latent,
                           "gene_modules": args.gene_modules})
    timings["total_s"] = time.time() - t_all
    RunManifest(command=args.cmd, inputs={"data_files": list(args.data_files)}, outputs=outputs,
                timings=timings, engine="legume-tpu-torch").save(args.out)
    barrier(shared)
    return {**result, "latent": z}
