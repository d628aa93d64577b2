"""`senna vae`: a Gaussian-latent VAE on the multilevel pseudobulk ladder
(the port of the JAX package's `senna/vae.py`).

It takes `senna topic`'s load, projection (K1), sort and collapse (K3);
the latent is a free Gaussian (no simplex map) and each level's decoder
a linear gene-axis softmax with NB noise, so the dictionary read is a
factor-loading matrix. Outputs: `{out}.latent` (columns `z{k}`),
`{out}.loadings`, `{out}.log_likelihood`, `{out}.model.{npz,json}` (model
type `vae`) and `{out}.senna.json`. Runs on the card unless the caller
passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.convert import params_from_jax
from ..models.decoders import GaussianNbDecoder
from ..models.encoders import GaussianEncoder
from ..models.train import MixedTrainer, TrainConfig
from ..utils import prng
from ..utils.manifest import RunManifest, manifest_path
from ..utils.output import matrix_columns, write_table
from ..utils.prng import DEFAULT_PROJECTION_SEED
from .topic import (
    TopicArgs,
    evaluate_latent_by_encoder,
    load_and_collapse,
    load_data_vec,
    load_model,
    sample_collapsed_data,
    save_model,
    trainer_params,
)

log = logging.getLogger(__name__)


@dataclass
class VaeArgs:
    """The JAX package's `VaeArgs`, same names and defaults."""

    data_files: Sequence[str] = ()
    out: str = "vae"
    batch_files: Optional[Sequence[str]] = None
    n_latent: int = 16
    encoder_layers: Sequence[int] = (128, 64)
    epochs: int = 500
    minibatch_size: int = 100
    learning_rate: float = 0.01
    grad_clip: float = 1.0
    proj_dim: int = 50
    sort_dim: int = 10
    num_levels: int = 2
    iter_opt: int = 30
    ignore_batch: bool = False
    block_size: int = 8192
    from_run: Optional[str] = None
    init_from: Optional[str] = None
    adj_method: str = "residual"
    qc: bool = False
    qc_min_total: float = 0.0
    qc_min_genes: int = 0
    qc_max_mito_frac: float = 1.0
    hvg_genes: int = 5000
    seed: int = DEFAULT_PROJECTION_SEED
    data_parallel: bool = False


def _warm_state(args: VaeArgs, d: int):
    """`--init-from`: the saved model's weights after the architecture check."""
    meta, flat, _ = load_model(args.init_from)
    if meta.get("n_topics") != args.n_latent or meta.get("n_features") != d:
        raise ValueError(
            f"vae init-from architecture mismatch: {meta} vs H={args.n_latent}, D={d}"
        )
    return params_from_jax({n: v for n, v in flat.items() if n.startswith("params/")})


def fit_vae(args: VaeArgs, *, vec=None, device="cuda") -> dict:
    """End-to-end `senna vae`; `vec` overrides `args.data_files`."""
    if args.data_parallel:
        raise NotImplementedError("senna vae port does not support --data-parallel yet")
    device = torch.device(device)
    timings: dict[str, float] = {}
    t_all = time.time()
    if args.from_run:
        prev = RunManifest.load(manifest_path(args.from_run))
        args = dataclasses.replace(
            args,
            data_files=list(args.data_files or prev.inputs.get("data_files", [])),
            batch_files=(args.batch_files if args.batch_files is not None
                         else prev.inputs.get("batch_files") or None),
        )
    if vec is None:
        vec = load_data_vec(args.data_files, args.batch_files)
    d = vec.num_rows
    warm = _warm_state(args, d) if args.init_from else None
    if args.qc:
        from ..data.qc import compute_cell_qc

        t0 = time.time()
        stats = compute_cell_qc(vec, block_size=args.block_size, device=device)
        keep = stats.keep_mask(min_total=args.qc_min_total, min_genes=args.qc_min_genes,
                               max_mito_frac=args.qc_max_mito_frac)
        log.info("vae qc: keeping %d/%d cells", int(keep.sum()), vec.num_columns)
        vec = vec.subset_columns(keep)
        timings["qc_s"] = time.time() - t0
    topic_args = TopicArgs(
        data_files=args.data_files, proj_dim=args.proj_dim, sort_dim=args.sort_dim,
        num_levels=args.num_levels, iter_opt=args.iter_opt, ignore_batch=args.ignore_batch,
        block_size=args.block_size, hvg_genes=args.hvg_genes, seed=args.seed,
    )
    levels = load_and_collapse(vec, topic_args, timings=timings, device=device)
    keys = prng.split(prng.key(args.seed & 0x7FFFFFFF), 1 + len(levels.collapsed))
    t0 = time.time()
    level_data = [sample_collapsed_data(out, k, device)
                  for out, k in zip(levels.collapsed, keys[1:])]
    timings["sample_s"] = time.time() - t0

    k_init, k_train = prng.split(keys[0])
    init_gen = prng.generator_from_key(k_init)
    encoder = GaussianEncoder(d, args.n_latent, tuple(args.encoder_layers), generator=init_gen)
    decoders = [GaussianNbDecoder(d, args.n_latent, generator=init_gen) for _ in level_data]
    trainer = MixedTrainer(
        encoder, decoders,
        TrainConfig(epochs=args.epochs, minibatch_size=args.minibatch_size,
                    learning_rate=args.learning_rate, grad_clip=args.grad_clip,
                    topic_smoothing=0.0),  # a Gaussian latent: no simplex smoothing
        device=device,
    )
    if warm is not None:
        trainer.warm_start(*warm)
        log.info("vae warm start from %s", args.init_from)
    t0 = time.time()
    scores = trainer.train(level_data, prng.generator_from_key(k_train, device))
    timings["train_s"] = time.time() - t0

    t0 = time.time()
    z = evaluate_latent_by_encoder(
        vec, trainer.encoder, levels.collapsed[0], levels.groups_per_level[0],
        block_size=args.minibatch_size * 8, adj_method=args.adj_method, device=device,
    )
    timings["cell_eval_s"] = time.time() - t0

    t0 = time.time()
    gene_names = np.asarray(vec.row_names())
    with torch.no_grad():
        loadings = trainer.decoders[0].get_dictionary().cpu().numpy()
    outputs = {
        "latent": write_table(f"{args.out}.latent",
                              matrix_columns(z, "z", "cell", vec.column_names())),
        "loadings": write_table(f"{args.out}.loadings",
                                matrix_columns(loadings, "z", "gene", gene_names)),
        "log_likelihood": write_table(f"{args.out}.log_likelihood", {
            "epoch": np.arange(len(scores.llik)), "llik": np.asarray(scores.llik),
            "kl": np.asarray(scores.kl)}),
    }
    save_model(args.out, trainer_params(trainer), args, d, gene_names, model_type="vae")
    timings["outputs_s"] = time.time() - t0
    timings["total_s"] = time.time() - t_all
    RunManifest(
        command="vae", inputs={"data_files": list(args.data_files)}, outputs=outputs,
        params=dataclasses.asdict(args), timings=timings, engine="legume-tpu-torch",
    ).save(args.out)
    log.info("vae: wrote %s", outputs["latent"])
    return {"latent": z, "loadings": loadings, "scores": scores, "trainer": trainer,
            "levels": levels, "level_data": level_data, "timings": timings}
