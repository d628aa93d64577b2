"""`senna joint-topic`: a topic model over several modalities of the same
cells (the port of the JAX package's `senna/joint.py`).

The pseudobulk groups come from the first modality's projection (K1) and
binary sort; each modality is collapsed (K3) on those shared groups and
posterior-sampled. One joint encoder (a trunk per modality, latents
summed) sees the concatenated profile; each modality's decoder scores
its slice (nb, multinomial or poisson), or one delta decoder scores
modalities on the same feature axis. Runs on the card unless the caller
passes `device="cpu"`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models.decoders import DECODERS, DeltaTopicDecoder
from ..models.encoders import LogSoftmaxJointEncoder
from ..models.train import LevelData, MixedTrainer, TrainConfig
from ..ops import collapse as clp
from ..ops import random_projection as rp
from ..utils import prng
from ..utils.prng import DEFAULT_PROJECTION_SEED

log = logging.getLogger(__name__)


@dataclass
class JointTopicArgs:
    """The JAX package's `JointTopicArgs`, same names and defaults."""

    n_topics: int = 10
    encoder_layers: Sequence[int] = (128, 128)
    epochs: int = 300
    minibatch_size: int = 100
    learning_rate: float = 0.01
    decoder: str = "nb"
    decoder_weights: Sequence[float] | None = None
    proj_dim: int = 50
    sort_dim: int = 8
    iter_opt: int = 30
    seed: int = DEFAULT_PROJECTION_SEED


def fit_joint_topic(modalities: Sequence, args: JointTopicArgs, *, device="cuda") -> dict:
    """`modalities`: backends or vecs with the same cells (columns)."""
    device = torch.device(device)
    timings: dict[str, float] = {}
    n = modalities[0].num_columns
    if any(m.num_columns != n for m in modalities[1:]):
        raise ValueError("joint-topic modalities must share cells")

    t0 = time.time()
    _, proj = rp.project_columns(modalities[0], args.proj_dim, seed=args.seed, device=device)
    codes = rp.binary_sort_columns(proj, args.sort_dim, seed=args.seed, device=device)
    groups, s = rp.compact_group_codes(codes)
    timings["projection_sort_s"] = time.time() - t0

    t0 = time.time()
    key = prng.key(args.seed & 0x7FFFFFFF)
    inputs, dims = [], []
    for m in modalities:
        out = clp.optimize(clp.collect_basic_stats(m, groups, s, device=device),
                           num_iter=args.iter_opt, device=device)
        key, k_s = prng.split(key)
        inputs.append(out.mu_observed.sample(prng.generator_from_key(k_s, device)).T.cpu().numpy())
        dims.append(m.num_rows)
    concat = np.concatenate(inputs, axis=1).astype(np.float32)
    bounds = np.cumsum([0, *dims])
    slices = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    timings["collapse_s"] = time.time() - t0

    k_init, k_train = prng.split(key)
    gen = prng.generator_from_key(k_init)
    enc = LogSoftmaxJointEncoder(dims, args.n_topics, tuple(args.encoder_layers), generator=gen)
    if args.decoder == "delta":
        if len(set(dims)) != 1:
            raise ValueError("delta decoder needs every modality on the SAME feature axis; "
                             f"got dims {dims}")
        decoders = [DeltaTopicDecoder(dims[0], args.n_topics, len(dims), generator=gen)]
    else:
        decoders = [[DECODERS[args.decoder](d, args.n_topics, generator=gen) for d in dims]]
    trainer = MixedTrainer(
        enc, decoders,
        TrainConfig(epochs=args.epochs, minibatch_size=args.minibatch_size,
                    learning_rate=args.learning_rate),
        decoder_weights=list(args.decoder_weights) if args.decoder_weights else None,
        target_slices=None if args.decoder == "delta" else slices,
        device=device,
    )
    t0 = time.time()
    scores = trainer.train([LevelData(input=concat, input_null=None)],
                           prng.generator_from_key(k_train, device))
    timings["train_s"] = time.time() - t0
    pb_log_z = trainer.encode(concat)
    return {"trainer": trainer, "scores": scores, "pb_latent": np.exp(pb_log_z),
            "groups": groups, "slices": slices, "input": concat, "timings": timings}
