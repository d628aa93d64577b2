"""Multilevel topic-VAE trainer (the port of `MixedTrainer` from the JAX
package's `models/train.py`).

`decoders[level]` is one decoder, or a list of decoder families scored
on the same `log z`, whose lliks sum with `decoder_weights` (default
equal); with `target_slices` decoder j of a level scores columns
`[start_j, end_j)` of the target (one modality each, `joint-topic`),
else every family scores the whole target. The anchor penalty acts on
every softmax dictionary of a level. The encoder may be the topic
encoder, the Gaussian-latent one (`senna vae`, with `topic_smoothing`
0) or the joint one, which takes one noise draw per modality.

A shared encoder and one decoder per pseudobulk level train with AdamW
(weight decay 0.01) under a global-norm gradient clip that skips the
step (zero gradients) when the norm is not finite. One optimizer spans
every parameter, as the JAX package's single optax state does, so a
level's step still moves the other levels' decoders by their momentum
and weight decay. Each level's rows pad to a whole number of minibatches
with a 0/1 row weight; padded rows add nothing to the loss or the
traces. When a level has no separate target, the minibatch's input is
also its target.

Random streams (init, minibatch order, reparameterisation noise) come
from explicit torch generators; they cannot match the JAX package's
draws, so training is held to the JAX trainer by its ELBO band.

Under a data-parallel `mesh` (`parallel/mesh.py`, one rank a GPU) every
rank holds every level's rows, draws the same global permutation and the
same noise, and takes its share (`data_sharding`) of the rows of each
minibatch; the loss keeps the whole minibatch's normaliser, the anchor
penalty counts on rank 0 only, the encoder's batch statistics (its input
clip scale, BatchNorm) are the whole minibatch's, and the gradients are
summed across ranks before the clip, so every rank takes the same clip,
skip and AdamW step from rank 0's parameters. The rows need no padding
to the world (the JAX package's `row_multiple`): a minibatch that does
not divide by it gives uneven shares. A world of one runs the plain
trainer's operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import Mesh, data_sharding, replicate, sum_grads_
from ..utils.stop import stop_requested
from .encoders import FlaxBatchNorm, GaussianTrunk
from .losses import smooth_topics


@dataclass
class TrainConfig:
    epochs: int = 100
    minibatch_size: int = 256
    learning_rate: float = 1e-3
    topic_smoothing: float = 0.01
    grad_clip: float = 10.0
    weight_decay: float = 0.01
    # epochs of one level run back to back before the next level's turn
    epochs_per_call: int = 10


@dataclass
class TrainScores:
    llik: list = field(default_factory=list)
    kl: list = field(default_factory=list)


@dataclass
class LevelData:
    """Per-level `(encoder input, optional batch null, decoder target)`,
    numpy arrays of [P, D]."""

    input: np.ndarray
    input_null: Optional[np.ndarray]
    output: Optional[np.ndarray] = None

    @property
    def target(self) -> np.ndarray:
        return self.output if self.output is not None else self.input

    @property
    def n(self) -> int:
        return self.input.shape[0]


def clip_grads_nonfinite_(params, max_norm: float) -> None:
    """Global L2 clip of the gradients in place; a non-finite norm zeroes
    every gradient (the step is skipped). A parameter without a gradient
    (another level's decoder) gets a zero one."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    finite = torch.isfinite(norm)
    scale = torch.where(finite, torch.clamp(max_norm / (norm + 1e-6), max=1.0), 0.0)
    for g in grads:
        g.copy_(torch.where(finite, g * scale, torch.zeros_like(g)))


def _pad_level(level: LevelData, mb: int, device):
    """(input, null, target or None, row weight) padded to whole minibatches."""
    p = level.n
    p_pad = max(1, -(-p // mb)) * mb

    def pad_rows(a):
        if a is None:
            return None
        out = torch.zeros(p_pad, a.shape[1], dtype=torch.float32, device=device)
        out[:p] = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return out

    w = torch.zeros(p_pad, dtype=torch.float32, device=device)
    w[:p] = 1.0
    y = None if level.output is None else pad_rows(level.output)
    return pad_rows(level.input), pad_rows(level.input_null), y, w


class MixedTrainer:
    """Shared encoder + one decoder per level."""

    def __init__(
        self,
        encoder: torch.nn.Module,
        decoders: Sequence[torch.nn.Module],
        config: TrainConfig,
        *,
        feature_weights: Sequence[Optional[np.ndarray]] | None = None,
        anchor_weights: Sequence[np.ndarray] | None = None,  # per level [K, D]
        anchor_penalty: float = 0.0,
        decoder_weights: Sequence[float] | None = None,
        target_slices: Sequence[tuple[int, int]] | None = None,
        mesh: Mesh | None = None,
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = torch.device(device)
        self.encoder = encoder.to(self.device)
        self.decoders = torch.nn.ModuleList(
            torch.nn.ModuleList(d) if isinstance(d, (list, tuple)) else d for d in decoders
        ).to(self.device)
        self.decoder_weights = list(decoder_weights) if decoder_weights else None
        self.target_slices = list(target_slices) if target_slices else None
        self.config = config
        fws = feature_weights if feature_weights is not None else [None] * len(decoders)
        self.feature_weights = [
            None if fw is None else torch.as_tensor(np.asarray(fw, np.float32), device=self.device)[None, :]
            for fw in fws
        ]
        self.anchor_weights = (
            None if anchor_weights is None
            else [torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in anchor_weights]
        )
        self.anchor_penalty = anchor_penalty
        self.params = list(self.encoder.parameters()) + list(self.decoders.parameters())
        self.optimizer = torch.optim.AdamW(
            self.params, lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay,
        )
        if self.mesh is not None:
            for m in self.encoder.modules():
                if isinstance(m, (FlaxBatchNorm, GaussianTrunk)):
                    m.mesh = self.mesh  # their batch statistics span the ranks
            self._replicate()

    def _replicate(self):
        """Rank 0's parameters and BatchNorm statistics on every rank."""
        if self.mesh is None:
            return
        with torch.no_grad():
            for t in [*self.params, *self.encoder.buffers(), *self.decoders.buffers()]:
                replicate(self.mesh, t)

    def minibatch_loss(self, level: int, xb, nb, yb, wb, eps, *, w_total=None, anchor=True):
        """(loss, sum llik, sum kl, sum counts) over the real rows. A rank's
        share of a minibatch passes the whole minibatch's weight sum as
        `w_total`, and `anchor=False` on all ranks but one."""
        log_z, kl = self.encoder(xb, nb, train=True, eps=eps)
        log_z = smooth_topics(log_z, self.config.topic_smoothing)
        decs = self.level_decoders(level)
        fw = self.feature_weights[level]
        if isinstance(self.decoders[level], torch.nn.ModuleList):
            weights = self.decoder_weights or [1.0] * len(decs)
            sl = self.target_slices or [(0, yb.shape[1])] * len(decs)
            llik = sum(dw * dec(log_z, yb[:, a:b], fw)[1]
                       for dec, dw, (a, b) in zip(decs, weights, sl))
        else:
            llik = decs[0](log_z, yb, fw)[1]
        norm = wb.sum() if w_total is None else w_total
        loss = torch.sum((kl - llik) * wb) / torch.clamp(norm, min=1.0)
        if anchor and self.anchor_weights is not None and self.anchor_penalty > 0:
            for dec in (d for d in decs if hasattr(d, "log_beta_kd")):
                ce = -torch.mean(torch.sum(self.anchor_weights[level] * dec.log_beta_kd(), dim=-1))
                loss = loss + self.anchor_penalty * ce
        return loss, (llik * wb).sum(), (kl * wb).sum(), (yb.sum(-1) * wb).sum()

    def level_decoders(self, level: int) -> list[torch.nn.Module]:
        """The decoder families of one level, as a list."""
        dec = self.decoders[level]
        return list(dec) if isinstance(dec, torch.nn.ModuleList) else [dec]

    def _sum_grads(self):
        """The gradients summed across ranks (one flat all_reduce)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sum_grads_(self.mesh, [p.grad for p in self.params])

    def _clip_and_step(self):
        """Global-norm clip with the non-finite skip, then AdamW."""
        if self.mesh is not None:
            self._sum_grads()
        clip_grads_nonfinite_(self.params, self.config.grad_clip)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=False)

    def _epoch(self, level: int, x, null, y, w, gen: torch.Generator):
        mb = self.config.minibatch_size
        p_pad = x.shape[0]
        perm = torch.randperm(p_pad, generator=gen, device=self.device)
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        k = self.encoder.n_topics
        draws = getattr(self.encoder, "n_draws", None)
        eps_shape = (mb, k) if draws is None else (draws, mb, k)
        a, b = (0, mb) if self.mesh is None else data_sharding(self.mesh, mb)
        for lb in range(0, p_pad, mb):
            batch = perm[lb : lb + mb]
            idx = batch[a:b]
            xb = x[idx]
            nb = None if null is None else null[idx]
            yb = xb if y is None else y[idx]
            eps = torch.randn(*eps_shape, generator=gen, device=self.device)[..., a:b, :]
            w_total = None if self.mesh is None else w[batch].sum()
            loss, llik, kl, cnt = self.minibatch_loss(
                level, xb, nb, yb, w[idx], eps, w_total=w_total,
                anchor=self.mesh is None or self.mesh.primary)
            loss.backward()
            self._clip_and_step()
            sums += torch.stack([llik.detach(), kl.detach(), cnt.detach()])
        return sums

    def warm_start(self, encoder_state: dict, decoder_states: Sequence) -> None:
        """Overlay the matching parameters of a saved model (the JAX
        trainer's `init_params`): every parameter named in the states
        takes the saved value, a parameter the states lack keeps its
        init, and the BatchNorm running statistics start fresh, as the
        JAX package overlays `params` only. The optimizer state starts
        fresh too. Under a mesh, rank 0's result goes to every rank."""

        def overlay(module, state, where):
            for name, p in module.named_parameters():
                if name not in state:
                    continue
                if tuple(state[name].shape) != tuple(p.shape):
                    raise ValueError(f"warm start: {where}.{name} has shape "
                                     f"{tuple(state[name].shape)}, the model {tuple(p.shape)}")
                p.copy_(state[name].to(p.device))

        with torch.no_grad():
            overlay(self.encoder, encoder_state, "encoder")
            for level, state in enumerate(decoder_states[: len(self.decoders)]):
                states = state if isinstance(state, (list, tuple)) else [state]
                for fam, (dec, st) in enumerate(zip(self.level_decoders(level), states)):
                    overlay(dec, st, f"decoder_{level}/{fam}")
        self.optimizer.state.clear()
        self._replicate()

    def train(
        self, level_data: Sequence[LevelData], gen: torch.Generator,
        *, init_dictionaries: Sequence[np.ndarray] | None = None,
    ) -> TrainScores:
        """Train all levels; `init_dictionaries[i]` overwrites the [K, D_i]
        logits of level i's decoder first (a single family per level).
        `gen` lives on the training device."""
        cfg = self.config
        if init_dictionaries is not None:
            with torch.no_grad():
                for dec, logits in zip(self.decoders, init_dictionaries):
                    dec.dictionary.copy_(torch.as_tensor(logits, device=self.device))
            self._replicate()
        padded = [_pad_level(lvl, cfg.minibatch_size, self.device) for lvl in level_data]
        n_tot = sum(lvl.n for lvl in level_data)
        scores = TrainScores()
        self.encoder.train()
        done = 0
        while done < cfg.epochs:
            if self._stop():
                # graceful SIGINT: stop at an epoch-chunk boundary, as the
                # JAX trainer does, and let the caller write partial outputs
                break
            chunk = min(cfg.epochs_per_call, cfg.epochs - done)
            sums = torch.zeros(chunk, 3, dtype=torch.float32, device=self.device)
            for level, (x, null, y, w) in enumerate(padded):
                for e in range(chunk):
                    sums[e] += self._epoch(level, x, null, y, w, gen)
            if self.mesh is not None:
                torch.distributed.all_reduce(sums, group=self.mesh.group)
            s = sums.cpu().numpy().astype(np.float64)
            scores.llik.extend((s[:, 0] / np.maximum(s[:, 2], 1.0)).tolist())
            scores.kl.extend((s[:, 1] / max(n_tot, 1)).tolist())
            done += chunk
        self.encoder.eval()
        return scores

    def _stop(self) -> bool:
        """A Ctrl-C on any rank stops every rank at the same chunk boundary."""
        stop = stop_requested()
        if self.mesh is None:
            return stop
        flag = torch.tensor([float(stop)], device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.group)
        return bool(flag.item())

    @torch.no_grad()
    def encode(self, x: np.ndarray, null: np.ndarray | None = None) -> np.ndarray:
        """Posterior-mode latent (eval path, no sampling)."""
        t = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        log_z, _ = self.encoder(t(x), t(null), train=False)
        return log_z.cpu().numpy()
