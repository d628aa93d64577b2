"""Batched elliptical slice sampling and chain diagnostics (the port of
the JAX package's `ops/mcmc.py`).

B independent chains step in lockstep: each owns its ellipse angle and
bracket, and a chain that has accepted is frozen while the rest shrink.
The likelihood is one batched call per shrink iteration. The draws are
the JAX package's threefry streams (`utils/prng.py`), split as it splits
them; the keys are split on the host and the values drawn on the device.

The shrink loop runs until every chain has accepted or the bracket cap
(`MAX_BRACKET_ITERS`) is reached. A chain that has accepted is frozen,
so each iteration gathers the chains still running and evaluates the
likelihood on those alone: after the first few iterations that is a
small share of the batch. The proposal and the next angle are each a
multiply-add that XLA's CPU backend fuses, so they are formed in
float64 and rounded once, as a fused multiply-add rounds.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import prng

MAX_BRACKET_ITERS = 64
BRACKET_MIN_WIDTH = 1e-6
_DRAW_BLOCK = 16  # shrink iterations whose uniform draws are made at once
_TWO_PI = float(np.float32(2.0 * np.pi))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float64, rounded once to float32 (a fused multiply-add)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def elliptical_slice_step_batched(
    key: np.ndarray,
    current: torch.Tensor,  # [B, D] current states
    prior_sample: torch.Tensor,  # [B, D] nu ~ N(0, Sigma) draws
    lnpdf: Callable[[torch.Tensor, torch.Tensor | None], torch.Tensor],
    cur_lnpdf: torch.Tensor,  # [B]
    *,
    stats: dict | None = None,
    span: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ESS transition for B independent chains (Murray et al. 2010).
    `lnpdf(states [n, D], idx [n])` is the log density of chains `idx` at
    `states` (`idx` None: all B). A chain whose bracket collapses keeps
    its current state. Each shrink iteration evaluates only the chains
    still running, so its cost follows the number left.

    `span = (lb, ub, total)`: the B chains are chains `[lb, ub)` of a
    batch of `total` sharded over ranks; every draw is made for all
    `total` and this rank keeps its slice, so a chain's draws are those
    of the whole batch. The loop ends when this rank's chains are done:
    a chain's path does not depend on how long the others run."""
    dev = current.device
    b = current.shape[0]
    lb, ub, b_draw = (0, b, b) if span is None else span
    k_u, k_phi, k_loop = prng.split(key, 3)
    u_h, u_phi = prng.uniform_keys(np.stack([k_u, k_phi]), b_draw, dev)[:, lb:ub]
    hh = torch.log(u_h) + cur_lnpdf
    phi = torch.clamp_min(u_phi * _TWO_PI, 0.0)  # uniform on [0, 2 pi), as drawn
    out, out_ln = current.clone(), cur_lnpdf.clone()
    # the running chains, compacted: their ids, states, draws and the
    # rows (angle, bracket low, bracket high, level) of `sc`
    idx = torch.arange(b, device=dev)
    cur, nu = current, prior_sample
    sc = torch.stack([phi, phi - _TWO_PI, phi, hh])
    it = 0
    while it < MAX_BRACKET_ITERS and idx.numel():
        if it % _DRAW_BLOCK == 0:  # the next block of the loop's uniform draws
            keys = []
            for _ in range(min(_DRAW_BLOCK, MAX_BRACKET_ITERS - it)):
                k_loop, k_next = prng.split(k_loop)
                keys.append(k_next)
            u_all = prng.uniform_keys(np.stack(keys), b_draw, dev)[:, lb:ub]
        ang, lo, hi, h = sc
        proposal = _fma(cur, torch.cos(ang)[:, None], nu * torch.sin(ang)[:, None])
        new_ln = lnpdf(proposal, idx)
        acc = new_ln > h
        out[idx] = torch.where(acc[:, None], proposal, out[idx])
        out_ln[idx] = torch.where(acc, new_ln, out_ln[idx])
        neg = ang < 0.0
        lo = torch.where(~acc & neg, ang, lo)
        hi = torch.where(~acc & ~neg, ang, hi)
        keep = torch.nonzero(~acc & ((hi - lo) >= BRACKET_MIN_WIDTH))[:, 0]
        ang = _fma(u_all[it % _DRAW_BLOCK][idx], hi - lo, lo)
        sc = torch.stack([ang, lo, hi, h])[:, keep]
        idx, cur, nu = idx[keep], cur[keep], nu[keep]
        it += 1
    if stats is not None:
        stats["ess_steps"] = stats.get("ess_steps", 0) + 1
        stats["ess_iters"] = stats.get("ess_iters", 0) + it
    return out, out_ln


def run_ess_chains(
    key: np.ndarray,
    init: torch.Tensor,  # [B, D]
    prior_draw: Callable[[np.ndarray, tuple], torch.Tensor],  # key, shape -> [B, D]
    lnpdf: Callable[[torch.Tensor, torch.Tensor | None], torch.Tensor],
    *,
    num_samples: int,
    burn_in: int = 0,
    thin: int = 1,
    span: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(samples [num_samples, B, D], lnpdfs [num_samples, B]) after
    burn-in and thinning. `lnpdf` and `span` as
    `elliptical_slice_step_batched` takes them; `prior_draw` gives this
    rank's rows."""
    total = burn_in + num_samples * thin
    cur, cur_ln = init, lnpdf(init, None)
    all_s, all_ln = [], []
    for k in prng.split(key, total):
        k1, k2 = prng.split(k)
        nu = prior_draw(k1, tuple(cur.shape))
        cur, cur_ln = elliptical_slice_step_batched(k2, cur, nu, lnpdf, cur_ln, span=span)
        all_s.append(cur)
        all_ln.append(cur_ln)
    sel = [burn_in + thin * i + (thin - 1) for i in range(num_samples)]
    return torch.stack([all_s[i] for i in sel]), torch.stack([all_ln[i] for i in sel])


# ---- diagnostics (numpy) ----------------------------------------------------


def ess(x: np.ndarray) -> float:
    """Effective sample size by Geyer's initial monotone positive
    sequence of autocorrelation pair sums."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = (x * x).mean()
    if var <= 0:
        return float(n)
    acf = np.correlate(x, x, mode="full")[n - 1 :] / (var * n)
    pair = acf[1:-1:2] + acf[2::2]
    s = 0.0
    prev = np.inf
    for p in pair:
        if p < 0:
            break
        p = min(p, prev)
        prev = p
        s += p
    return float(n / (1.0 + 2.0 * s))


def split_rhat(x: np.ndarray) -> float:
    """Split-R-hat of one chain: halves, between/within variance ratio."""
    x = np.asarray(x, np.float64)
    n = len(x) // 2
    if n < 2:
        return 1.0
    halves = np.stack([x[:n], x[n : 2 * n]])
    w = halves.var(axis=1, ddof=1).mean()
    b = n * halves.mean(axis=1).var(ddof=1)
    if w <= 0:
        return 1.0
    return float(np.sqrt((w * (n - 1) / n + b / n) / w))


def mcse_proportion(p: float, ess_val: float) -> float:
    """Monte-Carlo standard error of a proportion estimate."""
    return float(np.sqrt(max(p * (1.0 - p), 0.0) / max(ess_val, 1.0)))
