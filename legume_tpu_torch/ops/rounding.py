"""float32 arithmetic that rounds alike on the card and on the CPU.

The layouts' descents are chaotic: a difference of one unit in the last
place grows about tenfold every few steps, so a layout drawn on the card
and one drawn on the CPU agree only where every operation rounds alike.
Additions, products, quotients and square roots round correctly on both
devices; a library's reductions, matrix products and transcendental
functions do not (each picks its own order or polynomial). The helpers
below build those from correctly rounded operations in a fixed order:

- `fma` rounds `x * y + z` once, through float64, where the product of
  two float32 values is exact (XLA's CPU backend contracts many of the
  reference's `x * y + z` into fused multiply-adds);
- `sq_dists` forms pairwise squared distances as XLA's CPU backend does,
  its dot a fused multiply-add per coordinate in order;
- `tree_sum` sums by halving, the same tree on every device, and
  `seq_sum` sums a short axis in order;
- `scatter_add` adds rows at repeated indices in the order given, as
  XLA's CPU scatter does (a card's `index_put_` and `index_add_` order
  repeated indices their own way), by a `scatter_plan` formed for many
  scatters at once;
- `scale` multiplies by the float32 reciprocal of a constant, as XLA
  rewrites a division by a constant (and as PyTorch divides a CUDA tensor
  by a Python number, where on the CPU it divides);
- `exp` evaluates a fixed float64 polynomial and rounds it;
- `pow` and `log` round the float64 library value, which is the
  correctly rounded float32 value but at ties of float64 rounding;
  `sqrt` rounds the float64 root, which is the float32 root exactly (a
  card's float32 `sqrt` may round otherwise).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def fma(x, y, z):
    """float32 `x * y + z` rounded once; `x` may be a float32-valued Python float."""
    xd = x if isinstance(x, float) else x.double()
    return (xd * y.double() + z).float()


def pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 `x ** e` for a float32-valued exponent `e`."""
    if e == 0.0:
        return torch.ones_like(x)
    if e == 1.0:
        return x
    return (x.double() ** e).float()


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


_LN2_HI = 6.93147180369123816490e-01  # fdlibm's split of ln 2: k * hi is exact
_LN2_LO = 1.90821492927058770002e-10
_EXP_TERMS = [1.0 / math.factorial(i) for i in range(11)]


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 `exp(x)`: `2^k * p(r)` with `r = x - k ln 2`, `|r| <= ln 2 / 2`,
    and `p` the degree-10 Taylor polynomial (relative error below 1e-12),
    in float64. Below -150 the float32 result is 0 and above 89 it is inf;
    the clamp keeps `2^k` a normal float64."""
    z = torch.clamp(x.double(), -150.0, 89.0)
    k = torch.round(z * (1.0 / math.log(2.0)))
    r = (z - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, _EXP_TERMS[-1])
    for c in reversed(_EXP_TERMS[:-1]):
        p = p * r + c
    two_k = ((k.long() + 1023) << 52).view(torch.float64)
    return (p * two_k).float()


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` by halving: element i meets element i + n/2 (zero-padded
    to a power of two), the same tree on every device."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = F.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a short `dim` in order: `((x0 + x1) + x2) + ...`."""
    x = x.movedim(dim, -1)
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def softmax(z: torch.Tensor, dim: int) -> torch.Tensor:
    """`exp(z - max) / sum(exp(z - max))` along `dim`, the sum a `tree_sum`."""
    e = exp(z - z.amax(dim, keepdim=True))
    return e / tree_sum(e, dim).unsqueeze(dim)


def scale(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """`x / divisor` as `x * float32(1 / divisor)`."""
    return x * float(np.float32(1.0) / np.float32(divisor))


def scatter_plan(idx: torch.Tensor, n_rows: int):
    """For each row of `idx` `[S, B]` (S scatters of B updates): the round
    of each update (its rank among equal indices, in order), its slot (the
    rank of its index among the row's distinct indices), each slot's
    target row (`n_rows`, a spare row, for the slots no index takes), and
    the number of rounds of each scatter, on the host."""
    s, b = idx.shape
    srt, order = torch.sort(idx, dim=1, stable=True)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    pos = torch.arange(b, device=idx.device).expand(s, b)
    rank_s = pos - torch.cummax(torch.where(new, pos, 0), 1).values
    slot_s = torch.cumsum(new, 1) - 1
    rank = torch.empty_like(rank_s).scatter_(1, order, rank_s)
    slot = torch.empty_like(slot_s).scatter_(1, order, slot_s)
    target = torch.full_like(srt, n_rows)
    target.scatter_(1, slot_s, srt)  # a slot's updates all carry its index
    return rank, slot, target, (rank.amax(1) + 1).tolist()


def scatter_add(x: torch.Tensor, v: torch.Tensor, rank, slot, target, rounds: int) -> None:
    """`x[idx[j]] += v[j]` for j in order, in place, by one row of a
    `scatter_plan`: the k-th update of each index is added in round k, each
    round over distinct rows. `x` has a spare last row for the free slots."""
    per_round = torch.zeros((rounds,) + v.shape, dtype=v.dtype, device=v.device)
    per_round[rank, slot] = v
    acc = x[target]
    for r in range(rounds):
        acc = acc + per_round[r]
    x[target] = acc


def fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`sum_k a[..., k] * b[..., k]` as a fused multiply-add per k, in order
    (XLA's CPU dot over a short contraction)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc.double())
    return acc


def sq_dists(x: torch.Tensor, *, fused: bool) -> torch.Tensor:
    """`[N, N]` squared distances `(|x_i|^2 + |x_j|^2) - 2 x_i . x_j`, at
    least 0. The products take a fused multiply-add per coordinate in order;
    the norms too where `fused` (XLA's rounding inside a compiled step),
    else they sum the rounded squares in order (XLA's, op by op)."""
    if fused:
        s = fma_dot(x, x)
    else:
        sq = x * x
        s = sq[:, 0]
        for k in range(1, x.shape[1]):
            s = s + sq[:, k]
    d2 = s[:, None] + s[None, :] - 2.0 * fma_dot(x[:, None, :], x[None, :, :])
    return torch.clamp(d2, min=0.0)


def laplacian_product(coef: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`(diag(coef.sum(1)) - coef) @ y` for `y` `[N, 2]`, the matrix formed as
    the reference forms it and every sum a `tree_sum`."""
    m = -coef
    m.diagonal().add_(tree_sum(coef, 1))
    return torch.stack([tree_sum(m * y[:, j], 1) for j in range(y.shape[1])], 1)
