"""Deterministic seeding and a numpy threefry2x32 equal to `jax.random`.

The JAX package draws its projection basis, its rSVD sketch and its
DC-Poisson Gibbs noise from `jax.random` (threefry2x32, partitionable
mode, 32-bit seeds). The sort codes and the refined partitions follow
from those draws bit for bit, so the port reproduces the same streams
here on the host and hands the results to torch. Torch's own generators
serve every stream that no later stage compares exactly (trainer init,
minibatch order, reparameterisation noise, Gamma posterior draws).

What the installed JAX does, and this module copies:

- `jax.random.key(seed)` with x64 off casts the Python int to int32
  (keeping its low 32 bits) and then splits it as a 64-bit value, so the
  key data is `[0, seed & 0xFFFFFFFF]` for every seed, however wide.
- `split` and `random_bits` hash a 64-bit iota of the output shape,
  `(hi, lo)` words as the two counters (`jax_threefry_partitionable`).
  `random_bits` of width 32 returns `bits1 ^ bits2`; `split` stacks
  `(bits1, bits2)` as the new keys.
- `uniform` keeps the top 23 bits as a mantissa of a float in [1, 2),
  subtracts 1, scales to [lo, hi) and clamps at lo.
- `normal` is `sqrt(2) * erfinv(u)` with `u` uniform on
  (nextafter(-1, 0), 1); erfinv is XLA's single-precision polynomial.
- `gumbel` (mode "low") is `-log(-log(u))` with `u` uniform on
  [tiny, 1).
- `randint` draws two words per value from the two halves of
  `split(key)` and folds them into the span in uint32 arithmetic,
  `((hi % span) * m + lo % span) % span` with `m = (2^16 % span)^2 %
  span`, every product wrapping at 2^32 as XLA's uint32 does (so `m`
  is 0 for spans past 2^16).
- `choice(p=...)` with replacement searches `cumsum(p)` for
  `cumsum(p)[-1] * (1 - u)`, leftmost; the float32 cumsum is summed in
  the order of XLA's CPU backend (`cumsum_f32`).
"""

from __future__ import annotations

import numpy as np
import torch

# "PROJPROJ" — the pinned basis seed of the reference engine.
DEFAULT_PROJECTION_SEED: int = 0x50524F4A_50524F4A

_M64 = 0xFFFFFFFFFFFFFFFF


def mix_seed(base: int, salt: int) -> int:
    """Mix a base seed with a salt (splitmix64-style finalizer)."""
    x = (base ^ (salt * 0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def key(seed: int) -> np.ndarray:
    """Threefry key data `[2] uint32` of `jax.random.key(seed)` (x64 off)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def key_from_seed(seed: int, salt: int | None = None) -> np.ndarray:
    """A threefry key from a (possibly 64-bit) seed."""
    if salt is not None:
        seed = mix_seed(seed, salt)
    return key(seed & 0x7FFFFFFFFFFFFFFF)


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(k: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 block hash (20 rounds) of counter pairs."""
    k1, k2 = np.uint32(k[0]), np.uint32(k[1])
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        a = x1.astype(np.uint32) + ks[0]
        b = x2.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _iota_2x32(n: int):
    counts = np.arange(n, dtype=np.uint64)
    return (counts >> np.uint64(32)).astype(np.uint32), counts.astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` as `[num, 2] uint32` key data."""
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(k, hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32-bit `jax.random.bits(key, shape)`."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(int(np.prod(shape, dtype=np.int64)))
    b1, b2 = threefry2x32(k, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 `jax.random.uniform(key, shape, minval=, maxval=)`."""
    bits = random_bits(k, shape)
    fl = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    fl = fl - np.float32(1.0)
    lo = np.float32(minval)
    hi = np.float32(maxval)
    return np.maximum(lo, fl * (hi - lo) + lo)


_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles' polynomial), evaluated in float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        c_lt = np.asarray(_ERFINV_LT5, np.float32)
        c_ge = np.asarray(_ERFINV_GE5, np.float32)
        p = np.where(lt, c_lt[0], c_ge[0])
        for i in range(1, 9):
            p = np.where(lt, c_lt[i], c_ge[i]) + p * w
        out = p * x
    big = np.float32(np.finfo(np.float32).max)
    return np.where(np.abs(x) == np.float32(1.0), x * big, out).astype(np.float32)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """float32 `jax.random.normal(key, shape)`."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def gumbel(k: np.ndarray, shape) -> np.ndarray:
    """float32 `jax.random.gumbel(key, shape)` (mode "low")."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(k, shape, tiny, 1.0)
    return (-np.log(-np.log(u))).astype(np.float32)


def randint(k: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 `jax.random.randint(key, shape, minval, maxval)`."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(int(maxval) - int(minval), 1))
    mult = (1 << 16) % int(span)
    mult = np.uint32(((mult * mult) & 0xFFFFFFFF) % int(span))  # the square wraps too
    with np.errstate(over="ignore"):
        off = ((hi % span) * mult + (lo % span)) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def cumsum_f32(x: np.ndarray, base: int = 16) -> np.ndarray:
    """float32 `jnp.cumsum` as XLA's CPU backend computes it: blocks of
    `base` summed in order, each block offset by the exclusive prefix of
    the block totals, which recurses the same way."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= base:
        return np.cumsum(x, dtype=np.float32)
    m = -(-n // base) * base
    inner = np.cumsum(np.pad(x, (0, m - n)).reshape(-1, base), axis=1, dtype=np.float32)
    ex = np.concatenate([np.zeros(1, np.float32), cumsum_f32(inner[:, -1], base)[:-1]])
    return (inner + ex[:, None]).ravel()[:n]


def choice(k: np.ndarray, p: np.ndarray, shape=()) -> np.ndarray:
    """`jax.random.choice(key, len(p), shape, p=p)` (with replacement):
    indices into `p`."""
    cum = cumsum_f32(p)
    r = cum[-1] * (np.float32(1.0) - uniform(k, shape))
    return np.searchsorted(cum, r, side="left").astype(np.int64)


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: rounds of a stable sort of
    `arange(n)` by fresh 32-bit keys (3 ln n / ln(2^32 - 1) rounds)."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def generator_from_key(k: np.ndarray, device="cpu") -> torch.Generator:
    """A torch generator seeded from threefry key data (for the streams
    that are compared by distribution, not draw for draw)."""
    seed = (int(k[0]) << 32) | int(k[1])
    return torch.Generator(device=device).manual_seed(seed)


# ---- the same streams on a device, one key per row ------------------------
# The functions below take key data `[S, 2]` (int64 tensors holding uint32
# words) and draw `n` values for each of the S keys at once, equal to the
# numpy functions above called key by key. Words live in int64 and are
# masked to 32 bits after every add and shift, so the wrap-around of
# uint32 arithmetic is exact on any device.

_M32 = 0xFFFFFFFF


def _threefry_rows(k: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    k1, k2 = k[:, 0:1], k[:, 1:2]
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def key_rows(keys: np.ndarray, device) -> torch.Tensor:
    """`[S, 2]` uint32 key data as the int64 tensor the `*_rows` functions take."""
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(device)


def split_rows(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`split(key, num)` of each row: `[S, num, 2]`."""
    ctr = torch.arange(num, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = _threefry_rows(keys, torch.zeros_like(ctr), ctr)
    return torch.stack([b1, b2], dim=2)


def bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`random_bits(key, (n,))` of each row: `[S, n]` int64 in [0, 2^32)."""
    if n >= 1 << 32:
        raise ValueError("bits_rows draws fewer than 2^32 values a key")
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = _threefry_rows(keys, torch.zeros_like(ctr), ctr)
    return b1 ^ b2


def uniform_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`uniform(key, (n,))` on [0, 1) of each row: `[S, n]` float32."""
    mant = (bits_rows(keys, n) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def randint_rows(keys: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """`randint(key, (n,), minval, maxval)` of each row: `[S, n]` int64."""
    halves = split_rows(keys)
    hi, lo = bits_rows(halves[:, 0], n), bits_rows(halves[:, 1], n)
    span = max(int(maxval) - int(minval), 1)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return int(minval) + off % span


def choice_rows(keys: torch.Tensor, cum: torch.Tensor, n: int) -> torch.Tensor:
    """`choice(key, p, (n,))` of each row, given `cum = cumsum_f32(p)` as a
    float32 tensor on the keys' device: `[S, n]` int64 indices into `p`."""
    r = cum[-1] * (1.0 - uniform_rows(keys, n))
    return torch.searchsorted(cum, r, side="left")


def uniform_keys(keys: np.ndarray, n: int, device, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """`uniform(k, (n,), minval, maxval)` for each host key `k` of
    `keys [S, 2]`, drawn on `device`: `[S, n]` float32."""
    u = uniform_rows(key_rows(keys, device), n)
    if minval == 0.0 and maxval == 1.0:
        return u
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(u * float(hi - lo) + float(lo), float(lo))


def erfinv_rows(x: torch.Tensor) -> torch.Tensor:
    """`erfinv_f32` in torch ops (float32, any device)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for i in range(1, 9):
        p = torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]) + p * w
    big = float(np.finfo(np.float32).max)
    return torch.where(x.abs() == 1.0, x * big, p * x)


def normal_keys(keys: np.ndarray, n: int, device) -> torch.Tensor:
    """`normal(k, (n,))` for each host key `k` of `keys [S, 2]`, drawn on
    `device`: `[S, n]` float32 (within a float32 rounding of the host
    draw: the device's `log1p` may round the other way)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
    u = uniform_keys(keys, n, device, lo, 1.0)
    return float(np.float32(np.sqrt(2))) * erfinv_rows(u)
