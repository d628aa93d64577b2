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


def generator_from_key(k: np.ndarray, device="cpu") -> torch.Generator:
    """A torch generator seeded from threefry key data (for the streams
    that are compared by distribution, not draw for draw)."""
    seed = (int(k[0]) << 32) | int(k[1])
    return torch.Generator(device=device).manual_seed(seed)
