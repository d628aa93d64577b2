"""The port's numpy threefry2x32 against `jax.random` on the same seeds:
key data, split and random bits bit for bit; normal and gumbel draws
within one float32 rounding of XLA's erfinv/log (atol 1e-6)."""

import jax
import numpy as np
import pytest

from legume_tpu.utils import prng as jprng
from legume_tpu_torch.utils import prng

SEEDS = [
    0,
    7,
    0x7FFFFFFF,
    0x1_8000_0001,
    prng.DEFAULT_PROJECTION_SEED,
    prng.mix_seed(prng.DEFAULT_PROJECTION_SEED, 17),
]


def test_constants_and_mix_seed_match():
    assert prng.DEFAULT_PROJECTION_SEED == jprng.DEFAULT_PROJECTION_SEED
    for base in (0, 12345, prng.DEFAULT_PROJECTION_SEED):
        for salt in (0, 1, 17):
            assert prng.mix_seed(base, salt) == jprng.mix_seed(base, salt)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_equal(seed):
    jk = jprng.key_from_seed(seed)
    pk = prng.key_from_seed(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), pk)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jax.random.split(jk, 5))), prng.split(pk, 5)
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (37, 11))), prng.random_bits(pk, (37, 11))
    )
    # salted keys (the rSVD sketch seed) and chained splits
    jks = jprng.key_from_seed(seed, 17)
    pks = prng.key_from_seed(seed, 17)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jks)), pks)
    j2 = jax.random.split(jax.random.split(jks)[1], 3)
    p2 = prng.split(prng.split(pks)[1], 3)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(j2)), p2)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_normal_gumbel(seed):
    jk = jprng.key_from_seed(seed)
    pk = prng.key_from_seed(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (257,))), prng.uniform(pk, (257,))
    )
    np.testing.assert_allclose(
        np.asarray(jax.random.normal(jk, (200, 50))), prng.normal(pk, (200, 50)), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(jax.random.gumbel(jk, (64, 33))), prng.gumbel(pk, (64, 33)), rtol=0, atol=1e-6
    )


def test_plain_key_matches_jax_key():
    for seed in (0, 3, 0x7FFFFFFF):
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.key(seed))), prng.key(seed)
        )


def test_generator_from_key_is_deterministic():
    import torch

    k = prng.key(11)
    a = torch.rand(4, generator=prng.generator_from_key(k))
    b = torch.rand(4, generator=prng.generator_from_key(k))
    c = torch.rand(4, generator=prng.generator_from_key(prng.key(12)))
    assert torch.equal(a, b) and not torch.equal(a, c)
