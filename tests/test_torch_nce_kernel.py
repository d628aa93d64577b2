"""K4's plain version, through the port's `nce_epoch_grads`, against the
JAX package's fused NCE epoch kernel (interpret mode) and against
`value_and_grad` of its XLA loss, at unaligned P and D; the tolerances
are those of `tests/test_nce_pallas.py` (loss rtol 2e-5, gradients rtol
1e-4 / atol 1e-6). Also: bf16 counts, the width limit, the state carried
across by `params_from_jax`, and the kernel table of `ops/kernels.py`."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legume_tpu.embedding.nce import AxisSide as JAxis
from legume_tpu.embedding.nce import FeatSide as JFeat
from legume_tpu.embedding.nce import _expected_nce_loss
from legume_tpu.embedding.nce_pallas import nce_epoch_grads as j_nce_epoch_grads
from legume_tpu_torch.embedding.nce import AxisSide, FeatSide, expected_nce_loss, params_from_jax
from legume_tpu_torch.embedding.nce_kernel import nce_epoch_grads
from legume_tpu_torch.ops import kernels

K_NEG = 5.0


def _problem(seed, p=37, d=200, h=16, lam=1.0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(lam, (p, d)).astype(np.float32)
    q = counts.sum(0) ** 0.75
    q = (q / q.sum()).astype(np.float32)
    params = {
        "feat": JFeat(
            e_feat=(0.1 * rng.normal(size=(d, h))).astype(np.float32),
            b_feat=(0.01 * rng.normal(size=d)).astype(np.float32),
        ),
        "axes": [JAxis(
            e=(0.1 * rng.normal(size=(p, h))).astype(np.float32),
            b=(0.01 * rng.normal(size=p)).astype(np.float32),
        )],
    }
    return counts, q, params


def _jax_value_and_grad(counts, q, params, ridge):
    m = counts.sum(1)
    feat = JFeat(*map(jnp.asarray, params["feat"]))
    axis = JAxis(*map(jnp.asarray, params["axes"][0]))

    def loss(pa):
        return _expected_nce_loss(pa[0], pa[1], jnp.asarray(counts), jnp.asarray(q),
                                  jnp.asarray(m), k_neg=K_NEG, ridge=ridge)

    val, (gf, ga) = jax.value_and_grad(loss)((feat, axis))
    return float(val), [np.asarray(x) for x in (gf.e_feat, gf.b_feat, ga.e, ga.b)]


def _jax_pallas_interpret(counts, q, params, ridge, dtype="float32"):
    """The JAX fused kernel on its own padded layout, cut back to [P, D]."""
    p, d = counts.shape
    p_pad, d_pad = -(-p // 8) * 8, -(-d // 128) * 128
    c_pad = np.zeros((p_pad, d_pad), np.float32)
    c_pad[:p, :d] = counts
    q_pad = np.zeros((1, d_pad), np.float32)
    q_pad[0, :d] = q
    m_pad = c_pad.sum(axis=1, keepdims=True)
    f, a = params["feat"], params["axes"][0]
    out = j_nce_epoch_grads(
        jnp.pad(jnp.asarray(f.e_feat), ((0, d_pad - d), (0, 0))),
        jnp.pad(jnp.asarray(f.b_feat), (0, d_pad - d)),
        jnp.asarray(a.e), jnp.asarray(a.b),
        jnp.asarray(c_pad).astype(jnp.dtype(dtype)), jnp.asarray(q_pad), jnp.asarray(m_pad),
        k_neg=K_NEG, total=jnp.asarray(max(counts.sum(), 1.0), jnp.float32), ridge=ridge,
        d_real=d, interpret=True,
    )
    loss, g_ef, g_bf, g_ea, g_ba = (np.asarray(x) for x in out)
    return float(loss), [g_ef[:d], g_bf[:d], g_ea, g_ba]


def _port(counts, q, params, ridge, c_dtype=torch.float32):
    tp = params_from_jax(params, device="cpu")
    c = torch.from_numpy(counts)
    out = nce_epoch_grads(
        tp["feat"].e_feat, tp["feat"].b_feat, tp["axes"][0].e, tp["axes"][0].b,
        c.to(c_dtype), torch.from_numpy(q), c.sum(1),
        k_neg=K_NEG, total=torch.clamp_min(c.sum(), 1.0), ridge=ridge,
    )
    return float(out[0]), [x.numpy() for x in out[1:]]


@pytest.mark.parametrize("reference", ["value_and_grad", "pallas_interpret"])
@pytest.mark.parametrize("ridge", [0.0, 0.01])
def test_epoch_grads_match_jax(reference, ridge):
    counts, q, params = _problem(0)
    ref = _jax_value_and_grad if reference == "value_and_grad" else _jax_pallas_interpret
    want_loss, want = ref(counts, q, params, ridge)
    got_loss, got = _port(counts, q, params, ridge)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_bf16_counts_close_to_f32_and_to_the_jax_kernel():
    counts, q, params = _problem(1, p=16, d=256, h=8, lam=2.0)
    loss32, _ = _port(counts, q, params, 0.0)
    loss16, g16 = _port(counts, q, params, 0.0, c_dtype=torch.bfloat16)
    np.testing.assert_allclose(loss16, loss32, rtol=1e-2)
    # both kernels compute in f32 from the same bf16 counts
    want_loss, want = _jax_pallas_interpret(counts, q, params, 0.0, dtype="bfloat16")
    np.testing.assert_allclose(loss16, want_loss, rtol=2e-5)
    for g, w in zip(g16, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("h,ok", [(128, True), (129, False)])
def test_width_limit(h, ok):
    counts, q, params = _problem(2, p=9, d=40, h=h)
    if ok:
        loss, grads = _port(counts, q, params, 0.0)
        assert np.isfinite(loss) and grads[0].shape == (40, h)
    else:
        with pytest.raises(ValueError, match="exceeds"):
            _port(counts, q, params, 0.0)


def test_params_from_jax_round_trips_and_feeds_the_autograd_loss():
    counts, q, params = _problem(3)
    tp = params_from_jax(params, device="cpu")
    assert isinstance(tp["feat"], FeatSide) and isinstance(tp["axes"][0], AxisSide)
    np.testing.assert_array_equal(tp["feat"].e_feat.numpy(), params["feat"].e_feat)
    np.testing.assert_array_equal(tp["feat"].b_feat.numpy(), params["feat"].b_feat)
    np.testing.assert_array_equal(tp["axes"][0].e.numpy(), params["axes"][0].e)
    np.testing.assert_array_equal(tp["axes"][0].b.numpy(), params["axes"][0].b)
    assert all(t.dtype == torch.float32 for t in (*tp["feat"], *tp["axes"][0]))
    # the port's autograd loss on the converted state equals JAX's
    want_loss, want = _jax_value_and_grad(counts, q, params, 0.01)
    leaves = [t.clone().requires_grad_(True) for t in (*tp["feat"], *tp["axes"][0])]
    c = torch.from_numpy(counts)
    loss = expected_nce_loss(FeatSide(*leaves[:2]), AxisSide(*leaves[2:]), c,
                             torch.from_numpy(q), c.sum(1), k_neg=K_NEG, ridge=0.01)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=2e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)


def test_kernel_sources_bind_their_own_symbols():
    """Every source has its own C entry points, and they exist in it; an
    unknown source is refused before any library is opened."""
    assert set(kernels._ENTRIES) == set(kernels.SOURCES)
    for name, entries in kernels._ENTRIES.items():
        src = (kernels.CSRC / f"{name}.cu").read_text()
        for symbol in entries:
            assert f" {symbol}(" in src, (name, symbol)
    with pytest.raises(KeyError):
        kernels._load("bogus", Path("no-such-library.so"))
