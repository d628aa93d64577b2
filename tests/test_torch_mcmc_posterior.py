"""The port's batched elliptical slice sampler, chain diagnostics and
`senna bge --posterior` samplers (`ops/mcmc.py`,
`embedding/posterior.py`) against the JAX package's, on the CPU.

The uniform, normal and Bernoulli draws are the same threefry streams;
the normal draws agree within one float32 rounding of XLA's erfinv, so
one ESS step under the same key is held within 1e-6. The half-Cauchy
hyperpriors' Gamma draws are the port's own (Marsaglia-Tsang from the
threefry stream), so `pb_gibbs` is held to the JAX package's own recovery
bars (`tests/test_posterior.py`) and its pips within a mean absolute
difference of 0.1 of JAX's run on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legume_tpu.embedding import posterior as jpost
from legume_tpu.ops import mcmc as jmcmc
from legume_tpu_torch.embedding import posterior as tpost
from legume_tpu_torch.ops import mcmc as tmcmc
from legume_tpu_torch.parallel.mesh import make_mesh
from legume_tpu_torch.utils import prng
from torch_cpu import one_thread


def _rows(a, idx):
    t = torch.from_numpy(a)
    return t if idx is None else t[idx]


def _target(seed=0, b=200, d=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("seed", [3, 11])
def test_ess_step_matches_jax(seed):
    cur, nu, mu = _target(seed)
    jl = lambda s: -0.5 * jnp.sum((s - mu) ** 2 * 4.0, axis=1)  # noqa: E731
    tl = lambda s, idx: -0.5 * ((s - _rows(mu, idx)) ** 2 * 4.0).sum(1)  # noqa: E731
    want, want_ln = jmcmc.elliptical_slice_step_batched(
        jax.random.key(seed), jnp.asarray(cur), jnp.asarray(nu), jl, jl(jnp.asarray(cur)))
    stats = {}
    got, got_ln = tmcmc.elliptical_slice_step_batched(
        prng.key(seed), torch.from_numpy(cur), torch.from_numpy(nu), tl,
        tl(torch.from_numpy(cur), None), stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_ln.numpy(), np.asarray(want_ln), rtol=1e-5, atol=1e-5)
    assert stats["ess_steps"] == 1 and 1 <= stats["ess_iters"] <= tmcmc.MAX_BRACKET_ITERS


def test_ess_chains_match_jax():
    cur, _, mu = _target(5, b=50)
    jl = lambda s: -0.5 * jnp.sum((s - mu) ** 2, axis=1)  # noqa: E731
    tl = lambda s, idx: -0.5 * ((s - _rows(mu, idx)) ** 2).sum(1)  # noqa: E731
    want, _ = jmcmc.run_ess_chains(jax.random.key(5), jnp.asarray(cur),
                                   lambda k, s: jax.random.normal(k, s), jl,
                                   num_samples=4, burn_in=2, thin=2)
    got, _ = tmcmc.run_ess_chains(
        prng.key(5), torch.from_numpy(cur),
        lambda k, s: prng.normal_keys(k[None], int(np.prod(s)), "cpu")[0].reshape(s), tl,
        num_samples=4, burn_in=2, thin=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_diagnostics_match_exactly():
    rng = np.random.default_rng(2)
    for x in (np.cumsum(rng.normal(size=97)), rng.normal(size=40), np.ones(10), rng.normal(size=3)):
        assert tmcmc.ess(x) == jmcmc.ess(x)
        assert tmcmc.split_rhat(x) == jmcmc.split_rhat(x)
    assert tmcmc.mcse_proportion(0.3, 17.0) == jmcmc.mcse_proportion(0.3, 17.0)


def test_hyper_primitives_match():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        hj, ht = jpost.HalfCauchyVar(1.5), tpost.HalfCauchyVar(1.5)
        assert [hj.sample(3.0, 7, a) for _ in range(4)] == [ht.sample(3.0, 7, b) for _ in range(4)]
        assert jpost.sample_pi0(3, 10, 1.0, 1.0, a) == tpost.sample_pi0(3, 10, 1.0, 1.0, b)
    np.testing.assert_array_equal(tpost.ibp_pi0(2.0, 6), jpost.ibp_pi0(2.0, 6))


def test_gamma_draws_follow_the_distribution():
    """The port's own Gamma draws: mean and variance of Gamma(a, 1) for
    shapes below and above 1, and the same draws for the same key."""
    for a in (0.5, 1.0, 3.5, 40.0):
        alpha = torch.full((20000,), a)
        g = tpost._gamma(prng.key(7), alpha).numpy().astype(np.float64)
        assert abs(g.mean() - a) < 4 * np.sqrt(a / 20000), (a, g.mean())
        assert abs(g.var() / a - 1.0) < 0.1, (a, g.var())
        np.testing.assert_array_equal(g, tpost._gamma(prng.key(7), alpha).numpy())


def _selection_setup():
    """`tests/test_posterior.py::test_selection_pass_keeps_informative_dims`."""
    rng = np.random.default_rng(1)
    p, d, h, k_neg = 20, 80, 4, 5.0
    feat = rng.normal(0, 1.0, size=(d, h)).astype(np.float32)
    axis = np.zeros((p, h), np.float32)
    axis[:, :2] = rng.normal(0, 1.0, size=(p, 2))
    s0 = axis @ feat.T
    q = np.full(d, 1.0 / d)
    m = np.full(p, 2000.0)
    axis_b = -np.log(k_neg * (q[None, :] * np.exp(s0)).sum(1))
    counts = (k_neg * q[None, :] * m[:, None] * np.exp(s0 + axis_b[:, None])).astype(np.float32)
    return (feat, np.zeros(d, np.float32), axis, axis_b.astype(np.float32), counts), \
        dict(n_sweeps=2, prior_logit=-1.0, k_neg=k_neg, q_marginal=q, seed=2)


def test_selection_pass_gates_equal():
    args, kw = _selection_setup()
    want = jpost.selection_pass(*args, **kw)
    got = tpost.selection_pass(*args, **kw, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[:, :2].mean() > 0.6 and got[:, 2:].mean() < 0.45


def test_pb_posterior_ess_recovers_embedding():
    """`tests/test_posterior.py::test_pb_posterior_recovers_embedding`'s
    data and bars, at fewer samples."""
    rng = np.random.default_rng(0)
    p, d, h = 16, 120, 2
    feat = rng.normal(0, 0.8, size=(d, h)).astype(np.float32)
    feat_b = np.full(d, -1.0, np.float32)
    e_true = rng.normal(0, 0.8, size=(p, h)).astype(np.float32)
    y = rng.poisson(np.exp(e_true @ feat.T + feat_b[None, :])).astype(np.float32)
    kw = dict(num_samples=60, burn_in=20, seed=1, device="cpu")
    with one_thread():
        out = tpost.pb_posterior_ess(y, feat, feat_b, **kw)
        # the mesh of a world of one (no process group) is the plain run
        one = tpost.pb_posterior_ess(y, feat, feat_b, mesh=make_mesh("cpu"), **kw)
    for hh in range(h):
        assert np.corrcoef(out["e_mean"][:, hh], e_true[:, hh])[0, 1] > 0.8
    assert np.isfinite(out["lnpdf"]).all() and out["draws"].shape == (60, p, h + 1)
    for name in ("draws", "lnpdf", "rhat", "ess"):
        np.testing.assert_array_equal(one[name], out[name])


@pytest.fixture(scope="module")
def gibbs():
    """`tests/test_posterior.py::test_pb_gibbs_recovers_sparse_loadings`'s
    data through both packages."""
    rng = np.random.default_rng(0)
    d, p, h = 40, 12, 2
    z_true = np.zeros((d, h))
    active = rng.random((d, h)) < 0.3
    z_true[active] = rng.normal(0, 1.2, active.sum())
    e_pb = rng.normal(0, 1.0, (p, h))
    y = rng.poisson(np.exp(np.clip(e_pb @ z_true.T + 0.5, -8, 8))).astype(np.float64)
    args = (y, z_true + rng.normal(0, 0.3, z_true.shape), np.full(d, 0.5),
            e_pb + rng.normal(0, 0.3, e_pb.shape), np.zeros(p))
    kw = dict(n_sweeps=12, burnin=4, transitions_per_dim=2, stick_alpha=2.0, seed=1)
    stats = {}
    port = tpost.pb_gibbs(*args, **kw, device="cpu", stats=stats)
    return dict(port=port, jax=jpost.pb_gibbs(*args, **kw), active=active, e_pb=e_pb,
                z_true=z_true, stats=stats, p=p)


def _auc(res, active):
    num = den = 0.0
    for dim in range(active.shape[1]):
        on, off = res.pip[active[:, dim], dim], res.pip[~active[:, dim], dim]
        for a in on:
            for b in off:
                den += 1
                num += (a > b) + 0.5 * (a == b)
    return num / max(den, 1)


def test_pb_gibbs_meets_the_recovery_bars(gibbs):
    res = gibbs["port"]
    assert _auc(res, gibbs["active"]) > 0.75
    assert res.rhat.shape == (gibbs["p"],) and res.ess.shape == (gibbs["p"],)
    assert np.isfinite(res.sigma2_trace).all() and res.sigma2_trace.shape == (12, 2)
    s_true = (gibbs["e_pb"] @ gibbs["z_true"].T).ravel()
    s_est = (res.e_pb_mean @ res.e_feat_mean.T).ravel()
    assert np.corrcoef(s_true, s_est)[0, 1] > 0.8
    # every gene-block and pb-block ESS step of every sweep ran
    assert gibbs["stats"]["ess_steps"] == (12 + 4) * (2 * 2 + 2)


def test_pb_gibbs_pips_near_jax(gibbs):
    assert np.abs(gibbs["port"].pip - gibbs["jax"].pip).mean() < 0.1
    for name in ("e_feat_mean", "pip", "e_pb_mean", "b_pb_mean", "rhat", "ess"):
        assert getattr(gibbs["port"], name).shape == getattr(gibbs["jax"], name).shape
