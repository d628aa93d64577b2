"""The port's SGVB trainer (`legume_tpu_torch/models/sgvb.py`) against the
JAX package's, on the CPU.

- The draws are JAX's bit for bit: the init's normal draws and the
  per-step normal draws (`prng.normal_exact_keys`: torch's rows on the
  card, numpy's on the CPU).
- At one shared q (carried across with `models/convert.py`) and one
  shared eps, every family's negative ELBO agrees within 1e-5 relative
  and each of its gradients within 1e-5 of its largest entry; so do the
  five likelihoods (normwise: the vMF sums cancel) and their gradients
  in eta.
- 20 steps of `fit_regression` land within 1e-4 of JAX's parameters.
  ash's `mix_logits` start uniform, where their gradient is zero up to
  rounding, so Adam's first step moves all of them by +-lr in either
  package alike; the ELBO is invariant to that shift, and the logits are
  compared centred.
- Whole fits: the final ELBO within 1e-4 relative and the PIPs within
  1e-3 of JAX's (measured: 8e-6 and 1.2e-7 on a 1,000-step SuSiE fit).
- The JAX package's own recovery bars (`tests/test_sgvb.py`) hold for
  the port's fits, and the exact host parts (`cavi_susie`, `RssDesign`)
  give JAX's arrays. The ESS fits on short chains agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legume_tpu.fagioli import sumstat as jss
from legume_tpu.models import sgvb as J
from legume_tpu.ops import sparse_regression as jsr
from legume_tpu_torch.fagioli import sumstat as tss
from legume_tpu_torch.models import sgvb as T
from legume_tpu_torch.models.convert import sgvb_params_from_jax, sgvb_params_to_jax
from legume_tpu_torch.ops import sparse_regression as tsr
from legume_tpu_torch.utils import prng
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["gaussian", "spike-slab", "susie", "susie-no-null", "bisusie", "ml-susie", "ash"]
PV = [0.01, 0.1, 1.0]


def _data(seed=1, n=80, p=24, k=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    beta = np.zeros((p, k))
    beta[[3, 17]] = 1.3
    y = x @ beta + 0.5 * rng.standard_normal((n, k))
    return x, y


def _onehot(p):
    g = J.contiguous_ld_blocks(p)
    return np.eye(int(g.max()) + 1, dtype=np.float32)[g]


def _init(family, p, k, key, L=3):
    """JAX's init for `family`, perturbed so that no logit is zero."""
    if family == "gaussian":
        q = J.gaussian_var_init(key, p, k)
    elif family == "spike-slab":
        q = J.spike_slab_init(key, p, k)
    elif family in ("susie", "susie-no-null"):
        q = J.susie_init(key, L, p, k, with_null=family == "susie")
    elif family == "bisusie":
        q = J.bisusie_init(key, L, p, k)
    elif family == "ml-susie":
        q = J.ml_susie_init(key, L, p, k, _onehot(p).shape[1])
    else:
        ss = J.spike_slab_init(key, p, k)
        q = J.AshVarParams(ss.gate_logits, ss.beta_mean, ss.beta_ln_std,
                           jnp.zeros((p, k, len(PV))), jnp.zeros(len(PV)))
    rng = np.random.default_rng(7)
    return type(q)(*(jnp.asarray(np.asarray(v) + 0.3 * rng.standard_normal(v.shape), jnp.float32)
                     for v in q))


def _fns(mod, family, p, xp):
    """(moments, kl) of `family` in package `mod` (J or T)."""
    if family == "gaussian":
        return mod.gaussian_var_moments, lambda q: mod.gaussian_var_kl(q, prior_var=0.5)
    if family == "spike-slab":
        return mod.spike_slab_moments, lambda q: mod.spike_slab_kl(q, prior_var=0.5)
    if family in ("susie", "susie-no-null"):
        return mod.susie_moments, lambda q: mod.susie_kl(q, prior_var=0.5)
    if family == "bisusie":
        return mod.bisusie_moments, lambda q: mod.bisusie_kl(q, prior_var=0.5)
    if family == "ml-susie":
        oh = xp(_onehot(p))
        return (lambda q: mod.ml_susie_moments(q, oh),
                lambda q: mod.ml_susie_kl(q, oh, prior_var=0.5))
    pv = xp(np.asarray(PV, np.float32))
    mom = lambda q: mod.spike_slab_moments(  # noqa: E731
        mod.SpikeSlabVarParams(q.gate_logits, q.beta_mean, q.beta_ln_std))
    return mom, lambda q: mod.ash_kl(q, pv, 0.1)


def test_normal_rows_equal_jax_bits():
    """Both forms of the trainer's draw: torch's rows (the card's form, run
    here on the CPU) and numpy's (the CPU's form)."""
    for seed in (0, 3, 11):
        for shape in ((8, 40, 1), (4096,), (2, 7, 3)):
            want = np.asarray(jax.random.normal(jax.random.key(seed), shape)).view(np.uint32)
            n = int(np.prod(shape))
            rows = prng.normal_exact_rows(prng.key_rows(prng.key(seed)[None], "cpu"), n)
            host = prng.normal_exact_keys(prng.key(seed)[None], n, "cpu")
            for got in (rows, host):
                assert np.array_equal(got[0].numpy().reshape(shape).view(np.uint32), want)
    # the tail branch of erfinv (|u| near 1) at many draws
    k = prng.split(prng.key(3))[1]
    want = np.asarray(jax.random.normal(jax.random.split(jax.random.key(3))[1], (200_000,)))
    assert np.array_equal(prng.normal_exact_rows(prng.key_rows(k[None], "cpu"), 200_000)[0].numpy(),
                          want)


@pytest.mark.parametrize("family", ["gaussian", "spike-slab", "susie", "susie-no-null",
                                    "bisusie", "ml-susie"])
def test_init_draws_equal_jax(family):
    key_j, key_t = jax.random.key(5), prng.key(5)
    p, k, L = 30, 2, 4
    if family == "gaussian":
        a, b = J.gaussian_var_init(key_j, p, k), T.gaussian_var_init(key_t, p, k)
    elif family == "spike-slab":
        a, b = J.spike_slab_init(key_j, p, k), T.spike_slab_init(key_t, p, k)
    elif family == "ml-susie":
        a, b = J.ml_susie_init(key_j, L, p, k, 6), T.ml_susie_init(key_t, L, p, k, 6)
    elif family == "bisusie":
        a, b = J.bisusie_init(key_j, L, p, k), T.bisusie_init(key_t, L, p, k)
    else:
        wn = family == "susie"
        a, b = J.susie_init(key_j, L, p, k, with_null=wn), T.susie_init(key_t, L, p, k, with_null=wn)
    assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
    for u, v in zip(a, b):
        assert np.array_equal(np.asarray(u), v.numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_negative_elbo_and_gradients_match(family):
    k = 2 if family == "bisusie" else 1
    x, y = _data(k=k)
    n, p = x.shape
    qj = _init(family, p, k, jax.random.key(2))
    eps = np.random.default_rng(3).standard_normal((6, n, k)).astype(np.float32)
    xf, yf = x.astype(np.float32), y.astype(np.float32)

    mom_j, kl_j = _fns(J, family, p, jnp.asarray)

    def loss_j(q):
        mean, var = mom_j(q)
        eta = xf @ mean + jnp.sqrt(jnp.maximum((xf * xf) @ var, 1e-12))[None] * eps
        return -(jnp.mean(J.gaussian_llik(yf, eta, obs_var=0.3)) - 0.7 * kl_j(q))

    want, gj = jax.value_and_grad(loss_j)(qj)

    qt = sgvb_params_from_jax(qj)
    qt = type(qt)(*(v.requires_grad_(True) for v in qt))
    mom_t, kl_t = _fns(T, family, p, torch.from_numpy)
    xt = torch.from_numpy(xf)
    got = T.negative_elbo(qt, torch.from_numpy(eps), x=xt, x_sq=xt * xt, y=torch.from_numpy(yf),
                          moments=mom_t, kl=kl_t,
                          llik=lambda yy, ee: T.gaussian_llik(yy, ee, obs_var=0.3), kl_weight=0.7)
    gt = torch.autograd.grad(got, list(qt))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for name, a, b in zip(qj._fields, gj, gt):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), name


@pytest.mark.parametrize("name", ["gaussian", "weighted", "poisson", "nb", "vmf"])
def test_likelihoods_and_gradients_match(name):
    rng = np.random.default_rng(4)
    n, k = 50, 3
    y = rng.poisson(3.0, (n, k)).astype(np.float32)
    eta = (0.4 * rng.standard_normal((5, n, k))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    fj = {"gaussian": lambda e: J.gaussian_llik(y, e, obs_var=0.5),
          "weighted": lambda e: J.weighted_gaussian_llik(y, e, w),
          "poisson": lambda e: J.poisson_llik(y, e),
          "nb": lambda e: J.nb_llik(y, e, log_phi=0.3),
          "vmf": lambda e: J.vmf_llik(y, e, kappa=4.0)}[name]
    yt = torch.from_numpy(y)
    ft = {"gaussian": lambda e: T.gaussian_llik(yt, e, obs_var=0.5),
          "weighted": lambda e: T.weighted_gaussian_llik(yt, e, torch.from_numpy(w)),
          "poisson": lambda e: T.poisson_llik(yt, e),
          "nb": lambda e: T.nb_llik(yt, e, log_phi=0.3),
          "vmf": lambda e: T.vmf_llik(yt, e, kappa=4.0)}[name]
    want = np.asarray(fj(jnp.asarray(eta)))
    gj = np.asarray(jax.grad(lambda e: jnp.sum(fj(e)))(jnp.asarray(eta)))
    et = torch.from_numpy(eta).requires_grad_(True)
    got = ft(et)
    (gt,) = torch.autograd.grad(got.sum(), et)
    # normwise: the vMF sums cancel
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()


def _fit_pair(family, steps, **kw):
    k = 2 if family == "bisusie" else 1
    x, y = _data(seed=9, k=k)
    if family == "ash":
        a = J.fit_regression_ash(x, y, prior_vars=PV, config=J.SgvbConfig(num_steps=steps, **kw))
        b = T.fit_regression_ash(x, y, prior_vars=PV, config=T.SgvbConfig(num_steps=steps, **kw),
                                 device="cpu")
    else:
        fam = "susie" if family == "susie-no-null" else family
        extra = {"with_null": family != "susie-no-null", "L": 3}
        a = J.fit_regression(x, y, family=fam, config=J.SgvbConfig(num_steps=steps, **kw), **extra)
        b = T.fit_regression(x, y, family=fam, config=T.SgvbConfig(num_steps=steps, **kw),
                             device="cpu", **extra)
    return a, b


@pytest.mark.parametrize("family", FAMILIES)
def test_twenty_steps_land_on_jax_parameters(family):
    a, b = _fit_pair(family, 20, learning_rate=0.02)
    name, got = sgvb_params_to_jax(b["q"])
    assert name == type(a["q"]).__name__
    for field, want in zip(a["q"]._fields, a["q"]):
        g, w = got[field], np.asarray(want)
        if field == "mix_logits":  # a constant shift, to which the ELBO is blind
            g, w = g - g.mean(), w - w.mean()
        assert np.abs(g - w).max() <= 1e-4, field
    assert abs(a["elbo"] - b["elbo"]) <= 1e-5 * abs(a["elbo"])
    assert len(a["losses"]) == len(b["losses"]) == 1


def test_whole_fit_within_band_of_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 40))
    y = x[:, [6]] * 1.4 - x[:, [30]] * 1.1 + 0.5 * rng.standard_normal((200, 1))
    cfg = dict(num_steps=600, learning_rate=0.02, prior_var=0.5)
    a = J.fit_regression(x, y, family="susie", L=4, config=J.SgvbConfig(**cfg))
    b = T.fit_regression(x, y, family="susie", L=4, config=T.SgvbConfig(**cfg), device="cpu")
    assert abs(a["elbo"] - b["elbo"]) <= 1e-4 * abs(a["elbo"])
    assert np.abs(np.asarray(a["pip"]) - b["pip"]).max() <= 1e-3
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-4)


def test_sgvb_params_round_trip():
    for family in FAMILIES:
        qj = _init(family, 12, 1, jax.random.key(1))
        name, arrays = sgvb_params_to_jax(sgvb_params_from_jax(qj))
        back = getattr(J, name)(**arrays)
        for u, v in zip(qj, back):
            assert np.array_equal(np.asarray(u), v)


def test_cavi_susie_and_rss_design_equal_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((120, 30))
    x = (x - x.mean(0)) / x.std(0)
    y = x[:, 4] - 0.8 * x[:, 20] + 0.5 * rng.standard_normal(120)
    a, b = J.cavi_susie(x, y, L=3, prior_var=0.5, obs_var=0.25), T.cavi_susie(
        x, y, L=3, prior_var=0.5, obs_var=0.25)
    for key in a:
        assert np.array_equal(a[key], b[key])
    geno = rng.binomial(2, 0.3, (80, 40)).astype(np.float64)
    z = rng.standard_normal((40, 2)) * 2.0
    for kw in ({}, {"rank": 10, "lam": 0.3}, {"ldsc_intercept": False, "pve_adjust": False}):
        da, db = J.RssDesign.from_genotypes(geno, z, **kw), T.RssDesign.from_genotypes(geno, z, **kw)
        assert np.array_equal(da.x_tilde, db.x_tilde) and np.array_equal(da.y_tilde, db.y_tilde)
    for p, bs in ((120, None), (7, None), (50, 9)):
        assert np.array_equal(J.contiguous_ld_blocks(p, bs), T.contiguous_ld_blocks(p, bs))


def test_fit_sumstat_mcmc_short_chains_match_jax():
    sim = jss.simulate_sumstat(n=120, p=16, n_causal=1, h2=0.4, seed=10)
    kw = dict(num_samples=12, burn_in=4, prior_sd=0.3, n_chains=3, seed=2)
    a = jss.fit_sumstat_mcmc(sim.z, sim.genotypes, **kw)
    b = tss.fit_sumstat_mcmc(sim.z, sim.genotypes, device="cpu", **kw)
    np.testing.assert_allclose(b["samples"], a["samples"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b["beta_mean"], a["beta_mean"], rtol=0, atol=1e-6)


def test_sparse_regression_short_chain_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 6)).astype(np.float32)
    y = 2.0 * x[:, 1] + 0.3 * rng.standard_normal(60)
    kw = dict(num_components=2, num_samples=15, burn_in=5, seed=1)
    a = jsr.fit_sparse_regression_mcmc(x, y, **kw)
    b = tsr.fit_sparse_regression_mcmc(x, y, device="cpu", **kw)
    np.testing.assert_allclose(b.theta_draws, a.theta_draws, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(b.pip, a.pip)


# ---- the JAX package's recovery bars (tests/test_sgvb.py), on the port --------


def test_gaussian_regression_recovers_coefficients():
    rng = np.random.default_rng(0)
    n, p = 300, 10
    x = rng.standard_normal((n, p))
    beta = np.zeros((p, 1))
    beta[2, 0], beta[7, 0] = 2.0, -1.5
    y = x @ beta + 0.3 * rng.standard_normal((n, 1))
    out = T.fit_regression(
        x, y, family="gaussian", llik=lambda yy, ee: T.gaussian_llik(yy, ee, obs_var=0.09),
        config=T.SgvbConfig(num_steps=800, learning_rate=0.02, prior_var=10.0), device="cpu",
    )
    np.testing.assert_allclose(out["theta_mean"], beta, atol=0.15)


def test_susie_finds_causal_variables():
    rng = np.random.default_rng(1)
    n, p = 400, 50
    x = rng.standard_normal((n, p))
    causal = [5, 23]
    beta = np.zeros((p, 1))
    beta[causal, 0] = [1.5, -1.2]
    y = x @ beta + 0.5 * rng.standard_normal((n, 1))
    out = T.fit_regression(
        x, y, family="susie", L=4, llik=lambda yy, ee: T.gaussian_llik(yy, ee, obs_var=0.25),
        config=T.SgvbConfig(num_steps=1200, learning_rate=0.02, prior_var=1.0), device="cpu",
    )
    pip = out["pip"][:, 0]
    assert set(causal).issubset(set(np.argsort(-pip)[:4].tolist()))
    assert pip[causal].min() > 0.3
    assert np.median(pip) < 0.2


@pytest.mark.parametrize("multilevel", [False, True])
def test_susie_rss_finemapping_recovery(multilevel):
    sim = tss.simulate_sumstat(n=600, p=120, n_causal=2, h2=0.4, seed=2)
    out = tss.map_sumstat(sim.z, sim.genotypes, L=4, multilevel=multilevel,
                          config=T.SgvbConfig(num_steps=1200, learning_rate=0.02), device="cpu")
    pip = out["pip"]
    assert pip.shape == (120,)
    causal_idx = np.nonzero(sim.causal)[0]
    top = np.argsort(-pip)[:5]
    for c in causal_idx:
        assert np.min(np.abs(top - c)) <= 2, (c, top, pip[c])
    if multilevel:
        far = np.ones(120, bool)
        for c in causal_idx:
            far[max(c - 3, 0) : c + 4] = False
        assert np.median(pip[far]) < 0.1


def test_spike_slab_sparsity_and_poisson_regression():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 30))
    beta = np.zeros((30, 1))
    beta[4, 0] = 2.0
    y = x @ beta + 0.3 * rng.standard_normal((300, 1))
    out = T.fit_regression(
        x, y, family="spike-slab", llik=lambda yy, ee: T.gaussian_llik(yy, ee, obs_var=0.09),
        config=T.SgvbConfig(num_steps=800, learning_rate=0.02), device="cpu",
    )
    pip = out["pip"][:, 0]
    assert pip[4] > 0.8 and np.median(np.delete(pip, 4)) < 0.3

    rng = np.random.default_rng(4)
    x = rng.standard_normal((400, 5)) * 0.5
    beta = np.asarray([[0.8], [0.0], [-0.6], [0.0], [0.0]])
    y = rng.poisson(np.exp(x @ beta)).astype(np.float32)
    out = T.fit_regression(
        x, y, family="gaussian", llik=T.poisson_llik,
        config=T.SgvbConfig(num_steps=1500, num_samples=16, learning_rate=0.02, prior_var=4.0),
        device="cpu",
    )
    from scipy.optimize import minimize

    mle = minimize(lambda b: -(y[:, 0] * (x @ b) - np.exp(x @ b)).sum(), np.zeros(5)).x[:, None]
    np.testing.assert_allclose(out["theta_mean"], mle, atol=0.1)


def test_bisusie_shares_selection():
    rng = np.random.default_rng(8)
    n, p = 400, 40
    x = rng.standard_normal((n, p))
    y = np.stack([1.2 * x[:, 9] + 0.4 * rng.standard_normal(n),
                  -0.9 * x[:, 9] + 0.4 * rng.standard_normal(n)], 1)
    out = T.fit_regression(
        x, y, family="bisusie", L=2, llik=lambda yy, ee: T.gaussian_llik(yy, ee, obs_var=0.16),
        config=T.SgvbConfig(num_steps=1000, learning_rate=0.02), device="cpu",
    )
    pip = out["pip"][:, 0]
    assert pip[9] > 0.5 and np.median(np.delete(pip, 9)) < 0.2
    assert out["theta_mean"][9, 0] > 0.5 and out["theta_mean"][9, 1] < -0.3


def test_fit_prs_predicts_phenotype():
    sim = tss.simulate_sumstat(n=600, p=120, n_causal=3, h2=0.5, seed=9)
    xs = (sim.genotypes - sim.genotypes.mean(0)) / np.maximum(sim.genotypes.std(0), 1e-8)
    out = tss.fit_prs(sim.z, sim.genotypes, L=6, score_genotypes=sim.genotypes,
                      config=T.SgvbConfig(num_steps=1200, learning_rate=0.02), device="cpu")
    assert np.corrcoef(out["prs"], xs @ sim.beta)[0, 1] > 0.8


def test_fit_sumstat_mcmc_diagnostics():
    sim = tss.simulate_sumstat(n=400, p=40, n_causal=1, h2=0.4, seed=10)
    out = tss.fit_sumstat_mcmc(sim.z, sim.genotypes, num_samples=600, burn_in=150,
                               prior_sd=0.3, device="cpu")
    causal = int(np.nonzero(sim.causal)[0][0])
    assert abs(int(np.argmax(np.abs(out["beta_mean"]))) - causal) <= 2
    assert np.all(out["rhat"] < 1.2) and out["ess"].min() > 50


def test_sparse_regression_mcmc_recovers_support():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 12)).astype(np.float32)
    beta = np.zeros(12)
    beta[[2, 7]] = [2.0, -1.5]
    y = x @ beta + 0.3 * rng.standard_normal(200)
    res = tsr.fit_sparse_regression_mcmc(x, y, num_components=3, num_samples=300, burn_in=200,
                                         seed=1, device="cpu")
    on, off = res.pip[[2, 7]], np.delete(res.pip, [2, 7])
    assert on.min() > off.max()
    assert res.beta_mean[2] > 0.5 and res.beta_mean[7] < -0.3
    assert np.isfinite(res.rhat) and res.ess > 5


def test_susie_overspecified_L_false_positives():
    rng = np.random.default_rng(0)
    n, p, block = 500, 100, 10
    x = np.zeros((n, p))
    for b0 in range(0, p, block):
        base = rng.standard_normal(n)
        for j in range(b0, min(b0 + block, p)):
            x[:, j] = np.sqrt(0.5) * base + np.sqrt(0.5) * rng.standard_normal(n)
    causal = [15, 62]
    beta = np.zeros(p)
    beta[causal] = [0.6, -0.6]
    y = x @ beta + rng.standard_normal(n) * np.sqrt(np.var(x @ beta) * 1.5)
    y = (y - y.mean())[:, None].astype(np.float32)
    xs = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    causal_blocks = {c // block for c in causal}
    for L in (2, 10, 25):
        out = T.fit_regression(xs, y, family="susie", L=L,
                               config=T.SgvbConfig(num_steps=800, seed=1), device="cpu")
        called = np.nonzero(out["pip"][:, 0] > 0.5)[0]
        for j in called:
            assert j // block in causal_blocks, (L, j)
        found = {j // block for j in called}
        assert causal_blocks <= found or len(found) >= 1, (L, called)
