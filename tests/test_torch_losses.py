"""The model-stack parts no command reaches, in the port against the JAX
package: the likelihoods of `models/losses.py`, `IafSoftmaxEncoder`
(`models/encoders.py`), `BipartiteDecoder` (`models/decoders.py`) and
`ops/archetypal.py::fit_archetypes`, on numpy-seeded inputs.

Tolerances (float32 on both sides): the likelihoods within 1e-5 relative
(1e-4 where lgamma sums large terms); the IAF encoder's forward in eval
mode (eps = 0) within 1e-5 and its parameter gradients within 1e-4 of
their largest entry, with the JAX package's parameters carried over by
`models/convert.py`; the bipartite decoder's scores, likelihoods and
gradients the same; `fit_archetypes` from the same Dirichlet starts within
1e-4 after 50 iterations and at the JAX test's bars after 400.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from scipy.special import gammaln

from legume_tpu.models import decoders as jdec
from legume_tpu.models import encoders as jenc
from legume_tpu.models import losses as J
from legume_tpu.ops.archetypal import fit_archetypes as j_fit_archetypes
from legume_tpu_torch.models import decoders as tdec
from legume_tpu_torch.models import encoders as tenc
from legume_tpu_torch.models import losses as T
from legume_tpu_torch.models.convert import bipartite_params_from_jax, iaf_params_from_jax
from legume_tpu_torch.ops.archetypal import _project_simplex
from legume_tpu_torch.ops.archetypal import fit_archetypes as t_fit_archetypes
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)


def _inputs():
    rng = np.random.default_rng(0)
    n, d = 16, 30
    x = rng.poisson(2.0, (n, d)).astype(np.float32)
    x[rng.uniform(size=(n, d)) < 0.3] = 0.0
    recon = rng.dirichlet(np.ones(d), n).astype(np.float32)
    return dict(
        x=x, recon=recon, log_recon=np.log(recon),
        rate=rng.gamma(2.0, 1.0, (n, d)).astype(np.float32),
        mu=rng.gamma(2.0, 2.0, (n, d)).astype(np.float32),
        log_phi=rng.normal(0, 1, d).astype(np.float32),
        logit=rng.normal(0, 1, d).astype(np.float32),
        mass=rng.gamma(1.0, 1.0, (n, d)).astype(np.float32) + 0.05,
        z=rng.normal(0, 1, (n, 5)).astype(np.float32),
        mean=rng.normal(0, 1, (n, 5)).astype(np.float32),
        lnvar=rng.normal(0, 0.5, (n, 5)).astype(np.float32),
        hat=rng.normal(2, 1, (n, d)).astype(np.float32),
    )


LIKELIHOODS = {
    "gaussian_neg_log_prob": (("z", "mean", "lnvar"), {}, 1e-5),
    "topic_log_likelihood": (("x", "log_recon"), {}, 1e-5),
    "topic_likelihood": (("x", "recon"), {}, 1e-5),
    "poisson_log_likelihood": (("x", "rate"), {}, 1e-5),
    "nb_log_likelihood": (("x", "mu", "log_phi"), {}, 1e-5),
    "nb_log_likelihood_exact": (("x", "mu", "log_phi"), {"exact_lgamma": True}, 1e-5),
    "zi_topic_log_likelihood": (("x", "log_recon", "logit"), {}, 1e-5),
    "dirichlet_log_likelihood": (("x", "mass"), {}, 1e-4),
    "gaussian_log_likelihood": (("x", "hat"), {}, 1e-5),
}


@pytest.mark.parametrize("name", list(LIKELIHOODS))
def test_likelihood_equals_jax(name):
    keys, kw, rtol = LIKELIHOODS[name]
    fn = name.removesuffix("_exact")
    arrays = [_inputs()[k] for k in keys]
    want = np.asarray(getattr(J, fn)(*map(jnp.asarray, arrays), **kw))
    got = getattr(T, fn)(*map(torch.from_numpy, arrays), **kw).numpy()
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


def test_nb_exact_lgamma_is_the_closed_form():
    v = _inputs()
    x, mu, log_phi = (v[k].astype(np.float64) for k in ("x", "mu", "log_phi"))
    phi = np.exp(log_phi)
    want = (gammaln(x + phi) - gammaln(phi) - gammaln(x + 1) + phi * np.log(phi / (phi + mu))
            + x * np.log(mu / (phi + mu))).sum(-1)
    got = T.nb_log_likelihood(*(torch.from_numpy(v[k]) for k in ("x", "mu", "log_phi")),
                              exact_lgamma=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _grad_dict(tree, module=None):
    flat = {"params/" + k: np.asarray(a) for k, a in flatten_dict(tree, sep="/").items()}
    return flat


@pytest.fixture(scope="module")
def iaf():
    rng = np.random.default_rng(1)
    x = rng.poisson(2.0, (24, 40)).astype(np.float32)
    enc = jenc.IafSoftmaxEncoder(n_topics=4, layers=(16, 8), n_flows=2)
    variables = enc.init({"params": jax.random.key(0), "reparam": jax.random.key(1)},
                         jnp.asarray(x), train=False)
    port = tenc.IafSoftmaxEncoder(40, 4, (16, 8), n_flows=2)
    port.load_state_dict(iaf_params_from_jax(
        {k: np.asarray(a) for k, a in flatten_dict(variables, sep="/").items()}))
    return x, enc, variables, port


def test_iaf_encoder_forward_equals_jax(iaf):
    x, enc, variables, port = iaf
    log_z, kl = enc.apply(variables, jnp.asarray(x), train=False)
    got_z, got_kl = port(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got_z.detach().numpy(), np.asarray(log_z), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_kl.detach().numpy(), np.asarray(kl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.exp(got_z.detach().numpy()).sum(-1), 1.0, rtol=1e-5)


def test_iaf_encoder_gradients_equal_jax(iaf):
    x, enc, variables, port = iaf
    w = np.random.default_rng(2).normal(size=(24, 4)).astype(np.float32)

    def loss(params):
        log_z, kl = enc.apply({**variables, "params": params}, jnp.asarray(x), train=False)
        return jnp.sum(log_z * w) + jnp.sum(kl)

    grads = iaf_params_from_jax(_grad_dict(jax.grad(loss)(variables["params"])))
    port.zero_grad()
    log_z, kl = port(torch.from_numpy(x), train=False)
    (torch.sum(log_z * torch.from_numpy(w)) + torch.sum(kl)).backward()
    got = dict(port.named_parameters())
    assert set(grads) == set(got)
    for name, g in grads.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-3), err_msg=name)


def test_iaf_encoder_training_draw_follows_its_generator(iaf):
    x, _, _, port = iaf
    runs = [port(torch.from_numpy(x), train=True,
                 generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(runs[0][0], runs[1][0]) and not torch.equal(runs[0][0], runs[2][0])
    assert torch.isfinite(runs[0][1]).all()
    np.testing.assert_allclose(runs[0][0].exp().sum(-1).detach().numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("likelihood", ["block", "symmetric", "poisson"])
def test_bipartite_decoder_equals_jax(likelihood):
    rng = np.random.default_rng(1)
    n, d, k = 12, 20, 4
    log_z = np.log(rng.dirichlet(np.ones(k), n) + 1e-9).astype(np.float32)
    x = rng.poisson(1.0, (n, d)).astype(np.float32)
    fw = rng.uniform(0.5, 1.5, d).astype(np.float32)
    dec = jdec.BipartiteDecoder(n_features=d, n_topics=k, likelihood=likelihood)
    variables = dec.init(jax.random.key(0), jnp.asarray(log_z), jnp.asarray(x))
    port = tdec.BipartiteDecoder(d, k, likelihood)
    port.load_state_dict(bipartite_params_from_jax(_grad_dict(variables["params"])))

    def loss(params):
        s, ll = dec.apply({"params": params}, jnp.asarray(log_z), jnp.asarray(x), fw)
        return jnp.sum(ll) + 0.1 * jnp.sum(s), (s, ll)

    (_, (scores, llik)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    s, ll = port(torch.from_numpy(log_z), torch.from_numpy(x), torch.from_numpy(fw))
    (torch.sum(ll) + 0.1 * torch.sum(s)).backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(scores), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(llik), rtol=1e-5, atol=1e-5)
    for name, g in bipartite_params_from_jax(_grad_dict(grads)).items():
        g = g.numpy()
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
    np.testing.assert_array_equal(port.get_dictionary().detach().numpy(),
                                  np.asarray(variables["params"]["feature"]).T)


def test_parameter_carriers_refuse_unknown_names():
    with pytest.raises(KeyError):
        iaf_params_from_jax({"params/iaf0/w_ar/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        bipartite_params_from_jax({"params/dictionary": np.zeros((2, 2))})
    with pytest.raises(ValueError):
        tdec.BipartiteDecoder(4, 2, "gaussian")


def test_project_simplex_equals_jax():
    from legume_tpu.ops.archetypal import _project_simplex as j_project

    v = np.random.default_rng(4).normal(0, 1, (50, 7)).astype(np.float32)
    v[:5] = 0.25  # ties
    got = _project_simplex(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_project(jnp.asarray(v))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def corners():
    rng = np.random.default_rng(3)
    c = np.asarray([[0, 0], [4, 0], [0, 4]], np.float32)
    w = rng.dirichlet(np.ones(3) * 0.4, size=400).astype(np.float32)
    return c, w @ c + rng.normal(0, 0.05, (400, 2)).astype(np.float32)


def test_fit_archetypes_equals_jax(corners):
    _, x = corners
    got = t_fit_archetypes(x, 3, n_iter=50, seed=0, device="cpu")
    want = j_fit_archetypes(x, 3, n_iter=50, seed=0)
    for g, w, name in zip(got, want, "ZAB"):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)


def test_fit_archetypes_recovers_corners(corners):
    c, x = corners
    z, a, b = t_fit_archetypes(x, 3, n_iter=400, seed=0, device="cpu")
    np.testing.assert_allclose(a.sum(1), 1.0, atol=1e-4)
    np.testing.assert_allclose(b.sum(1), 1.0, atol=1e-4)
    for corner in c:
        assert np.min(np.linalg.norm(z - corner, axis=1)) < 0.8, (z, corner)
