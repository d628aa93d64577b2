"""The port's encoder, NB decoder, loss, optimizer step and BatchNorm
against the flax/optax modules of the JAX package with the same weights
and inputs (reparameterisation noise off)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from legume_tpu.models import losses as jlosses
from legume_tpu.models.decoders import NbTopicDecoder as JDecoder
from legume_tpu.models.encoders import LogSoftmaxEncoder as JEncoder
from legume_tpu.models.train import LevelData as JLevel
from legume_tpu.models.train import MixedTrainer as JTrainer
from legume_tpu.models.train import TrainConfig as JConfig
from legume_tpu.models.train import make_optimizer
from legume_tpu_torch.models import losses as tlosses
from legume_tpu_torch.models.convert import params_from_jax, params_to_jax
from legume_tpu_torch.models.decoders import NbTopicDecoder
from legume_tpu_torch.models.encoders import LogSoftmaxEncoder
from legume_tpu_torch.models.train import MixedTrainer, TrainConfig
from legume_tpu_torch.ops.transforms import anscombe_residual

D, K, LAYERS, MB = 40, 5, (24, 16), 12
SMOOTH = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.poisson(2.0, (MB, D)).astype(np.float32)
    null = rng.uniform(0.5, 2.0, (MB, D)).astype(np.float32)
    fw = rng.uniform(0.2, 1.0, D).astype(np.float32)
    w = np.ones(MB, np.float32)
    w[-2:] = 0.0  # padded rows
    enc, dec = JEncoder(n_topics=K, layers=LAYERS), JDecoder(n_features=D, n_topics=K)
    jt = JTrainer(enc, [dec, JDecoder(n_features=D, n_topics=K)], JConfig(minibatch_size=MB))
    params, bstats, _ = jt.init([JLevel(x, null), JLevel(x, null)], jax.random.key(1))
    # non-trivial running stats, so eval mode reads something
    bstats = jax.tree.map(lambda a: a + 0.3, bstats)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        {"params": params, "batch_stats": bstats}, sep="/").items()}
    return dict(x=x, null=null, fw=fw, w=w, enc=enc, dec=dec, params=params, bstats=bstats, flat=flat)


def _port_models(flat):
    enc_state, dec_states = params_from_jax(flat)
    enc = LogSoftmaxEncoder(D, K, LAYERS)
    enc.load_state_dict(enc_state)
    decs = []
    for st in dec_states:
        dec = NbTopicDecoder(D, K)
        dec.load_state_dict(st)
        decs.append(dec)
    return enc, decs


def test_params_round_trip(setup):
    enc, decs = _port_models(setup["flat"])
    back = params_to_jax(enc.state_dict(), [d.state_dict() for d in decs])
    assert set(back) == set(setup["flat"])
    for k, v in setup["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    w = enc.state_dict()["trunk.fc.0.weight"].numpy()
    np.testing.assert_array_equal(w, setup["flat"]["params/encoder/trunk/fc0/kernel"].T)


@pytest.mark.parametrize("train", [False, True])
def test_encoder_heads_match(setup, train):
    s = setup
    jvars = {"params": s["params"]["encoder"], "batch_stats": s["bstats"]["encoder"]}
    kw = dict(train=train, method="latent_gaussian_params")
    if train:
        (jm, jl), _ = s["enc"].apply(jvars, s["x"], s["null"], mutable=["batch_stats"], **kw)
    else:
        jm, jl = s["enc"].apply(jvars, s["x"], s["null"], **kw)
    enc, _ = _port_models(s["flat"])
    with torch.no_grad():
        tm, tl = enc.latent_gaussian_params(
            torch.from_numpy(s["x"]), torch.from_numpy(s["null"]), train=train
        )
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_anscombe_residual_matches(setup):
    from legume_tpu.ops.transforms import anscombe_residual as j_ar

    want = np.asarray(j_ar(setup["x"], setup["null"]))
    got = anscombe_residual(torch.from_numpy(setup["x"]), torch.from_numpy(setup["null"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_nb_decoder_llik_matches(setup):
    s = setup
    rng = np.random.default_rng(3)
    log_z = np.log(rng.dirichlet(np.ones(K), MB)).astype(np.float32)
    jr, jl = s["dec"].apply({"params": s["params"]["decoder_0"]}, log_z, s["x"], s["fw"][None, :])
    _, decs = _port_models(s["flat"])
    with torch.no_grad():
        tr, tl = decs[0](torch.from_numpy(log_z), torch.from_numpy(s["x"]),
                         torch.from_numpy(s["fw"])[None, :])
        np.testing.assert_allclose(decs[0].get_dictionary().numpy(),
                                   np.asarray(s["dec"].apply({"params": s["params"]["decoder_0"]},
                                                             method="get_dictionary")), rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_loss_terms_match():
    rng = np.random.default_rng(5)
    x = rng.poisson(3.0, (7, 9)).astype(np.float32)
    mu = rng.uniform(0.1, 9.0, (7, 9)).astype(np.float32)
    lp = rng.normal(0, 1, (1, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.nb_log_likelihood_elem(torch.from_numpy(x), torch.from_numpy(mu), torch.from_numpy(lp)).numpy(),
        np.asarray(jlosses.nb_log_likelihood_elem(x, mu, lp)), rtol=1e-5, atol=1e-5,
    )
    m, v = rng.normal(size=(7, 4)).astype(np.float32), rng.normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.gaussian_kl(torch.from_numpy(m), torch.from_numpy(v)).numpy(),
        np.asarray(jlosses.gaussian_kl(m, v)), rtol=1e-6,
    )
    lz = np.log(rng.dirichlet(np.ones(4), 7)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.smooth_topics(torch.from_numpy(lz), 0.01).numpy(),
        np.asarray(jlosses.smooth_topics(lz, 0.01)), rtol=1e-6,
    )
    np.testing.assert_allclose(
        tlosses.approx_lgamma(torch.from_numpy(mu)).numpy(), np.asarray(jlosses.approx_lgamma(mu)),
        rtol=1e-5, atol=1e-5,
    )


def _jax_loss(s, level=0):
    """The JAX trainer's minibatch loss with z = mean (noise off)."""
    enc, dec = s["enc"], s["dec"]

    def loss_fn(params, bstats):
        (mean, lnvar), mut = enc.apply(
            {"params": params["encoder"], "batch_stats": bstats["encoder"]},
            s["x"], s["null"], train=True, method="latent_gaussian_params", mutable=["batch_stats"],
        )
        log_z = jlosses.smooth_topics(jax.nn.log_softmax(mean, axis=-1), SMOOTH)
        kl = jlosses.gaussian_kl(mean, lnvar)
        _, llik = dec.apply({"params": params[f"decoder_{level}"]}, log_z, s["x"], s["fw"][None, :])
        loss = jnp.sum((kl - llik) * s["w"]) / jnp.maximum(jnp.sum(s["w"]), 1.0)
        return loss, {"encoder": mut["batch_stats"]}

    return loss_fn


def _port_trainer(s):
    enc, decs = _port_models(s["flat"])
    cfg = TrainConfig(minibatch_size=MB, learning_rate=0.01, topic_smoothing=SMOOTH, grad_clip=1.0)
    return MixedTrainer(enc, decs, cfg, feature_weights=[s["fw"], s["fw"]], device="cpu")


def _flat_grads(tr):
    g = lambda p: torch.zeros_like(p) if p.grad is None else p.grad  # noqa: E731
    return params_to_jax(
        {k: g(p) for k, p in tr.encoder.named_parameters()},
        [{k: g(p) for k, p in d.named_parameters()} for d in tr.decoders],
    )


def test_minibatch_loss_and_grads_match(setup):
    s = setup
    (jloss, _), jgrads = jax.value_and_grad(_jax_loss(s), has_aux=True)(s["params"], s["bstats"])
    tr = _port_trainer(s)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    loss, *_ = tr.minibatch_loss(0, t(s["x"]), t(s["null"]), t(s["x"]), t(s["w"]), torch.zeros(MB, K))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    got = _flat_grads(tr)
    want = traverse_util.flatten_dict({"params": jgrads}, sep="/")
    for name, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[name], g, rtol=1e-5, atol=1e-5 * max(np.abs(g).max(), 1e-3),
                                   err_msg=name)


def test_three_steps_params_and_batchnorm_stats(setup):
    s = setup
    opt = make_optimizer(JConfig(learning_rate=0.01, grad_clip=1.0))
    params, bstats = s["params"], s["bstats"]
    state = opt.init(params)
    grad_fn = jax.value_and_grad(_jax_loss(s), has_aux=True)
    tr = _port_trainer(s)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    for _ in range(3):
        (_, bstats), g = grad_fn(params, bstats)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        loss, *_ = tr.minibatch_loss(0, t(s["x"]), t(s["null"]), t(s["x"]), t(s["w"]), torch.zeros(MB, K))
        loss.backward()
        tr._clip_and_step()
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        {"params": params, "batch_stats": bstats}, sep="/").items()}
    got = params_to_jax(tr.encoder.state_dict(), [d.state_dict() for d in tr.decoders])
    for name in ("batch_stats/encoder/trunk/bn_z/mean", "batch_stats/encoder/trunk/bn_z/var"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6, err_msg=name)
    for name, v in want.items():  # the idle decoder moves by weight decay too
        np.testing.assert_allclose(got[name], v, rtol=1e-4, atol=1e-5, err_msg=name)


def test_nonfinite_gradient_skips_the_step(setup):
    tr = _port_trainer(setup)
    before = [p.detach().clone() for p in tr.params]
    for p in tr.params:
        p.grad = torch.full_like(p, float("nan"))
    tr._clip_and_step()
    for p, b in zip(tr.params, before):
        assert torch.isfinite(p).all()
        # zero gradient: AdamW moves only by weight decay
        np.testing.assert_allclose(p.detach().numpy(), (b * (1 - 0.01 * 0.01)).numpy(), rtol=1e-6)
