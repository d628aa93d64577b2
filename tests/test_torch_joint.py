"""`senna joint-topic` through both packages, port on the CPU: the joint
encoder and the delta decoder at the same parameters, the weights across
in both directions (per-modality decoder lists and the delta decoder),
the nb and delta fits' final llik in the band of the JAX package's
seeds, and the command's artifacts."""

import jax
import numpy as np
import pytest
import torch

from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.models.decoders import DeltaTopicDecoder as JDelta
from legume_tpu.models.decoders import NbTopicDecoder as JNb
from legume_tpu.models.encoders import LogSoftmaxJointEncoder as JJoint
from legume_tpu.models.train import LevelData as JLevel
from legume_tpu.models.train import MixedTrainer as JTrainer
from legume_tpu.models.train import TrainConfig as JConfig
from legume_tpu.senna import joint as jjoint
from legume_tpu_torch.cli.main import run_senna
from legume_tpu_torch.data import MemoryBackend
from legume_tpu_torch.data.sim import simulate_multimodal
from legume_tpu_torch.models.convert import params_from_jax, params_to_jax
from legume_tpu_torch.models.decoders import DeltaTopicDecoder, NbTopicDecoder
from legume_tpu_torch.models.encoders import LogSoftmaxJointEncoder
from legume_tpu_torch.senna import joint as tjoint
from legume_tpu_torch.utils.output import read_table

DIMS, K, LAYERS, MB = (20, 12), 4, (10, 6), 8


def _flat(tree, prefix=""):
    """flax's `flatten_dict(sep="/")`, with a list's items under `/{j}/`."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _jax_setup(delta: bool):
    rng = np.random.default_rng(1)
    dims = (DIMS[0], DIMS[0]) if delta else DIMS
    x = rng.poisson(2.0, (MB, sum(dims))).astype(np.float32)
    enc = JJoint(n_topics=K, layers=LAYERS, n_features=dims)
    decs = [JDelta(n_features=dims[0], n_topics=K)] if delta else \
        [[JNb(n_features=d, n_topics=K) for d in dims]]
    jt = JTrainer(enc, decs, JConfig(minibatch_size=MB))
    if not delta:
        jt.target_slices = [(0, dims[0]), (dims[0], sum(dims))]
    params, bstats, _ = jt.init([JLevel(x, None)], jax.random.key(2))
    bstats = jax.tree.map(lambda a: a + 0.25, bstats)
    # a delta that is not zero, so that the chain shows
    if delta:
        params["decoder_0"] = {**params["decoder_0"],
                               "delta_1": rng.normal(0, 0.3, (K, dims[0])).astype(np.float32)}
    flat = _flat({"params": params, "batch_stats": bstats})
    enc_state, dec_states = params_from_jax(flat)
    tenc = LogSoftmaxJointEncoder(dims, K, LAYERS)
    tenc.load_state_dict(enc_state)
    if delta:
        tdec = DeltaTopicDecoder(dims[0], K, 2)
        tdec.load_state_dict(dec_states[0])
        tdecs = [tdec]
    else:
        tdecs = []
        for d, st in zip(dims, dec_states[0]):
            tdecs.append(NbTopicDecoder(d, K))
            tdecs[-1].load_state_dict(st)
    return dict(x=x, enc=enc, decs=decs, params=params, bstats=bstats, flat=flat, tenc=tenc,
                tdecs=tdecs, dims=dims)


@pytest.mark.parametrize("delta", [False, True])
def test_joint_params_round_trip(delta):
    s = _jax_setup(delta)
    states = [s["tdecs"][0].state_dict()] if delta else [[d.state_dict() for d in s["tdecs"]]]
    back = params_to_jax(s["tenc"].state_dict(), states)
    assert set(back) == set(s["flat"])
    assert "params/encoder/mod1/fc0/kernel" in back
    for k, v in s["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_joint_encoder_matches_jax(train):
    s = _jax_setup(False)
    jvars = {"params": s["params"]["encoder"], "batch_stats": s["bstats"]["encoder"]}
    x = torch.from_numpy(s["x"])
    kw = dict(mutable=["batch_stats"]) if train else {}
    jm = s["enc"].apply(jvars, s["x"], train=train, method="latent_gaussian_params", **kw)
    jm = jm[0] if train else jm
    with torch.no_grad():
        tm = s["tenc"].latent_gaussian_params(x, train=train)
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if not train:
        jz, jkl = s["enc"].apply(jvars, s["x"], train=False)
        with torch.no_grad():
            tz, tkl = s["tenc"](x, train=False)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), rtol=1e-5, atol=1e-5)


def test_delta_decoder_matches_jax():
    s = _jax_setup(True)
    log_z = np.log(np.random.default_rng(3).dirichlet(np.ones(K), MB)).astype(np.float32)
    recon, llik = s["decs"][0].apply({"params": s["params"]["decoder_0"]}, log_z, s["x"])
    with torch.no_grad():
        tr, tl = s["tdecs"][0](torch.from_numpy(log_z), torch.from_numpy(s["x"]))
    np.testing.assert_allclose(tr.numpy(), np.asarray(recon), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(llik), rtol=1e-5, atol=1e-4)
    want = s["decs"][0].apply({"params": s["params"]["decoder_0"]}, method="get_dictionary")
    np.testing.assert_allclose(s["tdecs"][0].get_dictionary().detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


FIT = dict(n_topics=4, encoder_layers=(16, 8), epochs=6, minibatch_size=20, sort_dim=5,
           iter_opt=10)


@pytest.mark.parametrize("decoder", ["nb", "delta"])
def test_fit_joint_topic_llik_in_jax_band(decoder):
    """The final per-count llik within the JAX package's mean over seeds
    0-2 +- twice their spread (max - min)."""
    rows = (60, 60) if decoder == "delta" else (60, 40)
    sim = simulate_multimodal(rows_per_modality=rows, cols=300, factors=4, seed=5)
    jl = [jjoint.fit_joint_topic([JMem(c) for c in sim.counts], jjoint.JointTopicArgs(
        decoder=decoder, seed=s, **FIT))["scores"].llik[-1] for s in range(3)]
    res = tjoint.fit_joint_topic([MemoryBackend(c) for c in sim.counts],
                                 tjoint.JointTopicArgs(decoder=decoder, seed=0, **FIT),
                                 device="cpu")
    tl = np.asarray(res["scores"].llik)
    assert np.isfinite(tl).all() and tl[-1] > tl[0]
    spread = max(jl) - min(jl)
    print(f"joint {decoder} band: jax", jl, "spread", spread, "port", tl[-1])
    assert abs(tl[-1] - np.mean(jl)) <= 2 * spread, (tl[-1], jl)
    np.testing.assert_allclose(res["pb_latent"].sum(1), 1.0, atol=1e-5)
    assert res["slices"] == [(0, rows[0]), (rows[0], sum(rows))]


def test_joint_topic_command_artifacts(tmp_path):
    sim = simulate_multimodal(rows_per_modality=(40, 30), cols=200, factors=3, seed=6)
    out = str(tmp_path / "jt")
    res = run_senna(["joint-topic", "--data-files", "a.zarr", "--data-files", "b.zarr",
                     "--out", out, "-k", "3", "--encoder-layers", "8", "--epochs", "2",
                     "--minibatch-size", "20", "--sort-dim", "4", "--decoder", "poisson",
                     "--decoder-weights", "1", "0.5", "--device", "cpu"],
                    vecs=[MemoryBackend(c) for c in sim.counts])
    lat = read_table(out + ".latent.parquet")
    pb = read_table(out + ".pb_latent.parquet")
    assert list(lat) == ["cell", "topic0", "topic1", "topic2"]
    assert list(pb) == ["pseudobulk", "topic0", "topic1", "topic2"]
    np.testing.assert_allclose(np.stack([lat[f"topic{j}"] for j in range(3)], 1),
                               res["pb_latent"][res["groups"]])
    assert (tmp_path / "jt.senna.json").exists()
