"""`senna vae` and `senna topic --decoder gaussian-nb` through both
packages, port on the CPU: the Gaussian encoder and the gaussian-nb
decoder at the same parameters, the weights across in both directions,
the fit's final llik in the band of the JAX package's seeds, predict of
either package's vae model in the other, and the commands' artifacts."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.models.decoders import GaussianNbDecoder as JDecoder
from legume_tpu.models.encoders import GaussianEncoder as JEncoder
from legume_tpu.models.train import LevelData as JLevel
from legume_tpu.models.train import MixedTrainer as JTrainer
from legume_tpu.models.train import TrainConfig as JConfig
from legume_tpu.senna import predict as jpred
from legume_tpu.senna import topic as jtopic
from legume_tpu.senna import vae as jvae
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.models.convert import params_from_jax, params_to_jax
from legume_tpu_torch.models.decoders import GaussianNbDecoder
from legume_tpu_torch.models.encoders import GaussianEncoder
from legume_tpu_torch.senna import predict as tpred
from legume_tpu_torch.senna import topic as ttopic
from legume_tpu_torch.senna import vae as tvae
from legume_tpu_torch.utils.output import read_table

D, H, LAYERS, MB = 30, 4, (12, 8), 10
FIT = dict(n_latent=4, encoder_layers=(16, 8), epochs=6, minibatch_size=40, block_size=128,
           sort_dim=6)


@pytest.fixture(scope="module")
def modules():
    rng = np.random.default_rng(0)
    x = rng.poisson(2.0, (MB, D)).astype(np.float32)
    null = rng.uniform(0.5, 2.0, (MB, D)).astype(np.float32)
    enc, dec = JEncoder(n_latent=H, layers=LAYERS), JDecoder(n_features=D, n_topics=H)
    jt = JTrainer(enc, [dec, JDecoder(n_features=D, n_topics=H)], JConfig(minibatch_size=MB))
    params, bstats, _ = jt.init([JLevel(x, null), JLevel(x, null)], jax.random.key(1))
    bstats = jax.tree.map(lambda a: a + 0.3, bstats)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        {"params": params, "batch_stats": bstats}, sep="/").items()}
    enc_state, dec_states = params_from_jax(flat)
    tenc = GaussianEncoder(D, H, LAYERS)
    tenc.load_state_dict(enc_state)
    tdecs = []
    for st in dec_states:
        tdecs.append(GaussianNbDecoder(D, H))
        tdecs[-1].load_state_dict(st)
    return dict(x=x, null=null, enc=enc, dec=dec, params=params, bstats=bstats, flat=flat,
                tenc=tenc, tdecs=tdecs)


def test_vae_params_round_trip(modules):
    m = modules
    back = params_to_jax(m["tenc"].state_dict(), [d.state_dict() for d in m["tdecs"]])
    assert set(back) == set(m["flat"])
    assert "params/decoder_1/dictionary/kernel" in back
    for k, v in m["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_gaussian_encoder_matches_jax(modules, train):
    m = modules
    jvars = {"params": m["params"]["encoder"], "batch_stats": m["bstats"]["encoder"]}
    kw = dict(mutable=["batch_stats"]) if train else {}
    out = m["enc"].apply(jvars, m["x"], m["null"], train=False, **kw) if not train else \
        m["enc"].apply(jvars, m["x"], m["null"], train=True, rngs={"reparam": jax.random.key(0)},
                       method="latent_gaussian_params", **kw)[0]
    x, null = torch.from_numpy(m["x"]), torch.from_numpy(m["null"])
    with torch.no_grad():
        got = (m["tenc"](x, null, train=False) if not train
               else m["tenc"].latent_gaussian_params(x, null, train=True))
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gaussian_nb_decoder_matches_jax(modules):
    m = modules
    z = np.random.default_rng(1).standard_normal((MB, H)).astype(np.float32)
    fw = np.random.default_rng(2).uniform(0.2, 1.0, D).astype(np.float32)[None]
    recon, llik = m["dec"].apply({"params": m["params"]["decoder_0"]}, z, m["x"], fw)
    with torch.no_grad():
        tr, tl = m["tdecs"][0](torch.from_numpy(z), torch.from_numpy(m["x"]), torch.from_numpy(fw))
    np.testing.assert_allclose(tr.numpy(), np.asarray(recon), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(llik), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(m["tdecs"][0].get_dictionary().detach().numpy(),
                                  np.asarray(m["params"]["decoder_0"]["dictionary"]["kernel"]).T)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vae")
    sim = simulate_topic(rows=120, cols=360, factors=4, batches=1, seed=21)
    path = str(tmp / "train.zarr")
    create_sparse_from_csc(sim.counts, path, sim.row_names, sim.col_names)
    common = dict(data_files=[path], **FIT)
    jres = [jvae.fit_vae(jvae.VaeArgs(out=str(tmp / f"jax{s}"), seed=s, **common))
            for s in range(3)]
    tres = tvae.fit_vae(tvae.VaeArgs(out=str(tmp / "port"), seed=0, **common), device="cpu")
    held = simulate_topic(rows=120, cols=90, factors=4, batches=1, seed=22)
    hpath = str(tmp / "held.zarr")
    create_sparse_from_csc(held.counts, hpath, held.row_names, held.col_names)
    return dict(tmp=tmp, path=path, j=jres, t=tres, hpath=hpath)


def test_fit_vae_llik_in_jax_band(runs):
    """The final per-count llik within the JAX package's mean over seeds
    0-2 +- twice their spread (max - min)."""
    jl = [r["scores"].llik[-1] for r in runs["j"]]
    tl = np.asarray(runs["t"]["scores"].llik)
    assert len(tl) == FIT["epochs"] and np.isfinite(tl).all() and tl[-1] > tl[0]
    spread = max(jl) - min(jl)
    print("vae band: jax", jl, "spread", spread, "port", tl[-1])
    assert abs(tl[-1] - np.mean(jl)) <= 2 * spread, (tl[-1], jl)
    z = runs["t"]["latent"]
    assert z.shape == (360, 4) and np.isfinite(z).all()


def test_vae_artifacts_match_jax(runs):
    tmp = runs["tmp"]
    for name in ("latent", "loadings", "log_likelihood"):
        assert list(read_table(str(tmp / f"port.{name}.parquet"))) == \
            list(read_table(str(tmp / f"jax0.{name}.parquet")))
    jm = json.loads((tmp / "jax0.model.json").read_text())
    tm = json.loads((tmp / "port.model.json").read_text())
    assert tm == {**jm, "gene_names_file": tm["gene_names_file"]}
    assert set(np.load(str(tmp / "port.model.npz")).files) == \
        set(np.load(str(tmp / "jax0.model.npz")).files)
    doc = json.loads((tmp / "port.senna.json").read_text())
    assert doc["command"] == "vae" and set(doc["outputs"]) == {"latent", "loadings",
                                                               "log_likelihood"}


@pytest.mark.parametrize("owner", ["jax0", "port"])
def test_vae_model_predicts_alike_in_both(runs, owner):
    """Each package's vae model: the port's predict within 1e-4 of JAX's."""
    model = str(runs["tmp"] / owner)
    got = tpred.predict_model(tpred.PredictArgs(data_files=[runs["hpath"]], model=model,
                                                out=model + "_tp"), device="cpu")
    want = jpred.predict_model(jpred.PredictArgs(data_files=[runs["hpath"]], model=model,
                                                 out=model + "_jp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert list(read_table(model + "_tp.latent.parquet"))[1] == "z0"


def test_vae_cli_from_init_from_and_data_parallel(runs, tmp_path):
    out = str(tmp_path / "cli")
    base = ["senna", "vae", "--out", out, "-k", "4", "--encoder-layers", "16", "8",
            "--epochs", "2", "--minibatch-size", "40", "--block-size", "128", "--sort-dim", "6",
            "--device", "cpu"]
    # --from inherits the data files; --init-from the port run's weights
    assert port_cli(base + ["--from", str(runs["tmp"] / "port"),
                            "--init-from", str(runs["tmp"] / "port"), "--qc",
                            "--qc-min-total", "10"]) == 0
    assert json.loads(open(out + ".senna.json").read())["inputs"]["data_files"] == [runs["path"]]
    with pytest.raises(ValueError, match="architecture mismatch"):
        port_cli(base + ["--data-files", runs["path"], "-k", "5",
                         "--init-from", str(runs["tmp"] / "jax0")])
    with pytest.raises(NotImplementedError, match="--data-parallel"):
        port_cli(base + ["--data-files", runs["path"], "--data-parallel"])


def test_topic_gaussian_nb_model_loads_in_both(runs, tmp_path):
    """`senna topic --decoder gaussian-nb`: the port's model loads in
    JAX and encodes alike; JAX's (with its unused anchor logits) builds
    in the port."""
    common = dict(data_files=[runs["path"]], n_latent_topics=4, encoder_layers=(16, 8), epochs=2,
                  block_size=128, num_levels=2, sort_dim=6, decoder="gaussian-nb")
    tres = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "t"), **common),
                                  device="cpu")
    jtopic.fit_topic_model(jtopic.TopicArgs(out=str(tmp_path / "j"), **common))
    assert np.isfinite(tres["scores"].llik).all()
    meta, variables, _ = jtopic.load_model(str(tmp_path / "t"))
    assert meta["decoder"] == "gaussian-nb"
    lvl = tres["level_data"][0]
    from legume_tpu.models.encoders import LogSoftmaxEncoder

    ev = {"params": variables["params"]["encoder"],
          "batch_stats": variables["batch_stats"]["encoder"]}
    want = np.asarray(LogSoftmaxEncoder(n_topics=4, layers=(16, 8)).apply(
        ev, jnp.asarray(lvl.input), None, train=False)[0])
    np.testing.assert_allclose(tres["trainer"].encode(lvl.input), want, rtol=1e-4, atol=1e-5)
    meta, flat, _ = ttopic.load_model(str(tmp_path / "j"))
    _, decs = ttopic.build_model(meta, flat, device="cpu")
    assert isinstance(decs[0], GaussianNbDecoder)
    np.testing.assert_array_equal(decs[0].dictionary.kernel.detach().numpy(),
                                  flat["params/decoder_0/dictionary/kernel"])
