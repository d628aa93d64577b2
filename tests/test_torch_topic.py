"""`senna topic` end to end through both packages on the same two zarr
backends (one batch each), port on the CPU: the partitions are equal,
the collapse planes agree within 1e-5, the final per-count llik lies in
the ELBO band of the JAX trainer, and a model saved by either package
loads in the other."""

import json

import numpy as np
import pytest
import torch

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.senna import topic as jtopic
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.senna import topic as ttopic

EPOCHS = 8
COMMON = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=EPOCHS, block_size=256)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("topic")
    sim = simulate_topic(rows=200, cols=600, factors=4, batches=2, seed=17)
    files = []
    for b in range(2):
        cols = np.nonzero(sim.batch == b)[0]
        path = str(tmp / f"b{b}.zarr")
        create_sparse_from_csc(
            sim.counts[:, cols], path, sim.row_names, [sim.col_names[j] for j in cols]
        )
        files.append(path)
    jres = jtopic.fit_topic_model(jtopic.TopicArgs(data_files=files, out=str(tmp / "jax"), **COMMON))
    tres = ttopic.fit_topic_model(
        ttopic.TopicArgs(data_files=files, out=str(tmp / "port"), **COMMON), device="cpu"
    )
    return dict(tmp=tmp, files=files, j=jres, t=tres)


def test_partitions_equal(runs):
    jl, tl = runs["j"]["levels"], runs["t"]["levels"]
    np.testing.assert_array_equal(tl.fine_codes, jl.fine_codes)
    assert tl.num_groups_per_level == jl.num_groups_per_level
    for tg, jg in zip(tl.groups_per_level, jl.groups_per_level):
        np.testing.assert_array_equal(tg, jg)
    for tm, jm in zip(tl.level_maps, jl.level_maps):
        np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tl.proj_kn, jl.proj_kn, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("plane", ["mu_observed", "mu_adjusted", "mu_residual", "gamma", "delta"])
def test_collapse_planes_within_1e5(runs, plane):
    for jo, to in zip(runs["j"]["levels"].collapsed, runs["t"]["levels"].collapsed):
        jp, tp = getattr(jo, plane), getattr(to, plane)
        np.testing.assert_allclose(tp.a.numpy(), np.asarray(jp.a), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b), rtol=1e-5, atol=1e-5)


def test_llik_within_elbo_band(runs):
    jl = np.asarray(runs["j"]["scores"].llik)
    tl = np.asarray(runs["t"]["scores"].llik)
    assert len(tl) == len(jl) == EPOCHS and np.isfinite(tl).all()
    rel = abs(tl[-1] - jl[-1]) / abs(jl[-1])
    assert rel < 0.02, (tl[-1], jl[-1], rel)
    z = runs["t"]["latent"]
    assert z.shape == (600, 4)
    np.testing.assert_allclose(np.exp(z).sum(1), 1.0, atol=1e-5)


def _jax_encode(variables, x, null):
    from legume_tpu.models.encoders import LogSoftmaxEncoder

    enc = LogSoftmaxEncoder(n_topics=4, layers=(32, 16))
    ev = {"params": variables["params"]["encoder"], "batch_stats": variables["batch_stats"]["encoder"]}
    return np.asarray(enc.apply(ev, x, null, train=False)[0])


def test_port_model_loads_in_jax(runs):
    meta, variables, genes = jtopic.load_model(str(runs["tmp"] / "port"))
    assert meta["n_features"] == 200 and len(genes) == 200
    lvl = runs["t"]["level_data"][0]
    want = runs["t"]["trainer"].encode(lvl.input, lvl.input_null)
    np.testing.assert_allclose(_jax_encode(variables, lvl.input, lvl.input_null), want,
                               rtol=1e-4, atol=1e-5)


def test_jax_model_loads_in_port(runs):
    prefix = str(runs["tmp"] / "jax")
    meta, flat, _ = ttopic.load_model(prefix)
    encoder, decoders = ttopic.build_model(meta, flat, device="cpu")
    assert len(decoders) == 3
    _, variables, _ = jtopic.load_model(prefix)
    rng = np.random.default_rng(0)
    x = rng.poisson(1.0, (20, 200)).astype(np.float32)
    null = rng.uniform(0.5, 2.0, (20, 200)).astype(np.float32)
    with torch.no_grad():
        got = encoder(torch.from_numpy(x), torch.from_numpy(null), train=False)[0].numpy()
    np.testing.assert_allclose(got, _jax_encode(variables, x, null), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        decoders[0].get_dictionary().detach().numpy(), runs["j"]["log_beta"], rtol=1e-5, atol=1e-6
    )


def test_cli_runs_and_rejects_unported_options(runs, tmp_path):
    out = str(tmp_path / "cli")
    argv = ["senna", "topic", "--data-files", *runs["files"], "--out", out, "-k", "3",
            "--encoder-layers", "16", "8", "--epochs", "2", "--num-levels", "2", "--device", "cpu"]
    assert port_cli(argv) == 0
    for suffix in ("model.npz", "model.json", "partition.npz", "senna.json"):
        assert (tmp_path / f"cli.{suffix}").exists()
    # --qc with its thresholds and the other decoder families run (the
    # cells preloaded: the matched statistics' reads from zarr are slow)
    assert port_cli(argv + ["--qc", "--qc-min-total", "500", "--qc-min-genes", "20",
                            "--qc-max-mito-frac", "0.2", "--out", out + "_qc",
                            "--preload-data"]) == 0
    assert (tmp_path / "cli_qc.senna.json").exists()
    assert port_cli(argv + ["--decoder", "multinomial", "--out", out + "_mn",
                            "--preload-data"]) == 0
    assert json.loads((tmp_path / "cli_mn.model.json").read_text())["decoder"] == "multinomial"
    # what stays off: data parallelism (the CNV side channel runs:
    # tests/test_torch_cnv.py); the vae decoder runs (tests/test_torch_vae.py)
    with pytest.raises(NotImplementedError, match="--data-parallel"):
        port_cli(argv + ["--data-parallel"])
    assert port_cli(argv + ["--decoder", "gaussian-nb", "--out", out + "_gnb",
                            "--preload-data"]) == 0
    assert json.loads((tmp_path / "cli_gnb.model.json").read_text())["decoder"] == "gaussian-nb"
    # the JAX parser's flags pass through to `TopicArgs` (rho prior: no
    # effect on the nb decoder, as in the JAX package)
    flags = {"--rho-prior-weight": 0.1, "--rho-prior-alpha": 3.0, "--rho-prior-beta": 12.0,
             "--amort-refine-steps": 2, "--amort-refine-lr": 0.02, "--amort-refine-reg": 0.5}
    assert port_cli(argv + [str(x) for kv in flags.items() for x in kv]) == 0
    params = json.loads((tmp_path / "cli.senna.json").read_text())["params"]
    for flag, value in flags.items():
        assert params[flag[2:].replace("-", "_")] == value


def test_manifest_artifacts_match_jax(runs):
    docs = {name: json.loads((runs["tmp"] / f"{name}.senna.json").read_text())
            for name in ("jax", "port")}
    assert docs["port"]["artifacts"] == docs["jax"]["artifacts"]
    assert set(docs["port"]["artifacts"]) == {"latent", "pb_latent", "dictionary", "partition"}
    for name, art in docs["port"]["artifacts"].items():
        assert docs["port"]["outputs"][name].endswith((".parquet", ".npz"))


def test_ignore_batch_partitions_and_elbo_band(runs):
    """`--ignore-batch`: rSVD sign bits are arbitrary in both packages, so
    the fine groups agree as a set partition (not by code), and the
    levels above them, refined in code order, are held to the ELBO band."""
    kw = dict(COMMON, ignore_batch=True)
    jres = jtopic.fit_topic_model(jtopic.TopicArgs(data_files=runs["files"],
                                                   out=str(runs["tmp"] / "jax_ib"), **kw))
    tres = ttopic.fit_topic_model(ttopic.TopicArgs(data_files=runs["files"],
                                                   out=str(runs["tmp"] / "port_ib"), **kw),
                                  device="cpu")
    jg, tg = jres["levels"].groups_per_level[0], tres["levels"].groups_per_level[0]
    pairs = np.unique(np.stack([jg, tg], 1), axis=0)
    assert len(pairs) == len(np.unique(jg)) == len(np.unique(tg))  # a bijection of groups
    jl = np.asarray(jres["scores"].llik)
    tl = np.asarray(tres["scores"].llik)
    assert len(tl) == EPOCHS and np.isfinite(tl).all()
    assert abs(tl[-1] - jl[-1]) / abs(jl[-1]) < 0.02, (tl[-1], jl[-1])
