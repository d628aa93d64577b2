"""The port's `senna impute` and `senna probe` against the JAX package's on
the same inputs, on the CPU: imputed counts within 1e-4 (the port's kNN
is float64, JAX's float32; on log-proportion latents, whose norms make
JAX's float32 distances cancel, within a relative 5e-4), the latent
probe equal, the model probe's
flags equal and its fit scores and counterfactual within 1e-4, both
commands end to end on a topic model the port trained."""

import json

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.cli import main as jcli
from legume_tpu.data import sparse_io as jio
from legume_tpu.senna import impute as jimp
from legume_tpu.senna import probe as jprobe
from legume_tpu_torch.cli import main as tcli
from legume_tpu_torch.data import MemoryBackend
from legume_tpu_torch.senna import impute as timp
from legume_tpu_torch.senna import probe as tprobe


def _groups(seed=0, d=40, n=200):
    rng = np.random.default_rng(seed)
    group = np.arange(n) % 2
    rates = np.where(group[:, None] == 0, 5.0, 0.5) * np.ones((n, d))
    rates[:, : d // 2] = np.where(group[:, None] == 1, 5.0, 0.5)
    y = rng.poisson(rates).astype(np.float32)
    latent = np.stack([group + rng.normal(0, 0.05, n), rng.normal(0, 0.05, n)], 1)
    return y, latent.astype(np.float32)


def test_impute_counts_matches():
    y, latent = _groups()
    csc = sp.csc_matrix(y.T)
    j = jimp.impute_counts(jio.MemoryBackend(csc), latent, knn=10, cell_block=64)
    t = timp.impute_counts(MemoryBackend(csc), latent, knn=10, cell_block=64, device="cpu")
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_impute_from_reference_matches():
    y, latent = _groups(seed=1)
    q = latent[:50] + 0.01
    csc = sp.csc_matrix(y.T)
    kw = dict(knn=7, knn_temperature=0.5, cell_block=64)
    j = jimp.impute_from_reference(q, latent, jio.MemoryBackend(csc), **kw)
    t = timp.impute_from_reference(q, latent, MemoryBackend(csc), device="cpu", **kw)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    w = np.abs(np.random.default_rng(2).normal(size=(5, 4)))
    np.testing.assert_array_equal(timp.dist_to_softmax_weights(w, 0.7),
                                  jimp.dist_to_softmax_weights(w, 0.7))


def test_probe_latent_matches():
    rng = np.random.default_rng(1)
    train = rng.normal(0, 1, size=(500, 4)).astype(np.float32)
    for shift in (0.0, 3.0):
        held = rng.normal(0, 1, size=(200, 4)).astype(np.float32) + shift
        assert vars(timp.probe_latent(train, held)) == vars(jimp.probe_latent(train, held))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A topic model the port trained on a small store, a held-out query
    store from another draw, the training latent."""
    from legume_tpu_torch.data.sim import simulate_topic, write_topic_sim

    tmp = tmp_path_factory.mktemp("impprobe")
    sim = simulate_topic(rows=80, cols=300, factors=3, depth=1500, seed=8)
    store = write_topic_sim(sim, str(tmp / "sim"))
    query = simulate_topic(rows=80, cols=160, factors=3, depth=1500, seed=9, pve_topic=0.3)
    qstore = write_topic_sim(query, str(tmp / "query"))
    fit = str(tmp / "fit")
    tcli.run_senna(["topic", "--data-files", store, "--out", fit, "-k", "3",
                    "--encoder-layers", "16", "--epochs", "10", "--minibatch-size", "32",
                    "--num-levels", "1", "--sort-dim", "4", "--proj-dim", "8",
                    "--iter-opt", "3", "--block-size", "128", "--device", "cpu"])
    return tmp, store, qstore, fit


@pytest.fixture(scope="module")
def jax_probe(trained):
    _, store, qstore, fit = trained
    return jprobe.probe_model(fit, [qstore], store, alpha=0.1, block_size=64,
                              counterfactual=True, cf_seed=3)


def _assert_probe_matches(t, j):
    np.testing.assert_allclose(t.q_fit, j.q_fit, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.cal_fit, j.cal_fit, rtol=0, atol=1e-4)
    assert abs(t.threshold - j.threshold) <= 1e-4
    np.testing.assert_array_equal(t.q_fit < t.threshold, j.q_fit < j.threshold)
    assert (t.verdict, t.flag_rate, t.binom_p) == (j.verdict, j.flag_rate, j.binom_p)
    for key, jv in j.counterfactual.items():
        np.testing.assert_allclose(t.counterfactual[key], jv, rtol=1e-4, atol=1e-4, err_msg=key)


def test_probe_model_matches(trained, jax_probe):
    tmp, store, qstore, fit = trained
    t = tprobe.probe_model(fit, [qstore], store, alpha=0.1, block_size=64, counterfactual=True,
                           cf_seed=3, device="cpu")
    _assert_probe_matches(t, jax_probe)


def test_probe_and_impute_cli_match(trained, jax_probe):
    tmp, store, qstore, fit = trained
    o = str(tmp / "cli_t")
    t = tcli.run_senna(["probe", "--model", fit, "--data-files", qstore, "--calibration", store,
                        "--alpha", "0.1", "--counterfactual", "--cf-seed", "3",
                        "--minibatch-size", "64", "--out", o, "--device", "cpu"])
    _assert_probe_matches(t, jax_probe)
    doc = json.load(open(f"{o}.probe.json"))
    assert doc["verdict"] == jax_probe.verdict and doc["flag_rate"] == jax_probe.flag_rate
    fit_table = pd.read_parquet(f"{o}.probe.fit.parquet")
    np.testing.assert_array_equal(fit_table["flagged"], jax_probe.q_fit < jax_probe.threshold)
    outs = {}
    for tag, run, extra in (("j", jcli.run_senna, []), ("t", tcli.run_senna, ["--device", "cpu"])):
        o = str(tmp / f"cli_{tag}")
        run(["probe", "--train-latent", f"{fit}.latent.parquet", "--heldout-latent",
             f"{fit}.latent.parquet", "--out", o + "_lat"] + extra)
        run(["impute", "--data-files", store, "--latent", f"{fit}.latent.parquet",
             "--knn", "8", "--out", o] + extra)
        run(["impute", "--data-files", qstore, "--model", fit, "--reference-latent",
             f"{fit}.latent.parquet", "--reference-data", store, "--knn", "6",
             "--block-size", "100", "--out", o + "_ref"] + extra)
        outs[tag] = o
    j, t = outs["j"], outs["t"]
    assert json.load(open(f"{t}_lat.probe.json")) == json.load(open(f"{j}_lat.probe.json"))
    bj, bt = jio.open_sparse_matrix(f"{j}.zarr"), jio.open_sparse_matrix(f"{t}.zarr")
    assert bt.shape == bj.shape and bt.column_names() == bj.column_names()
    cols = np.arange(bj.num_columns)
    # log-proportion latents have norms near 10, where JAX's float32
    # expansion |q|^2 - 2 q.r + |r|^2 cancels to ~1e-4 of a neighbour's
    # distance (the port's kNN is float64): relative 5e-4 on the counts
    np.testing.assert_allclose(bt.read_columns_csc(cols).toarray(),
                               bj.read_columns_csc(cols).toarray(), rtol=5e-4, atol=1e-4)
    rj = pd.read_parquet(f"{j}_ref.imputed.parquet")
    rt = pd.read_parquet(f"{t}_ref.imputed.parquet")
    assert list(rt.columns) == list(rj.columns) and list(rt["cell"]) == list(rj["cell"])
    # the same float32 cancellation in JAX's kNN, on latents from each
    # package's predict: relative 5e-4
    np.testing.assert_allclose(rt.iloc[:, 1:].to_numpy(), rj.iloc[:, 1:].to_numpy(),
                               rtol=5e-4, atol=1e-4)
