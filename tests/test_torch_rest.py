"""`senna resolve-embedding-space` (`senna rest`) through both packages,
the port on the CPU (`embedding/resolve.py`, `cli/senna_cmds/embed_cmds.py`).

`rest_fit` starts from the JAX package's threefry draws (within one
float32 rounding of XLA's erfinv) and runs the same full-batch AdamW, so
its 400 losses are held within a relative 1e-4 of JAX's and its
embeddings within a normwise 1e-3; the Procrustes alignment is numpy in
both and is held within 1e-6. Both CLI modes run in both packages on the
same inputs: `--from` a run whose manifest either package wrote, and
`--runs` over finished runs' tables.
"""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.cli import main as jcli
from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.embedding import resolve as jres
from legume_tpu.utils.manifest import RunManifest as JManifest
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data import MemoryBackend
from legume_tpu_torch.embedding import resolve as tres
from legume_tpu_torch.utils import prng

N, D, K = 300, 80, 5


def _norm_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rest")
    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.full(K, 0.5), N).astype(np.float32)
    beta = rng.gamma(1.0, 1.0, (D, K))
    y = rng.poisson(20 * (theta @ beta.T) / K).astype(np.float32)
    csc = sp.csc_matrix(y.T)
    genes, cells = [f"g{i}" for i in range(D)], [f"c{j}" for j in range(N)]
    path = str(tmp / "counts.zarr")
    create_sparse_from_csc(csc, path, genes, cells)
    # a finished topic run: its latent (log proportions) and manifest
    pd.DataFrame(np.log(theta), index=cells, columns=[f"topic{k}" for k in range(K)]
                 ).reset_index(names="cell").to_parquet(tmp / "topic.latent.parquet")
    JManifest(command="topic", inputs={"data_files": [path]},
              outputs={"latent": str(tmp / "topic.latent.parquet")}).save(str(tmp / "topic"))
    want = jres.rest_fit(theta, JMem(csc, genes, cells), epochs=400, seed=3)
    got = tres.rest_fit(theta, MemoryBackend(csc, genes, cells), epochs=400, seed=3, device="cpu")
    return dict(tmp=tmp, theta=theta, csc=csc, path=path, want=want, got=got)


def test_init_matches_jax_draws():
    k1, k2 = jax.random.split(jax.random.key(3))
    p1, p2 = prng.split(prng.key(3))
    for jk, pk, shape in ((k1, p1, (K, K)), (k2, p2, (D, K))):
        np.testing.assert_allclose(0.1 * prng.normal(pk, shape),
                                   np.asarray(0.1 * jax.random.normal(jk, shape)),
                                   rtol=0, atol=1e-7)


def test_rest_fit_losses_and_embeddings_match_jax(data):
    want, got = data["want"], data["got"]
    assert len(got["losses"]) == len(want["losses"]) == 8
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    for name in ("cell_embedding", "feature_embedding", "topic_embedding", "rho_raw", "bias"):
        assert got[name].shape == want[name].shape
        assert _norm_err(got[name], want[name]) < 1e-3, name


def test_procrustes_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(50, 6))
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    b = 1.7 * a @ q + 0.3 + rng.normal(0, 0.01, a.shape)
    for scale in (True, False):
        r_t, s_t = tres.procrustes_transform(a, b, allow_scale=scale)
        r_j, s_j = jres.procrustes_transform(a, b, allow_scale=scale)
        np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-6)
        assert abs(s_t - s_j) < 1e-6
    runs = [{"feat_names": [f"f{i}" for i in range(50)], "e_feat": b, "e_cell": b[:10]},
            {"feat_names": [f"f{i}" for i in range(5, 55)], "e_feat": a, "e_cell": a[:7]}]
    for got, want in zip(tres.resolve_embedding_spaces(runs), jres.resolve_embedding_spaces(runs)):
        np.testing.assert_allclose(got["e_feat"], want["e_feat"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["e_cell"], want["e_cell"], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="too few shared"):
        tres.resolve_embedding_spaces([runs[0], {**runs[1], "feat_names": ["x"] * 50}])


def test_cli_from_matches_jax(data):
    tmp = data["tmp"]
    flags = ["--from", str(tmp / "topic"), "--epochs", "100", "--seed", "1"]
    jcli.run_senna(["rest", *flags, "--out", str(tmp / "jrest")])
    assert port_cli(["senna", "rest", *flags, "--out", str(tmp / "trest"), "--device", "cpu"]) == 0
    for name, index in (("latent", "cell"), ("feature_embedding", "gene")):
        j = pd.read_parquet(tmp / f"jrest.{name}.parquet")
        t = pd.read_parquet(tmp / f"trest.{name}.parquet")
        assert list(t.columns) == list(j.columns) == [index] + [f"h{i}" for i in range(K)]
        assert (t[index] == j[index]).all()
        assert _norm_err(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy()) < 1e-3
    j = pd.read_parquet(tmp / "jrest.topic_embedding.parquet")
    t = pd.read_parquet(tmp / "trest.topic_embedding.parquet")
    assert list(t.columns) == list(j.columns)
    doc = json.loads((tmp / "trest.senna.json").read_text())
    assert doc["command"] == "resolve-embedding-space"
    assert set(doc["outputs"]) == {"latent", "feature_embedding"}
    # the port's own run chains the same way
    assert port_cli(["senna", "resolve-embedding-space", "--from", str(tmp / "trest"),
                     "--epochs", "3", "--out", str(tmp / "trest2"), "--device", "cpu"]) == 0


def test_cli_runs_matches_jax(data, tmp_path):
    rng = np.random.default_rng(5)
    e = rng.normal(size=(40, 4))
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    for i, emb in enumerate((e, 2.0 * e @ q - 1.0)):
        pd.DataFrame(emb, index=[f"g{j}" for j in range(40)], columns=[f"h{j}" for j in range(4)]
                     ).reset_index(names="gene").to_parquet(tmp_path / f"r{i}.feature_embedding.parquet")
        pd.DataFrame(emb[:9], index=[f"c{j}" for j in range(9)], columns=[f"h{j}" for j in range(4)]
                     ).reset_index(names="cell").to_parquet(tmp_path / f"r{i}.latent.parquet")
    runs = [str(tmp_path / "r0"), str(tmp_path / "r1")]
    jcli.run_senna(["rest", "--runs", *runs, "--out", str(tmp_path / "j")])
    assert port_cli(["senna", "rest", "--runs", *runs, "--out", str(tmp_path / "t"),
                     "--device", "cpu"]) == 0
    for i in range(2):
        for name in ("feature_embedding", "latent"):
            j = pd.read_parquet(tmp_path / f"j.run{i}.{name}.parquet")
            t = pd.read_parquet(tmp_path / f"t.run{i}.{name}.parquet")
            assert list(t.columns) == list(j.columns)
            np.testing.assert_allclose(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy(),
                                       rtol=0, atol=1e-6)
    # the second run lands on the first
    t = pd.read_parquet(tmp_path / "t.run1.feature_embedding.parquet").iloc[:, 1:].to_numpy()
    np.testing.assert_allclose(t, e, atol=1e-6)
