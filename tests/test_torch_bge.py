"""`senna bge` end to end through both packages on the same zarr backend
(80 genes x 300 cells, the data of `tests/test_cli_e2e.py::test_cli_bge`),
the port on the CPU: the pseudobulk groups are equal, the cell latent and
the feature embedding (the SIMBA co-embed) agree within 2e-4, the outputs
and the manifest are written, `--posterior` and `--multiome` run and
write the JAX package's tables, `NceConfig.gene_chunk` follows the dense
form and JAX's chunked run, and the option the port does not carry
raises. Also: no module of the port, and not `chip_smoke.py`, imports JAX
or the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from legume_tpu.cli import main as jcli
from legume_tpu.data.sim import simulate_topic, write_topic_sim
from legume_tpu.ops import random_projection as jrp
from legume_tpu.senna.topic import load_data_vec as j_load_data_vec
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, run_bge
from torch_cpu import one_thread

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["-d", "8", "--epochs", "120", "--sort-dim", "5", "--proj-dim", "16"]
# Adam trajectories of 120 + 100 steps in two frameworks: the f32
# reassociation error stays near 1e-6 (tests/test_torch_nce.py), the
# band leaves two orders of magnitude
ATOL = 2e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bge")
    sim = simulate_topic(rows=80, cols=300, factors=3, depth=1500, seed=6)
    path = write_topic_sim(sim, str(tmp / "sim"))
    jcli.run_senna(["bge", "--data-files", path, "--out", str(tmp / "jax"), *FLAGS])
    args = BgeArgs(data_files=[path], out=str(tmp / "port"), embed_dim=8, epochs=120,
                   sort_dim=5, proj_dim=16)
    port = run_bge(args, device="cpu")
    return dict(tmp=tmp, path=path, port=port)


def _table(prefix, name):
    return pd.read_parquet(f"{prefix}.{name}.parquet")


def test_groups_equal(runs):
    vec = j_load_data_vec([runs["path"]])
    _, proj = jrp.project_columns(vec, 16)
    groups, s = jrp.compact_group_codes(jrp.binary_sort_columns(proj, 5))
    np.testing.assert_array_equal(runs["port"]["groups"], groups)
    assert runs["port"]["num_groups"] == s == runs["port"]["pb"].shape[0]


@pytest.mark.parametrize("name,index", [("latent", "cell"), ("feature_embedding", "gene")])
def test_embeddings_within_band(runs, name, index):
    j = _table(runs["tmp"] / "jax", name)
    t = _table(runs["tmp"] / "port", name)
    assert list(t.columns) == list(j.columns) == [index] + [f"h{i}" for i in range(8)]
    assert (t[index] == j[index]).all()
    got, want = t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(runs["port"][name], want, atol=ATOL)


def test_outputs_and_manifest_written(runs):
    prefix = runs["tmp"] / "port"
    theta = _table(prefix, "topic_latent").iloc[:, 1:].to_numpy()
    assert theta.shape[0] == 300
    np.testing.assert_allclose(np.exp(theta).sum(1), 1.0, rtol=1e-5)
    beta = _table(prefix, "dictionary").iloc[:, 1:].to_numpy()
    assert beta.shape == (80, theta.shape[1])
    np.testing.assert_allclose(np.exp(beta).sum(0), 1.0, rtol=1e-5)
    import json

    doc = json.loads((runs["tmp"] / "port.gem.json").read_text())
    assert doc["command"] == "bge" and doc["engine"] == "legume-tpu-torch"
    assert set(doc["outputs"]) == {"latent", "feature_embedding", "dictionary", "topic_latent"}
    for stage in ("projection_s", "sort_s", "collapse_s", "phase1_s", "phase2_s", "leiden_s",
                  "etm_s", "outputs_s"):
        assert doc["timings"][stage] >= 0.0
    losses = runs["port"]["phase1_losses"]
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_cli_runs_and_rejects_unported_options(runs, tmp_path):
    out = str(tmp_path / "cli")
    argv = ["senna", "bge", "--data-files", runs["path"], "--out", out, "-d", "4", "--epochs", "5",
            "--sort-dim", "3", "--proj-dim", "8", "--skip-etm", "--device", "cpu"]
    assert port_cli(argv) == 0
    assert (tmp_path / "cli.latent.parquet").exists()
    assert not (tmp_path / "cli.dictionary.parquet").exists()
    # --posterior runs and writes JAX's table
    assert port_cli(argv + ["--posterior", "4", "--out", out + "_post"]) == 0
    jcli.run_senna(["bge", *argv[2:-2], "--posterior", "4", "--out", out + "_jpost"])
    t = pd.read_parquet(out + "_post.feature_posterior.parquet")
    j = pd.read_parquet(out + "_jpost.feature_posterior.parquet")
    assert list(t.columns) == list(j.columns) == ["gene", "pip", "posterior_norm"]
    assert (t.gene == j.gene).all() and t.pip.between(0, 1).all()
    assert np.isfinite(t.posterior_norm).all()
    import json

    doc = json.loads((tmp_path / "cli_post.gem.json").read_text())
    assert doc["outputs"]["feature_posterior"].endswith("cli_post.feature_posterior.parquet")
    # --multiome needs two files
    with pytest.raises(SystemExit, match="exactly 2"):
        port_cli(argv + ["--multiome"])
    # --data-parallel without a process group is a world of one: the plain run
    with one_thread():
        assert port_cli(argv + ["--out", out + "_plain"]) == 0
        assert port_cli(argv + ["--data-parallel", "--out", out + "_dp"]) == 0
    pd.testing.assert_frame_equal(pd.read_parquet(out + "_dp.latent.parquet"),
                                  pd.read_parquet(out + "_plain.latent.parquet"))
    pd.testing.assert_frame_equal(pd.read_parquet(out + "_dp.feature_embedding.parquet"),
                                  pd.read_parquet(out + "_plain.feature_embedding.parquet"))


def test_multiome_outputs_named_and_shaped_as_jax(tmp_path):
    from legume_tpu.data.sim import simulate_multiome
    from legume_tpu.data.sparse_io import create_sparse_from_csc

    sim = simulate_multiome(genes=40, peaks=60, cols=200, seed=13)
    cells = [f"c{j}" for j in range(200)]
    rna, atac = str(tmp_path / "rna.zarr"), str(tmp_path / "atac.zarr")
    create_sparse_from_csc(sim.rna, rna, [f"g{i}" for i in range(40)], cells)
    create_sparse_from_csc(sim.atac, atac, [f"p{i}" for i in range(60)], cells)
    flags = ["--data-files", rna, atac, "--multiome", "--bridge-weight", "0.5", "-d", "4",
             "--epochs", "20", "--sort-dim", "3", "--proj-dim", "8", "--skip-etm"]
    jcli.run_senna(["bge", *flags, "--out", str(tmp_path / "j")])
    res = port_cli(["senna", "bge", *flags, "--out", str(tmp_path / "t"), "--device", "cpu"])
    assert res == 0
    for name, index in (("feature_embedding", "gene"), ("latent", "cell")):
        j = _table(tmp_path / "j", name)
        t = _table(tmp_path / "t", name)
        assert list(t.columns) == list(j.columns) and t.shape == j.shape
        assert (t[index] == j[index]).all()
        assert np.isfinite(t.iloc[:, 1:].to_numpy()).all()
    names = _table(tmp_path / "t", "feature_embedding").gene.tolist()
    assert names[:2] == ["rna:g0", "rna:g1"] and names[-1] == "atac:p59" and len(names) == 100
    # the stacked plane: RNA rows, then the ATAC rows scaled by the bridge weight
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import multiome_vec
    from legume_tpu_torch.data import MemoryBackend

    vec = multiome_vec([MemoryBackend(sim.rna, None, cells), MemoryBackend(sim.atac, None, cells)],
                       0.5)
    got = vec.read_columns_csc(np.arange(200)).toarray()
    np.testing.assert_array_equal(got[:40], sim.rna.toarray())
    np.testing.assert_array_equal(got[40:], 0.5 * sim.atac.toarray())
    with pytest.raises(SystemExit, match="share cells"):
        multiome_vec([MemoryBackend(sim.rna), MemoryBackend(sim.atac[:, :100])])


@pytest.mark.parametrize("ridge", [0.0, 0.05])
def test_gene_chunk_matches_dense_and_jax(ridge):
    """`tests/test_nce.py::test_gene_chunked_phase1_matches_dense`'s
    data and bar (2e-3 against the dense form), and JAX's own chunked run
    within the port's phase-1 bar (2e-4; losses rtol 1e-4). With a ridge
    both packages average it over the padded rows too (D rounded up to
    the chunk), so the chunked run then follows JAX's, not the dense one."""
    from legume_tpu.embedding.nce import NceConfig as JConfig
    from legume_tpu.embedding.nce import fit_bge as j_fit_bge
    from legume_tpu_torch.embedding.nce import NceConfig, fit_bge

    counts = np.random.default_rng(0).poisson(1.0, (30, 50)).astype(np.float32)
    kw = dict(embedding_dim=6, epochs=150, seed=2, ridge=ridge)
    dense = fit_bge([counts], config=NceConfig(**kw), device="cpu")
    chunked = fit_bge([counts], config=NceConfig(**kw, gene_chunk=16), device="cpu")
    assert chunked.e_feat.shape == (50, 6)
    if ridge == 0.0:
        np.testing.assert_allclose(chunked.e_feat, dense.e_feat, atol=2e-3)
        np.testing.assert_allclose(chunked.pb_embeddings[0], dense.pb_embeddings[0], atol=2e-3)
    want = j_fit_bge([counts], config=JConfig(**kw, gene_chunk=16))
    np.testing.assert_allclose(chunked.e_feat, want.e_feat, atol=2e-4)
    np.testing.assert_allclose(chunked.pb_embeddings[0], want.pb_embeddings[0], atol=2e-4)
    np.testing.assert_allclose(chunked.phase1_losses, want.phase1_losses, rtol=1e-4, atol=1e-5)


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    files = sorted((REPO / "legume_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    banned = ("jax", "jaxlib", "flax", "optax", "legume_tpu")
    bad = {
        str(f.relative_to(REPO)): sorted(m for m in _imported_modules(f)
                                         if m.split(".")[0] in banned)
        for f in files
    }
    assert len(files) > 30
    assert {k: v for k, v in bad.items() if v} == {}
    # the native MatrixMarket / fragments parser is the port's own copy,
    # built into the port's build directory, never the repo's `native/`
    from legume_tpu_torch.data import ioaccel

    port = REPO / "legume_tpu_torch"
    assert ioaccel._SRC == port / "native" / "ioaccel.cpp" and ioaccel._SRC.exists()
    assert ioaccel.BUILD_DIR == port / "_build"
    src = (port / "data" / "ioaccel.py").read_text()
    assert "parents[2]" not in src and '"native" / "lib' not in src
