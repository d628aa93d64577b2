"""`senna bge` end to end through both packages on the same zarr backend
(80 genes x 300 cells, the data of `tests/test_cli_e2e.py::test_cli_bge`,
without `--posterior`), the port on the CPU: the pseudobulk groups are
equal, the cell latent and the feature embedding (the SIMBA co-embed)
agree within 2e-4, the outputs and the manifest are written, and the
options the port does not carry raise. Also: no module of the port, and
not `chip_smoke.py`, imports JAX or the JAX package."""

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
    for flag in (["--posterior", "4"], ["--multiome"], ["--data-parallel"]):
        with pytest.raises(NotImplementedError, match=flag[0]):
            port_cli(argv + flag)


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
