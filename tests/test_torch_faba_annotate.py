"""`faba annotate` in the port against the JAX package
(`legume_tpu/faba/annotate.py`, `cli/faba_cmds/annotate_cmds.py`), on the
planted gem prefix of `tests/test_faba_annotate.py` (240 cells, H = 4,
two cell types and a nascent program) and on topic-model tables.

Exact: marker matching and IDF weights, Leiden memberships, the cell
assignments, cluster calls, p / q values, bootstrap supports and label
sets, the projection Q matrices, factor calls, cell calls and every
projection table the CLI writes. The enrichment mode's ES curve rounds
within a few float32 ulps of XLA's (`ops/enrichment.py`), so its ES,
z-scores, Q matrix and cell scores hold within 1e-4, as
`tests/test_torch_annotate.py` holds the Q-matrix lens; the topic tables
carry no exact ties, where such an ulp could flip a walk's extreme. The
bootstrap reclusters the base call's cell graph, which the JAX package
rebuilds, equal, in every replicate.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from faba_parity import same
from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import annotate as J
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.faba import annotate as T
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

H = 4


@pytest.fixture(scope="module")
def gem_prefix(tmp_path_factory):
    """Two cell types along two axes of an H = 4 co-embedded space, a
    velocity pushing type A toward a third axis (the Gamma program)."""
    tmp = tmp_path_factory.mktemp("annot")
    rng = np.random.default_rng(0)
    a, b, c = np.eye(H, dtype=np.float32)[:3]
    nh = 120
    cells = np.vstack([a + rng.normal(0, 0.15, (nh, H)),
                       b + rng.normal(0, 0.15, (nh, H))]).astype(np.float32)
    vel = np.vstack([c + rng.normal(0, 0.1, (nh, H)),
                     b + rng.normal(0, 0.1, (nh, H))]).astype(np.float32)
    genes = [f"g{i}" for i in range(60)]
    spl = np.vstack([a + rng.normal(0, 0.1, (20, H)), b + rng.normal(0, 0.1, (20, H)),
                     c + rng.normal(0, 0.1, (20, H))]).astype(np.float32)
    names = [f"c{i}" for i in range(2 * nh)]
    prefix = str(tmp / "fit")
    pd.DataFrame(cells, columns=[f"h{j}" for j in range(H)]).assign(cell=names).set_index(
        "cell").reset_index().to_parquet(f"{prefix}.cell_embedding.parquet")
    pd.DataFrame(vel, columns=[f"v{j}" for j in range(H)]).assign(cell=names).set_index(
        "cell").reset_index().to_parquet(f"{prefix}.velocity.parquet")
    rows = [f"{g}/count/spliced" for g in genes] + [f"{g}/count/unspliced" for g in genes]
    pd.DataFrame(np.vstack([spl, spl]), columns=[f"h{j}" for j in range(H)]).assign(
        feature=rows).set_index("feature").reset_index().to_parquet(
        f"{prefix}.feature_embedding.parquet")
    json.dump({"model_type": "embedding"}, open(f"{prefix}.gem.json", "w"))
    mk = tmp / "markers.tsv"
    mk.write_text("".join([f"g{i}\tAlpha\n" for i in range(20)]
                          + [f"g{i}\tBeta\n" for i in range(20, 40)]
                          + [f"g{i}\tGamma\n" for i in range(40, 60)]))
    spliced = spl, genes
    return prefix, str(mk), cells, names, spliced


@pytest.fixture(scope="module")
def topic_prefix(tmp_path_factory):
    """senna-topic-style dictionary / latent log tables, three programs,
    and the pseudobulk pair that turns on the correlation-keeping null."""
    tmp = tmp_path_factory.mktemp("topic")
    rng = np.random.default_rng(0)
    genes = [f"g{i}" for i in range(60)]
    beta = 1e-3 * rng.uniform(0.5, 1.5, (60, 3))
    for k in range(3):
        beta[20 * k: 20 * (k + 1), k] = 1.0
    beta /= beta.sum(0, keepdims=True)
    theta = rng.dirichlet([1, 1, 1], 90)
    prefix = str(tmp / "topic")

    def table(mat, key, rows, name, col="t"):
        pd.DataFrame(mat, columns=[f"{col}{k}" for k in range(mat.shape[1])]).assign(
            **{key: rows}).set_index(key).reset_index().to_parquet(f"{prefix}.{name}.parquet")

    table(np.log(beta), "gene", genes, "dictionary")
    table(np.log(np.maximum(theta, 1e-9)), "cell", [f"c{i}" for i in range(90)], "latent")
    pb_theta = rng.dirichlet([1, 1, 1], 12)
    table(rng.poisson(5.0, (60, 12)).astype(np.float32), "gene", genes, "pb_gene", "p")
    table(np.log(pb_theta), "pb", [f"p{i}" for i in range(12)], "pb_latent")
    json.dump({"model_type": "topic"}, open(f"{prefix}.gem.json", "w"))
    mk = tmp / "m.tsv"
    mk.write_text("".join([f"g{i}\tAlpha\n" for i in range(20)]
                          + [f"g{i}\tBeta\n" for i in range(20, 40)]
                          + [f"g{i}\tGamma\n" for i in range(40, 60)]))
    return prefix, str(mk), beta, theta, genes


def test_marker_matching_and_mode_equal_jax(tmp_path):
    mk = tmp_path / "m.tsv"
    mk.write_text("g0\tA\ng1\tA\ng2\tA\ng0\tB\ng3\tB\ng4\tB\ngX\tC\n")
    genes = ["g0", "g1", "g2", "g3", "g4"]
    same(T.parse_and_match_markers(str(mk), genes, min_markers=3),
         J.parse_and_match_markers(str(mk), genes, min_markers=3))
    for mod in (T, J):
        with pytest.raises(ValueError, match="coverage"):
            mod.parse_and_match_markers(str(mk), genes, min_markers=1, min_panel_coverage=0.95)
    p = str(tmp_path / "run")
    for manifest in (None, "topic", "embedding"):
        if manifest:
            json.dump({"model_type": manifest}, open(f"{p}.gem.json", "w"))
        for req in (None, "projection", "enrichment"):
            assert T.resolve_mode(p, req) == J.resolve_mode(p, req)


PROJECTION = {
    "bootstrap": dict(n_perm=200, n_boot=20, knn=10),
    "separable_ontology_free": dict(n_perm=100, n_boot=15, knn=8, abstain_separable=True,
                                    support_perm=20, resolution=0.5),
    "fixed_clusters_no_qc": dict(n_perm=100, n_boot=10, knn=10, recluster=False,
                                 assign_qc=False, use_idf=False),
    "panel_bias_only": dict(n_perm=100, bootstrap=False, panel_perm=30, knn=10),
}


@pytest.mark.parametrize("case", list(PROJECTION))
def test_projection_equals_jax(case, gem_prefix):
    prefix, mk, cells, names, (spl, genes) = gem_prefix
    kw = dict(PROJECTION[case], seed=0)
    got = T.annotate_projection(spl, genes, cells, names, mk, device="cpu", **kw)
    want = J.annotate_projection(spl, genes, cells, names, mk, **kw)
    same(got, want, case)
    if case == "bootstrap":
        calls = np.array([got.cluster_call[list(np.unique(got.clusters)).index(c)]
                          for c in got.clusters])
        assert (calls == np.array(["Alpha"] * 120 + ["Beta"] * 120)).mean() > 0.95


@pytest.mark.parametrize("pb", [False, True], ids=["plain", "pb_null"])
def test_enrichment_equals_jax(pb, topic_prefix):
    prefix, mk, beta, theta, genes = topic_prefix
    extra = {}
    if pb:
        extra = dict(pb_gene=pd.read_parquet(f"{prefix}.pb_gene.parquet").iloc[:, 1:].to_numpy(),
                     pb_log_theta=pd.read_parquet(f"{prefix}.pb_latent.parquet")
                     .iloc[:, 1:].to_numpy())
    args = (np.log(beta), genes, np.log(np.maximum(theta, 1e-9)),
            [f"c{i}" for i in range(90)], mk)
    kw = dict(n_perm=100, n_boot=8, seed=0, **extra)
    got = T.annotate_enrichment(*args, device="cpu", **kw)
    want = J.annotate_enrichment(*args, **kw)
    for key in ("z", "qmatrix", "cell_scores"):
        np.testing.assert_allclose(got.pop(key), want.pop(key), rtol=0, atol=1e-4, err_msg=key)
    same(got, want)
    if not pb:  # the pseudobulk pair carries no programs: its null unassigns every factor
        assert got["factor_call"] == ["Alpha", "Beta", "Gamma"]


def _files(tmp_path, side):
    return sorted(f[len(side) + 1:] for f in os.listdir(tmp_path) if f.startswith(side + "."))


def _cli_pair(argv, tmp_path, capsys, out="--out"):
    t_faba(argv + [out, str(tmp_path / "t"), "--device", "cpu"])
    t_said = capsys.readouterr().out
    j_faba(argv + [out, str(tmp_path / "j")])
    assert t_said.replace(str(tmp_path / "t"), "P") == capsys.readouterr().out.replace(
        str(tmp_path / "j"), "P")
    files = _files(tmp_path, "t")
    assert files == _files(tmp_path, "j") and files
    for f in files:
        a, b = pd.read_parquet(tmp_path / f"t.{f}"), pd.read_parquet(tmp_path / f"j.{f}")
        if f.startswith("enrichment."):
            num = [c for c in a.columns if a[c].dtype.kind == "f"]
            np.testing.assert_allclose(a[num].to_numpy(), b[num].to_numpy(), rtol=0, atol=1e-4,
                                       err_msg=f)
            a, b = a.drop(columns=num), b.drop(columns=num)
        same(a, b, f)
    return files


def test_cli_projection_both_tracks_matches_jax(gem_prefix, tmp_path, capsys):
    prefix, mk, *_ = gem_prefix
    files = _cli_pair(["annotate", "--from", prefix, "--markers", mk, "--num-perm", "200",
                       "--n-boot", "15", "--knn", "10", "--seed", "0", "--panel-perm", "10"],
                      tmp_path, capsys)
    assert {"spliced.annotation.parquet", "velocity.annotation.parquet",
            "spliced.panel_bias.parquet"} <= set(files)
    velo = pd.read_parquet(tmp_path / "t.velocity.annotation.parquet")
    assert (velo["annotation"].to_numpy()[:120] == "Gamma").mean() > 0.8


def test_cli_enrichment_matches_jax(topic_prefix, tmp_path, capsys):
    prefix, mk, *_ = topic_prefix
    files = _cli_pair(["annotate", "--from", prefix, "--markers", mk, "--num-perm", "100",
                       "--n-boot", "5", "--seed", "0"], tmp_path, capsys)
    assert "enrichment.factors.parquet" in files


def test_cli_legacy_cluster_labelling_matches_jax(tmp_path, capsys):
    import scipy.sparse as sp

    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    rng = np.random.default_rng(3)
    genes = [f"g{i}" for i in range(30)]
    x = rng.poisson(0.5, (30, 80)).astype(np.float32)
    x[:10, :40] += rng.poisson(4.0, (10, 40))
    x[10:20, 40:] += rng.poisson(4.0, (10, 40))
    be = str(tmp_path / "m.zarr")
    create_sparse_from_csc(sp.csc_matrix(x), be, [f"{g}/m6a/CT" for g in genes],
                           [f"c{i}" for i in range(80)])
    pd.DataFrame({"cell": [f"c{i}" for i in range(80)],
                  "cluster": [0] * 40 + [1] * 40}).to_parquet(tmp_path / "cl.parquet")
    gmt = tmp_path / "m.gmt"
    gmt.write_text("A\tx\t" + "\t".join(genes[:10]) + "\nB\tx\t" + "\t".join(genes[10:20]) + "\n")
    files = _cli_pair(["annotate", "--markers", str(gmt), "--backend", be, "--clusters",
                       str(tmp_path / "cl.parquet"), "--n-boot", "20"],
                      tmp_path, capsys, out="--output")
    assert files == ["annotation.parquet"]
    assert list(pd.read_parquet(tmp_path / "t.annotation.parquet")["annotation"]) == ["A", "B"]


def test_cli_mode_guards_match_jax(gem_prefix, tmp_path):
    prefix, mk, *_ = gem_prefix
    for extra, match in ((["--track", "nascent"], "nascent"),
                         (["--mode", "enrichment", "--track", "velocity"], "velocity"),
                         (["--mode", "enrichment", "--panel-perm", "10"], "panel-perm")):
        argv = ["annotate", "--from", prefix, "--markers", mk, "--out", str(tmp_path / "x")] + extra
        with pytest.raises(SystemExit, match=match):
            t_faba(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit, match=match):
            j_faba(argv)
