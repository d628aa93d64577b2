"""The port's annotation slice against the JAX package on the same
inputs, on the CPU: `ops/enrichment.py` (weighted-KS enrichment scores
within 1e-6, permutation p-values, BH, TreeBH and the Q-matrix's
p- and q-values equal; its z-scores, which divide ES differences by the
null's spread, within 1e-4), the `qmatrix`, `annotate-by-enrichment`,
`annotate-ontology` and `annotate-by-projection` commands end to end,
and the graceful-stop flag (`utils/stop.py`) with the trainer that polls
it."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from legume_tpu.cli import main as jcli
from legume_tpu.data import knowledge as jknow
from legume_tpu.ops import enrichment as jenr
from legume_tpu_torch.cli import main as tcli
from legume_tpu_torch.data import knowledge as tknow
from legume_tpu_torch.ops import enrichment as tenr
from legume_tpu_torch.utils import stop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enrichment_score_and_permutation_null_match(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(300, 1200))
    scores = rng.normal(size=d)
    mask = np.zeros(d, bool)
    mask[rng.choice(d, 25, replace=False)] = True
    scores[mask] += 0.4 * seed
    es_j = jenr.enrichment_score(scores, mask)
    es_t = tenr.enrichment_score(scores, mask, device="cpu")
    assert abs(es_j - es_t) <= 1e-6
    j = jenr.gsea_permutation_pvalue(scores, mask, n_permutations=200, seed=seed)
    t = tenr.gsea_permutation_pvalue(scores, mask, n_permutations=200, seed=seed, device="cpu")
    assert abs(j[0] - t[0]) <= 1e-6 and abs(j[1] - t[1]) <= 1e-5
    assert j[2] == t[2]


def _chain_ontology(pkg):
    return pkg.Ontology(
        terms={t: t for t in ["root", "a", "b", "a1", "a2", "b1"]},
        parents={"root": set(), "a": {"root"}, "b": {"root"}, "a1": {"a"}, "a2": {"a"},
                 "b1": {"b"}},
    )


def test_bh_and_treebh_match():
    rng = np.random.default_rng(4)
    p = rng.uniform(size=200) ** 3
    np.testing.assert_array_equal(tenr.bh_fdr(p), jenr.bh_fdr(p))
    pv = {"root": 0.001, "a": 0.002, "b": 0.9, "a1": 0.003, "a2": 0.8, "b1": 0.001}
    assert tenr.treebh(pv, _chain_ontology(tknow)) == jenr.treebh(pv, _chain_ontology(jknow))
    for _ in range(5):
        pv = {t: float(rng.uniform() ** 4) for t in pv}
        assert (tenr.treebh(pv, _chain_ontology(tknow), alpha=0.1)
                == jenr.treebh(pv, _chain_ontology(jknow), alpha=0.1))


@pytest.mark.parametrize("stratify,specificity", [(True, "raw"), (False, "simplex")])
def test_qmatrix_matches(stratify, specificity):
    rng = np.random.default_rng(0)
    d, k = 300, 3
    genes = [f"g{i}" for i in range(d)]
    log_beta = rng.normal(scale=0.3, size=(k, d))
    log_beta[0, :20] += 2.0
    log_beta[2, 50:70] += 2.0
    sets = {"A": genes[:20], "B": genes[50:70], "C": genes[100:140] + ["absent"],
            "none": ["absent"]}
    kw = dict(n_perm=150, seed=3, stratify=stratify, specificity=specificity)
    j = jenr.geneset_topic_qmatrix(log_beta, genes, sets, **kw)
    t = tenr.geneset_topic_qmatrix(log_beta, genes, sets, device="cpu", **kw)
    assert t["labels"] == j["labels"] == ["A", "B", "C"]
    np.testing.assert_array_equal(t["pvalue"], j["pvalue"])
    np.testing.assert_array_equal(t["q"], j["q"])
    np.testing.assert_allclose(t["es"], j["es"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["z"], j["z"], rtol=0, atol=1e-4)


def test_numpy_statistics_match():
    rng = np.random.default_rng(1)
    d = 120
    genes = [f"g{i}" for i in range(d)]
    prof = rng.normal(0, 0.2, (3, d))
    prof[0, :10] += 3.0
    prof[1, 50] += 6.0
    sets = {"A": genes[:10], "B": [genes[50]] + genes[100:115], "C": genes[30:40]}
    j = jenr.marker_bootstrap(prof, genes, sets, n_boot=40, support_threshold=0.9, seed=2)
    t = tenr.marker_bootstrap(prof, genes, sets, n_boot=40, support_threshold=0.9, seed=2)
    assert t["annotation"] == j["annotation"]
    np.testing.assert_array_equal(t["cluster_label_support"], j["cluster_label_support"])
    theta = rng.dirichlet(np.ones(3), 40)
    q = np.maximum(rng.normal(size=(3, 2)), 0)
    for a, b in zip(tenr.label_cells(theta, q, ["x", "y"]), jenr.label_cells(theta, q, ["x", "y"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mode in ("raw", "simplex", "abs"):
        np.testing.assert_array_equal(tenr.compute_specificity(prof.T, mode),
                                      jenr.compute_specificity(prof.T, mode))
    terms = {"A": list(range(10)), "B": list(range(40, 60))}
    np.testing.assert_array_equal(tenr.ontology_module_score(np.exp(prof.T), terms)["effect_kt"],
                                  jenr.ontology_module_score(np.exp(prof.T), terms)["effect_kt"])


@pytest.mark.parametrize("two_layer", [False, True])
def test_type_annotation_matches(two_layer):
    """`embedding/type_annotation.py` (a copy; its kNN on the port's
    device path): the same labels and scores as the JAX package's."""
    from legume_tpu.embedding import type_annotation as jta
    from legume_tpu_torch.embedding import type_annotation as tta

    rng = np.random.default_rng(3)
    genes = [f"g{i}" for i in range(60)]
    feat = rng.normal(size=(60, 8)).astype(np.float32)
    centres = np.stack([feat[10 * k : 10 * k + 5].mean(0) for k in range(3)])
    cells = (centres[rng.integers(0, 3, 150)] + rng.normal(0, 0.3, (150, 8))).astype(np.float32)
    sets = {f"T{k}": genes[10 * k : 10 * k + 5] for k in range(3)}
    sets["T0_sub"] = genes[0:3]
    kw = dict(n_permutations=30, seed=2)
    if two_layer:
        j = jta.annotate_two_layer(cells, feat, genes, sets, knn=10, **kw)
        t = tta.annotate_two_layer(cells, feat, genes, sets, knn=10, device="cpu", **kw)
        assert (list(t.fine.labels), list(t.coarse_labels)) == (list(j.fine.labels),
                                                                 list(j.coarse_labels))
        np.testing.assert_array_equal(t.communities, j.communities)
        assert t.group_of_type == j.group_of_type and t.hub_calls == j.hub_calls
        return
    j = jta.annotate_by_projection(cells, feat, genes, sets, **kw)
    t = tta.annotate_by_projection(cells, feat, genes, sets, **kw)
    assert list(t.labels) == list(j.labels)
    np.testing.assert_array_equal(t.scores, j.scores)
    np.testing.assert_array_equal(t.zscores, j.zscores)


# ---------------------------------------------------------------------------
# the commands end to end, both packages on the same files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def annot_inputs(tmp_path_factory):
    """A small simulated store, its clusters, a dictionary, a latent, a
    GMT of the true factors' top genes and a toy OBO + GAF."""
    from legume_tpu_torch.data.sim import simulate_topic, write_topic_sim

    tmp = tmp_path_factory.mktemp("annot")
    sim = simulate_topic(rows=150, cols=240, factors=3, batches=1, pve_topic=0.9,
                         depth=2000, seed=5)
    store = write_topic_sim(sim, str(tmp / "sim"))
    genes = sim.row_names
    cells = sim.col_names
    clusters = sim.theta.argmax(1)
    pd.DataFrame({"cell": cells, "cluster": clusters}).to_parquet(tmp / "cl.parquet")
    log_beta = np.log(sim.beta / sim.beta.sum(0, keepdims=True))
    pd.DataFrame(log_beta, index=genes, columns=[f"topic{k}" for k in range(3)]).reset_index(
        names="gene").to_parquet(tmp / "dict.parquet")
    pd.DataFrame(np.log(np.maximum(sim.theta, 1e-6)), index=cells,
                 columns=[f"topic{k}" for k in range(3)]).reset_index(names="cell").to_parquet(
        tmp / "lat.parquet")
    top = np.argsort(-log_beta, axis=0)[:15]
    (tmp / "m.gmt").write_text("".join(
        f"factor{k}\tsim\t" + "\t".join(genes[i] for i in top[:, k]) + "\n" for k in range(3)))
    obo = ["format-version: 1.2", ""]
    gaf = ["!gaf-version: 2.2"]
    obo += ["[Term]", "id: CL:0", "name: cell", ""]
    for k in range(3):
        obo += ["[Term]", f"id: CL:{k + 1}", f"name: type{k}", "is_a: CL:0 ! cell", ""]
        obo += ["[Term]", f"id: CL:{k + 4}", f"name: subtype{k}", f"is_a: CL:{k + 1}", ""]
        gaf += [f"db\tid\t{genes[i]}\t\tCL:{k + 4}" for i in top[:8, k]]
        gaf += [f"db\tid\t{genes[i]}\t\tCL:{k + 1}" for i in top[8:15, k]]
    (tmp / "o.obo").write_text("\n".join(obo) + "\n")
    (tmp / "g.gaf").write_text("\n".join(gaf) + "\n")
    return tmp, store


def _both(argv, tmp, name):
    """Run `argv` through both packages' CLIs, the port's on the CPU (the
    two commands that run on the host alone take no `--device`); returns
    the two prefixes."""
    outs = []
    host_only = argv[0] in ("annotate-ontology", "annotate-by-enrichment")
    port_extra = [] if host_only else ["--device", "cpu"]
    for tag, run, extra in (("j", jcli.run_senna, []), ("t", tcli.run_senna, port_extra)):
        out = str(tmp / f"{name}_{tag}")
        run(argv + ["--out", out] + extra)
        outs.append(out)
    return outs


def _assert_tables_equal(a, b, atol=0.0):
    ja, tb = pd.read_parquet(a), pd.read_parquet(b)
    assert list(ja.columns) == list(tb.columns)
    for c in ja.columns:
        if ja[c].dtype.kind in "fc":
            np.testing.assert_allclose(tb[c].to_numpy(), ja[c].to_numpy(), rtol=0, atol=atol,
                                       err_msg=c)
        else:
            assert [str(x) for x in tb[c]] == [str(x) for x in ja[c]], c


def test_qmatrix_cli_matches(annot_inputs):
    tmp, _ = annot_inputs
    j, t = _both(["qmatrix", "--dictionary", str(tmp / "dict.parquet"), "--markers",
                  str(tmp / "m.gmt"), "--permutations", "100", "--latent",
                  str(tmp / "lat.parquet")], tmp, "qm")
    for ext in ("qvalues", "cell_annotation"):
        _assert_tables_equal(f"{j}.{ext}.parquet", f"{t}.{ext}.parquet")
    for ext in ("qmatrix", "qsoftmax"):
        _assert_tables_equal(f"{j}.{ext}.parquet", f"{t}.{ext}.parquet", atol=1e-4)


def test_annotate_by_enrichment_cli_matches(annot_inputs):
    tmp, store = annot_inputs
    j, t = _both(["annotate-by-enrichment", "--data-files", store, "--clusters",
                  str(tmp / "cl.parquet"), "--markers", str(tmp / "m.gmt"), "--num-perm", "20",
                  "--bootstrap", "10"], tmp, "abe")
    _assert_tables_equal(f"{j}.annotation.parquet", f"{t}.annotation.parquet")
    ann = pd.read_parquet(f"{t}.annotation.parquet")
    assert sorted(ann["annotation"]) == ["factor0", "factor1", "factor2"]


def test_annotate_ontology_cli_matches(annot_inputs):
    tmp, store = annot_inputs
    j, t = _both(["annotate-ontology", "--data-files", store, "--clusters",
                  str(tmp / "cl.parquet"), "--obo", str(tmp / "o.obo"), "--gaf",
                  str(tmp / "g.gaf"), "--by", "module-score"], tmp, "ont")
    for ext in ("annotation", "module_score"):
        _assert_tables_equal(f"{j}.{ext}.parquet", f"{t}.{ext}.parquet")
    ann = pd.read_parquet(f"{t}.annotation.parquet")
    assert set(ann["annotation"]) <= {f"subtype{k}" for k in range(3)} | {f"type{k}" for k in range(3)}


def test_annotate_by_projection_cli_matches(annot_inputs):
    tmp, _ = annot_inputs
    rng = np.random.default_rng(7)
    lat = pd.read_parquet(tmp / "lat.parquet")
    cells = lat["cell"].to_numpy()
    z = np.exp(lat.iloc[:, 1:].to_numpy()) + rng.normal(0, 0.02, (len(cells), 3))
    train = tmp / "tr.parquet"
    pd.DataFrame({"cell": cells[:160], **{f"z{k}": z[:160, k] for k in range(3)}}).to_parquet(train)
    held = tmp / "ho.parquet"
    pd.DataFrame({"cell": cells[160:], **{f"z{k}": z[160:, k] for k in range(3)}}).to_parquet(held)
    j, t = _both(["annotate-by-projection", "--train-latent", str(train), "--train-clusters",
                  str(tmp / "cl.parquet"), "--latent", str(held), "--knn", "7"], tmp, "proj")
    _assert_tables_equal(f"{j}.annotation.parquet", f"{t}.annotation.parquet", atol=1e-5)
    # marker projection from a run with a feature embedding and a latent
    genes = pd.read_parquet(tmp / "dict.parquet")["gene"].to_numpy()
    fe = tmp / "run.feature_embedding.parquet"
    pd.DataFrame({"gene": genes, **{f"h{k}": rng.normal(size=len(genes)) for k in range(4)}}
                 ).to_parquet(fe)
    ce = tmp / "run.latent.parquet"
    pd.DataFrame({"cell": cells, **{f"h{k}": rng.normal(size=len(cells)) for k in range(4)}}
                 ).to_parquet(ce)
    (tmp / "run.gem.json").write_text(json.dumps(
        {"command": "bge", "outputs": {"feature_embedding": str(fe), "latent": str(ce)}}))
    j, t = _both(["annotate-by-projection", "--from", str(tmp / "run.gem.json"), "--markers",
                  str(tmp / "m.gmt")], tmp, "mproj")
    _assert_tables_equal(f"{j}.annotation.parquet", f"{t}.annotation.parquet", atol=1e-6)


# ---------------------------------------------------------------------------
# graceful stop
# ---------------------------------------------------------------------------


def test_stop_flag_roundtrip():
    stop.reset()
    assert not stop.stop_requested()
    stop._stop.set()
    assert stop.stop_requested()
    stop.reset()
    assert not stop.stop_requested()


def test_stop_before_training_writes_jax_artifacts(annot_inputs):
    """With the flag set before `train`, both packages' `senna topic` do no
    epoch and still write the same artifacts."""
    from legume_tpu.utils import stop as jstop

    tmp, store = annot_inputs
    argv = ["topic", "--data-files", store, "-k", "3", "--encoder-layers", "16",
            "--epochs", "20", "--minibatch-size", "32", "--num-levels", "1", "--sort-dim", "4",
            "--proj-dim", "8", "--iter-opt", "3", "--block-size", "128"]
    jstop._stop.set()
    stop._stop.set()
    try:
        j, t = _both(argv, tmp, "stopped")
    finally:
        jstop.reset()
        stop.reset()

    def artifacts(prefix):
        return sorted(p.name[len(Path(prefix).name):] for p in Path(prefix).parent.iterdir()
                      if p.name.startswith(Path(prefix).name + "."))

    assert artifacts(t) == artifacts(j)
    assert len(pd.read_parquet(f"{t}.log_likelihood.parquet")) == len(
        pd.read_parquet(f"{j}.log_likelihood.parquet")) == 0
    z = pd.read_parquet(f"{t}.latent.parquet").iloc[:, 1:].to_numpy()
    assert z.shape == (240, 3) and np.isfinite(z).all()
