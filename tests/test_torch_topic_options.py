"""The `senna topic` options beyond the nb default, through both packages
on the same two zarr backends (one batch each; five genes named `MT-`),
port on the CPU: every decoder family and `--decoder a,b`, `--from`,
`--init-from`, `--max-coarse-features` and `--qc`; and models of every
family load and predict across the packages."""

import json

import numpy as np
import pytest

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.senna import predict as jpred
from legume_tpu.senna import topic as jtopic
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.senna import predict as tpred
from legume_tpu_torch.senna import topic as ttopic
from legume_tpu_torch.utils.output import read_table, table_path

COMMON = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=4, block_size=256, num_levels=2,
              preload_data=True)
MULTI = dict(decoder="nb-mixture,multinomial", decoder_weights=[1.0, 0.5], rho_prior_weight=10.0,
             max_coarse_features=100, qc=True)


def _fit(pkg, out, files, **kw):
    if pkg == "jax":
        return jtopic.fit_topic_model(jtopic.TopicArgs(data_files=files, out=out, **{**COMMON, **kw}))
    return ttopic.fit_topic_model(ttopic.TopicArgs(data_files=files, out=out, **{**COMMON, **kw}),
                                  device="cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("topic_options")
    sim = simulate_topic(rows=200, cols=600, factors=4, batches=2, seed=17)
    genes = [f"MT-{g}" if i < 5 else g for i, g in enumerate(sim.row_names)]
    counts = sim.counts.tocsc()
    files = []
    for b in range(2):
        cols = np.nonzero(sim.batch == b)[0]
        path = str(tmp / f"b{b}.zarr")
        create_sparse_from_csc(counts[:, cols], path, genes, [sim.col_names[j] for j in cols])
        files.append(path)
    # the mito threshold drops the cells above the 95th percentile
    mito = np.asarray(counts[:5].sum(0)).ravel() / np.asarray(counts.sum(0)).ravel()
    qc_cut = float(np.quantile(mito, 0.95))
    p = lambda name: str(tmp / name)  # noqa: E731
    runs = {
        "jbase": _fit("jax", p("jbase"), files, decoder="nb-mixture"),
        "jfrom": _fit("jax", p("jfrom"), [], decoder="multinomial", from_run=p("jbase"),
                      max_coarse_features=120),
        "jinit": _fit("jax", p("jinit"), files, decoder="nb-mixture", init_from=p("jbase"),
                      epochs=0),
        "jmd": _fit("jax", p("jmd"), files, qc_max_mito_frac=qc_cut, **MULTI),
        "tbase": _fit("port", p("tbase"), files, decoder="nb-mixture"),
        "tfrom": _fit("port", p("tfrom"), [], decoder="poisson", from_run=p("tbase")),
        "tinit": _fit("port", p("tinit"), files, decoder="nb-mixture", init_from=p("jbase"),
                      epochs=0),
        "tmd": _fit("port", p("tmd"), files, qc_max_mito_frac=qc_cut, **MULTI),
    }
    return dict(tmp=tmp, files=files, runs=runs, qc_cut=qc_cut, p=p)


def _predict(pkg, env, model, out):
    mod, kw = (jpred, {}) if pkg == "jax" else (tpred, {"device": "cpu"})
    args = mod.PredictArgs(data_files=[env["files"][0]], model=model, out=env["p"](out),
                           block_size=128)
    return mod.predict_model(args, **kw)


@pytest.mark.parametrize("run,family,coarse", [("jbase", "nb-mixture", False),
                                               ("jfrom", "multinomial", True)])
def test_jax_models_load_and_predict_in_port(env, run, family, coarse):
    """The port's loader took only `dictionary` and `log_phi` and sized
    every decoder at D: a JAX nb-mixture model raised KeyError on
    `log_alpha`, a multinomial one failed in `load_state_dict`."""
    model = env["p"](run)
    meta, flat, _ = ttopic.load_model(model)
    assert meta["decoder"] == family
    _, decoders = ttopic.build_model(meta, flat, device="cpu")
    assert [type(d).__name__ for d in decoders] == [
        {"nb-mixture": "NbMixtureTopicDecoder", "multinomial": "MultinomTopicDecoder"}[family]] * 2
    widths = [d.n_features for d in decoders]
    params = env["runs"][run]["variables"]["params"]
    assert widths == [params[f"decoder_{i}"]["dictionary"]["dictionary"].shape[1] for i in range(2)]
    assert (widths[0] < 200) == coarse
    got = _predict("port", env, model, f"{run}_port")
    ref = _predict("jax", env, model, f"{run}_jax")
    assert got.shape[1] == 4 and len(got) > 250
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_jax_loads_and_predicts_a_port_multi_decoder_model(env):
    """The port writes family j of level i under `params/decoder_{i}/{j}`
    (the JAX package's own `save_model` pickles the list, and its
    `load_model` cannot read that back)."""
    model = env["p"]("tmd")
    meta, variables, genes = jtopic.load_model(model)
    assert meta["decoder"] == MULTI["decoder"] and len(genes) == 200
    fams = variables["params"]["decoder_0"]
    assert set(fams) == {"0", "1"} and "log_alpha" in fams["0"] and set(fams["1"]) == {"dictionary"}
    assert fams["0"]["dictionary"]["dictionary"].shape[1] < 200  # coarsened
    ref = _predict("jax", env, model, "tmd_jax")
    got = _predict("port", env, model, "tmd_port")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    _, decoders = ttopic.build_model(*ttopic.load_model(model)[:2], device="cpu")
    assert all(isinstance(lvl, list) and len(lvl) == 2 for lvl in decoders)
    # the reference fault the port does not copy: the JAX package cannot
    # read back its own multi-decoder model
    with pytest.raises(ValueError, match="allow_pickle"):
        jtopic.load_model(env["p"]("jmd"))


def test_cell_qc_matches_jax(env):
    from legume_tpu.data.qc import compute_cell_qc as jqc
    from legume_tpu_torch.data.qc import compute_cell_qc as tqc

    jv, tv = jtopic.load_data_vec(env["files"]), ttopic.load_data_vec(env["files"])
    want, got = jqc(jv, block_size=256), tqc(tv, block_size=256, device="cpu")
    for field in ("total", "n_genes", "mito_frac"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.mito_frac.max() > 0
    kw = dict(min_total=1000.0, min_genes=150, max_mito_frac=env["qc_cut"])
    np.testing.assert_array_equal(got.keep_mask(**kw), want.keep_mask(**kw))
    assert got.report() == want.report()
    # the tables of the two qc fits: the same cells kept
    jt = read_table(str(env["tmp"] / "jmd.qc.parquet"))
    tt = read_table(table_path(env["p"]("tmd.qc")))
    assert list(tt) == list(jt) == ["cell", "total", "n_genes", "mito_frac", "keep"]
    for col in jt:
        np.testing.assert_array_equal(tt[col], jt[col], err_msg=col)
    assert 0 < (~tt["keep"]).sum() < 60
    assert len(env["runs"]["tmd"]["latent"]) == int(tt["keep"].sum())


def test_feature_coarsening_set_partition_and_expansion(env):
    from legume_tpu.ops.feature_coarsening import FeatureCoarsening as JFC
    from legume_tpu.ops.feature_coarsening import compute_feature_coarsening as jcfc
    from legume_tpu_torch.ops.feature_coarsening import compute_feature_coarsening as tcfc

    profile = env["runs"]["tbase"]["levels"].collapsed[0].mu_observed.mean().numpy()
    for target in (120, 60):
        want, got = jcfc(profile, target, seed=7), tcfc(profile, target, seed=7, device="cpu")
        pairs = np.unique(np.stack([want.fine_to_coarse, got.fine_to_coarse], 1), axis=0)
        assert len(pairs) == want.num_coarse == got.num_coarse  # a bijection of groups
        jfc = JFC(fine_to_coarse=got.fine_to_coarse, num_coarse=got.num_coarse)
        ld = np.log(np.random.default_rng(target).dirichlet(np.ones(got.num_coarse), 4).T)
        np.testing.assert_array_equal(got.expand_log_dict_dk(ld), jfc.expand_log_dict_dk(ld))
        np.testing.assert_array_equal(got.group_sizes(), jfc.group_sizes())
        np.testing.assert_allclose(got.aggregate_rows_ds(profile), jfc.aggregate_rows_ds(profile),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.aggregate_columns_nd(profile.T),
                                   jfc.aggregate_columns_nd(profile.T), rtol=1e-6, atol=1e-6)


def test_from_reuses_the_partition(env):
    runs = env["runs"]
    base, reuse, jreuse = runs["tbase"]["levels"], runs["tfrom"]["levels"], runs["jfrom"]["levels"]
    for other in (reuse, jreuse, runs["jbase"]["levels"]):
        for a, b in zip(base.groups_per_level, other.groups_per_level, strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(base.level_maps, other.level_maps, strict=True):
            np.testing.assert_array_equal(a, b)
    assert "sort_refine_s" not in runs["tfrom"]["timings"]
    man = json.loads((env["tmp"] / "tfrom.senna.json").read_text())
    assert man["inputs"]["data_files"] == env["files"] and man["params"]["decoder"] == "poisson"
    assert table_path(env["p"]("tfrom.dispersion")) is None  # poisson has no dispersion
    # --qc subsets the cells after the partition is read: a partition of
    # all cells no longer fits, as in the JAX package
    with pytest.raises(ValueError, match="partition covers 600 cells"):
        _fit("port", env["p"]("tfrom_qc"), [], from_run=env["p"]("tbase"), qc=True,
             qc_max_mito_frac=env["qc_cut"])


def test_init_from_at_zero_epochs_latent_within_1e4(env):
    runs = env["runs"]
    assert runs["tinit"]["scores"].llik == [] and len(runs["jinit"]["scores"].llik) == 0
    np.testing.assert_allclose(runs["tinit"]["latent"], runs["jinit"]["latent"], rtol=1e-4, atol=1e-4)
    # the warm start took the saved weights, not the anchor init
    np.testing.assert_allclose(runs["tinit"]["log_beta"], runs["jinit"]["log_beta"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="architecture mismatch"):
        _fit("port", env["p"]("tinit_k5"), env["files"], init_from=env["p"]("jbase"),
             n_latent_topics=5, epochs=0)


def test_multi_decoder_coarsened_fit_elbo_band_and_artifacts(env):
    jl = np.asarray(env["runs"]["jmd"]["scores"].llik)
    res = env["runs"]["tmd"]
    tl = np.asarray(res["scores"].llik)
    assert len(tl) == COMMON["epochs"] and np.isfinite(tl).all()
    assert abs(tl[-1] - jl[-1]) / abs(jl[-1]) < 0.02, (tl[-1], jl[-1])
    assert [fc.num_coarse for fc in res["coarsenings"]] == _jax_coarse(env)
    out = env["p"]("tmd")
    for stem in ("dictionary", "nb-mixture.dictionary", "multinomial.dictionary",
                 "nb-mixture.dispersion", "nb-mixture.alpha", "nb-mixture.rho"):
        assert table_path(f"{out}.{stem}") is not None, stem
    alpha = read_table(table_path(f"{out}.nb-mixture.alpha"))["alpha"]
    np.testing.assert_allclose(alpha.sum(), 1.0, rtol=1e-4)
    phi = read_table(table_path(f"{out}.nb-mixture.dispersion"))["dispersion"]
    assert (phi > 0).all() and len(phi) == 200
    assert set(read_table(table_path(f"{out}.nb-mixture.rho"))["coef"]) == {"rho_a", "rho_b"}
    dic = read_table(table_path(f"{out}.multinomial.dictionary"))
    beta = np.exp(np.stack([dic[f"topic{k}"] for k in range(4)], 1))
    np.testing.assert_allclose(beta.sum(0), 1.0, atol=1e-3)
    z = res["latent"]
    assert np.isfinite(z).all()
    np.testing.assert_allclose(np.exp(z).sum(-1), 1.0, rtol=1e-3)


def _jax_coarse(env):
    """Each level's coarse width in the JAX multi-decoder fit."""
    dec = env["runs"]["jmd"]["variables"]["params"]
    return [dec[f"decoder_{i}"][0]["dictionary"]["dictionary"].shape[1] for i in range(2)]
