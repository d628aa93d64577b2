"""`senna predict` / `eval-topic` through both packages, port on the CPU,
on one model saved by the JAX package and one held-out data set whose
genes are permuted, partly renamed to `ENSG..._<name>` and partly new:
the gene map, refinement, plug-in and iterated delta, the scored latent,
the residual matrix and the end-to-end outputs agree within the bars
stated per test; and the topic fit's per-cell refinement
(`--amort-refine-steps`) matches the JAX package's on the same weights."""

import types

import numpy as np
import pytest
import torch

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.senna import predict as jpred
from legume_tpu.senna import topic as jtopic
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.data.visitors import visit_columns_by_block
from legume_tpu_torch.senna import predict as tpred
from legume_tpu_torch.senna import topic as ttopic
from legume_tpu_torch.utils.output import read_table

FIT = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=3, block_size=256, num_levels=2,
           sort_dim=6)
BLOCK = 128  # predict's block: the held-out set spans several, the last one short


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    train = simulate_topic(rows=150, cols=400, factors=4, batches=2, seed=5)
    tpath = str(tmp / "train.zarr")
    create_sparse_from_csc(train.counts, tpath, train.row_names, train.col_names)
    model = str(tmp / "jm")
    jres = jtopic.fit_topic_model(jtopic.TopicArgs(
        data_files=[tpath], out=model, amort_refine_steps=3, minibatch_size=40, **FIT))

    # held out: another draw, genes permuted, 5% renamed, 5% new, two batches
    held = simulate_topic(rows=158, cols=300, factors=4, batches=2, seed=9)
    rng = np.random.default_rng(1)
    names = list(train.row_names) + [f"NEW{i}" for i in range(8)]
    for i in rng.choice(150, 8, replace=False):
        names[i] = f"ENSG{i:05d}_{names[i].upper()}"
    perm = rng.permutation(158)
    counts = held.counts.tocsr()[perm].tocsc()
    hpath = str(tmp / "held.zarr")
    create_sparse_from_csc(counts, hpath, [names[i] for i in perm], held.col_names)
    bfile = tmp / "held.batch.txt"
    bfile.write_text("\n".join(f"lab{'xy'[b]}" for b in held.batch) + "\n")
    return dict(tmp=tmp, tpath=tpath, model=model, jres=jres, hpath=hpath, bfile=str(bfile),
                held_batch=np.asarray(held.batch))


def _vecs(env):
    return jtopic.load_data_vec([env["hpath"]]), ttopic.load_data_vec([env["hpath"]])


def _remaps(env):
    _, _, genes = jtopic.load_model(env["model"])
    jv, tv = _vecs(env)
    return jpred.build_gene_remap(genes, jv.row_names()), tpred.build_gene_remap(genes, tv.row_names())


def _port_encoder(env):
    meta, flat, _ = ttopic.load_model(env["model"])
    return ttopic.build_model(meta, flat, device="cpu")[0]


def _jax_encoder(env):
    import jax
    import jax.numpy as jnp

    from legume_tpu.models.encoders import LogSoftmaxEncoder

    meta, variables, _ = jtopic.load_model(env["model"])
    return (LogSoftmaxEncoder(n_topics=meta["n_topics"], layers=tuple(meta["encoder_layers"])),
            jax.tree.map(jnp.asarray, variables))


def test_gene_remap_equal(env):
    jr, tr = _remaps(env)
    np.testing.assert_array_equal(tr.new_to_train, jr.new_to_train)
    assert tr.d_train == jr.d_train == 150
    assert tr.n_mapped == 150  # every training gene found, the 8 renamed ones by token


def test_refine_topic_proportions_within_1e5():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n, d, k = 50, 80, 5
    log_z = np.log(rng.dirichlet(np.ones(k), n)).astype(np.float32)
    x = rng.poisson(2.0, (n, d)).astype(np.float32)
    log_dict = np.log(rng.dirichlet(np.ones(d), k).T).astype(np.float32)  # columns on the simplex
    want = np.asarray(jpred.refine_topic_proportions(
        jnp.asarray(log_z), jnp.asarray(x), jnp.asarray(log_dict), steps=10, lr=0.05, reg=0.5))
    got = tpred.refine_topic_proportions(
        torch.from_numpy(log_z), torch.from_numpy(x), torch.from_numpy(log_dict),
        steps=10, lr=0.05, reg=0.5).numpy()
    assert np.abs(got - log_z).max() > 1e-3  # the steps moved the latent
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _delta_inputs(env):
    _, _, genes = jtopic.load_model(env["model"])
    log_dict = jpred._load_log_dictionary(env["model"], genes)
    np.testing.assert_array_equal(tpred._load_log_dictionary(env["model"], genes), log_dict)
    theta = jpred._load_theta_mean(env["model"])
    np.testing.assert_allclose(tpred._load_theta_mean(env["model"]), theta, rtol=1e-6)
    phi = jpred._load_dispersion(env["model"], genes)
    np.testing.assert_array_equal(tpred._load_dispersion(env["model"], genes), phi)
    return genes, log_dict, theta, phi, env["held_batch"]


def test_plugin_delta_within_1e6(env):
    _, log_dict, theta, _, cb = _delta_inputs(env)
    jv, tv = _vecs(env)
    jr, tr = _remaps(env)
    want = jpred.estimate_plugin_delta(jv, jr, cb, log_dict, theta, block_size=BLOCK)
    got = tpred.estimate_plugin_delta(tv, tr, cb, log_dict, theta, block_size=BLOCK)
    assert got.shape == (150, 2) and not np.all(got == 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_iterated_delta_within_1e5(env):
    _, log_dict, theta, phi, cb = _delta_inputs(env)
    jv, tv = _vecs(env)
    jr, tr = _remaps(env)
    start = jpred.estimate_plugin_delta(jv, jr, cb, log_dict, theta, block_size=BLOCK)
    enc, variables = _jax_encoder(env)
    want = jpred.iterate_delta_dense(2, start, jv, enc, variables, jr, log_dict, phi, cb,
                                     block_size=BLOCK)
    got = tpred.iterate_delta_dense(2, start, tv, _port_encoder(env), tr, log_dict, phi, cb,
                                    block_size=BLOCK, device="cpu")
    assert np.abs(got - start).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("refine_steps", [0, 10])
def test_score_dense_backend_on_a_jax_model(env, refine_steps):
    genes, log_dict, _, _, cb = _delta_inputs(env)
    jv, tv = _vecs(env)
    jr, tr = _remaps(env)
    prof = jpred._batch_mean_profiles(jv, jr, cb, block_size=BLOCK)
    np.testing.assert_allclose(tpred._batch_mean_profiles(tv, tr, cb, block_size=BLOCK), prof,
                               rtol=1e-6, atol=1e-6)
    enc, variables = _jax_encoder(env)
    kw = dict(block_size=BLOCK, cell_batch=cb, batch_profiles=prof, log_dict=log_dict,
              refine_steps=refine_steps)
    want = jpred.score_dense_backend(jv, enc, variables, jr, **kw)
    got = tpred.score_dense_backend(tv, _port_encoder(env), tr, device="cpu", **kw)
    assert got.shape == (300, 4)
    tol = 1e-5 if refine_steps == 0 else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def e2e(env):
    out = {}
    for name, mod, kw in (("jax", jpred, {}), ("port", tpred, {"device": "cpu"})):
        args = mod.PredictArgs(
            data_files=[env["hpath"]], model=env["model"], out=str(env["tmp"] / f"p_{name}"),
            block_size=BLOCK, batch_files=[env["bfile"]], refine_steps=10, delta_iters=2,
            residual_out=str(env["tmp"] / f"res_{name}.zarr"), residual_include_delta=True,
        )
        out[name] = mod.predict_model(args, **kw)
    return out


def test_predict_end_to_end_latent_and_delta(env, e2e):
    np.testing.assert_allclose(e2e["port"], e2e["jax"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(e2e["port"]).sum(1), 1.0, atol=1e-5)
    tmp = env["tmp"]
    jt, tt = read_table(str(tmp / "p_jax.latent.parquet")), read_table(str(tmp / "p_port.latent.parquet"))
    assert list(tt) == list(jt) == ["cell", "topic0", "topic1", "topic2", "topic3"]
    np.testing.assert_array_equal(tt["cell"], jt["cell"])
    jd, td = read_table(str(tmp / "p_jax.delta.parquet")), read_table(str(tmp / "p_port.delta.parquet"))
    assert list(td) == list(jd) == ["gene", "batch0", "batch1"]
    np.testing.assert_array_equal(td["gene"], jd["gene"])
    for b in ("batch0", "batch1"):
        np.testing.assert_allclose(td[b], jd[b], rtol=1e-5, atol=1e-5)


def test_residual_matrix_within_1e5(env, e2e):
    from legume_tpu.data.sparse_io import open_sparse_matrix as jopen

    tmp = env["tmp"]
    jb, tb = jopen(str(tmp / "res_jax.zarr")), jopen(str(tmp / "res_port.zarr"))
    assert tb.shape == jb.shape == (158, 300)
    assert tb.row_names() == jb.row_names() and tb.column_names() == jb.column_names()
    jm, tm = jb.read_columns_csc(np.arange(300)), tb.read_columns_csc(np.arange(300))
    np.testing.assert_array_equal(tm.indptr, jm.indptr)
    np.testing.assert_array_equal(tm.indices, jm.indices)
    np.testing.assert_allclose(tm.data, jm.data, rtol=1e-5, atol=1e-5)


def test_decoder_only_within_1e4(env):
    out = {}
    for name, mod, kw in (("jax", jpred, {}), ("port", tpred, {"device": "cpu"})):
        args = mod.PredictArgs(data_files=[env["hpath"]], model=env["model"],
                               out=str(env["tmp"] / f"dec_{name}"), block_size=BLOCK,
                               decoder_only=True)
        out[name] = mod.predict_model(args, **kw)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-4, atol=1e-4)


def test_eval_topic_alias_through_the_cli(env, tmp_path):
    out = str(tmp_path / "cli")
    argv = ["senna", "eval-topic", "--data-files", env["hpath"], "--model", env["model"],
            "--out", out, "--block-size", str(BLOCK), "--batch-files", env["bfile"],
            "--refine-steps", "10", "--device", "cpu"]
    assert port_cli(argv) == 0
    want = tpred.score_dense_backend(
        ttopic.load_data_vec([env["hpath"]]), _port_encoder(env), _remaps(env)[1],
        block_size=BLOCK, cell_batch=env["held_batch"],
        batch_profiles=tpred._batch_mean_profiles(ttopic.load_data_vec([env["hpath"]]),
                                                  _remaps(env)[1], env["held_batch"],
                                                  block_size=BLOCK),
        log_dict=_delta_inputs(env)[1], refine_steps=10, device="cpu")
    t = read_table(out + ".latent.parquet")
    np.testing.assert_allclose(np.stack([t[f"topic{k}"] for k in range(4)], 1), want, atol=1e-6)
    assert (tmp_path / "cli.senna.json").exists()


@pytest.mark.parametrize("kind", ["masked-topic", "vae"])
def test_unported_model_kinds_raise(env, tmp_path, kind):
    """Both kinds are ported now (tests/test_torch_{masked,vae}.py); a
    topic model's weights relabelled as one: as a vae the trunk scores
    (latent `z{k}`, the mean heads), as a masked model the weights do not
    fit and loading raises."""
    import json
    import shutil

    src = env["model"]
    dst = str(tmp_path / "m")
    for suffix in ("model.npz", "genes.txt"):
        shutil.copy(f"{src}.{suffix}", f"{dst}.{suffix}")
    meta = json.loads(open(f"{src}.model.json").read())
    meta.update(model_type=kind, gene_names_file=f"{dst}.genes.txt")
    open(f"{dst}.model.json", "w").write(json.dumps(meta))
    args = tpred.PredictArgs(data_files=[env["hpath"]], model=dst, out=str(tmp_path / "o"))
    if kind == "masked-topic":
        with pytest.raises(KeyError, match="unknown masked-model parameter"):
            tpred.predict_model(args, device="cpu")
        return
    z = tpred.predict_model(args, device="cpu")
    t = read_table(str(tmp_path / "o.latent.parquet"))
    assert list(t)[1:] == [f"z{k}" for k in range(4)]
    x = tpred._dense_block(next(iter(visit_columns_by_block(ttopic.load_data_vec([env["hpath"]]),
                                                            block_size=4096))),
                           _remaps(env)[1], "cpu")
    with torch.no_grad():
        want = _port_encoder(env).latent_gaussian_params(x)[0].numpy()
    np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-6)


def test_topic_eval_refinement_matches_jax(env):
    """The fit's per-cell latent with 3 refinement steps, from the JAX
    fit's own weights, dictionary and residual plane: the port's
    `evaluate_latent_by_encoder` gives the JAX package's within 1e-4."""
    jres = env["jres"]
    finest = jres["levels"].collapsed[0]
    assert finest.mu_residual is None  # one batch: no null plane, in both packages
    finest_port = types.SimpleNamespace(mu_residual=None, delta=None)
    got = ttopic.evaluate_latent_by_encoder(
        ttopic.load_data_vec([env["tpath"]]), _port_encoder(env), finest_port,
        jres["levels"].groups_per_level[0], block_size=40 * 8,
        refine_log_dict=torch.from_numpy(np.asarray(jres["log_beta"], np.float32)),
        refine_steps=3, device="cpu",
    )
    plain = ttopic.evaluate_latent_by_encoder(
        ttopic.load_data_vec([env["tpath"]]), _port_encoder(env), finest_port,
        jres["levels"].groups_per_level[0], block_size=40 * 8, device="cpu",
    )
    assert np.abs(got - plain).max() > 1e-4  # the refinement moved the latent
    np.testing.assert_allclose(got, jres["latent"], rtol=1e-4, atol=1e-4)


def test_topic_fit_runs_with_refinement(env, tmp_path):
    res = ttopic.fit_topic_model(ttopic.TopicArgs(
        data_files=[env["tpath"]], out=str(tmp_path / "t"), amort_refine_steps=3,
        minibatch_size=40, **FIT), device="cpu")
    z = res["latent"]
    assert z.shape == (400, 4) and np.isfinite(z).all()
    np.testing.assert_allclose(np.exp(z).sum(1), 1.0, atol=1e-5)
