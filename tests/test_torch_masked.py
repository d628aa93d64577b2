"""The masked (indexed top-K) models through both packages, port on the
CPU: the windows equal JAX's on tied counts, the union equals
`jnp.unique`, each latent x likelihood gives JAX's loss and log theta at
the same parameters and mask, the held-out eval loss from JAX-trained
parameters equals JAX's, training from JAX's init follows JAX's trace
(the port draws JAX's key schedule), the eval loss of a port-initialised
run lies in the band of JAX's seeds, and the commands and predict run
with JAX's artifacts."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from flax import traverse_util

from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.models import indexed as jidx
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data import MemoryBackend
from legume_tpu_torch.models import indexed as tidx
from legume_tpu_torch.models.convert import masked_params_from_jax, masked_params_to_jax
from legume_tpu_torch.senna import predict as tpred
from legume_tpu_torch.utils.output import read_table

D, N, WIN, T, H = 60, 200, 16, 4, 8


def _counts(seed=0, d=D, n=N):
    """Small integer counts: nearly every cell ties at its 16th place."""
    rng = np.random.default_rng(seed)
    dense = rng.poisson(0.8, (d, n)).astype(np.float32) * (rng.random((d, n)) < 0.6)
    return sp.csc_matrix(dense)


@pytest.fixture(scope="module")
def counts():
    return _counts()


@pytest.fixture(scope="module")
def windows(counts):
    return tidx.build_topk_windows(MemoryBackend(counts), WIN, device="cpu")


def _flat(variables):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(variables, sep="/").items()}


def _jax_init(model, data, cfg, with_null: bool):
    """`train_masked`'s own init call, so that both packages start alike."""
    k_init, _ = jax.random.split(jax.random.key(cfg.seed))
    u_cap = min(cfg.union_size, data.n_genes + 1)
    ids0, vals0 = jnp.asarray(data.ids[: cfg.minibatch]), jnp.asarray(data.vals[: cfg.minibatch])
    return model.init(
        {"params": k_init, "reparam": k_init}, ids0, vals0, jnp.arange(u_cap, dtype=jnp.int32),
        jnp.zeros(u_cap), jnp.ones(u_cap, bool), jnp.zeros_like(vals0, bool), train=True,
        rngs_key=k_init, null_vals=jnp.zeros_like(vals0) if with_null else None,
    )


def _port_model(variables, latent="simplex", lik="nb", modules=0, with_null=False, d=D):
    model = tidx.MaskedTopicModel(d, T, embed_dim=H, hidden=16, latent=latent,
                                  masked_likelihood=lik, n_gene_modules=modules,
                                  with_null=with_null)
    model.load_state_dict(masked_params_from_jax(_flat(variables)))
    return model


@pytest.mark.parametrize("weighted", [False, True])
def test_topk_windows_equal_jax_on_ties(counts, weighted):
    w = None
    if weighted:
        w = np.tile(np.asarray([1.0, 0.5, 0.0, 2.0], np.float32), D // 4)
    got = tidx.build_topk_windows(MemoryBackend(counts), WIN, gene_weights=w, block_size=64,
                                  device="cpu")
    want = jidx.build_topk_windows(JMem(counts), WIN, gene_weights=w, block_size=64)
    dense = counts.toarray().T
    score = dense if w is None else dense * w
    kth = -np.sort(-score, axis=1)[:, WIN - 1]
    assert ((score == kth[:, None]).sum(1) > 1).mean() > 0.5  # ties at the K-th place
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.vals, want.vals)
    np.testing.assert_allclose(got.log_q, want.log_q, rtol=0, atol=1e-6)


@pytest.mark.parametrize("u_cap", [8, 40, 400])
def test_union_equals_jnp_unique(u_cap):
    rng = np.random.default_rng(u_cap)
    ids = rng.integers(0, 100, (12, 9)).astype(np.int32)
    ids[0, :4] = 100  # pads
    got = tidx.union_ids(torch.from_numpy(ids), u_cap, 100).numpy()
    want = np.asarray(jnp.unique(jnp.asarray(ids).reshape(-1), size=u_cap, fill_value=100))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(ids)) > 8  # the smallest cap cuts distinct ids


@pytest.mark.parametrize("lik", ["nb", "multinomial"])
@pytest.mark.parametrize("latent", ["simplex", "gaussian", "sbp"])
def test_masked_model_loss_and_theta_match_jax(windows, latent, lik):
    """Gene modules and a null stream on, the same explicit mask, eval
    and train mode (batch statistics; no noise)."""
    rng = np.random.default_rng(3)
    ids, vals = windows.ids[:32], windows.vals[:32]
    null = rng.uniform(0.2, 3.0, vals.shape).astype(np.float32)
    mask = (rng.random(vals.shape) < 0.3) & (vals > 0)
    jm = jidx.MaskedTopicModel(n_genes=D, n_topics=T, embed_dim=H, hidden=16, latent=latent,
                               masked_likelihood=lik, n_gene_modules=3)
    union = jnp.unique(jnp.asarray(ids).reshape(-1), size=64, fill_value=D)
    lq = jnp.asarray(windows.log_q)[union]
    args = (jnp.asarray(ids), jnp.asarray(vals), union, lq, union < D, jnp.asarray(mask))
    variables = jm.init({"params": jax.random.key(1)}, *args, train=False,
                        null_vals=jnp.asarray(null))
    variables = {**variables, "batch_stats": jax.tree.map(lambda a: a + 0.4,
                                                          variables["batch_stats"])}
    tm = _port_model(variables, latent, lik, 3, with_null=True)
    targs = tuple(torch.from_numpy(np.array(a)) for a in (ids, vals, union, lq, union < D, mask))
    for train in (False, True):
        if train:
            (jl, jt), _ = jm.apply(variables, *args, train=True, null_vals=jnp.asarray(null),
                                   mutable=["batch_stats"])
        else:
            jl, jt = jm.apply(variables, *args, train=False, null_vals=jnp.asarray(null))
        with torch.no_grad():
            tl, tt = tm(*targs, train=train, null_vals=torch.from_numpy(null))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


def test_masked_params_round_trip(windows):
    jm = jidx.MaskedTopicModel(n_genes=D, n_topics=T, embed_dim=H, latent="gaussian",
                               n_gene_modules=2)
    cfg = jidx.MaskedTrainConfig(minibatch=32)
    flat = _flat(_jax_init(jm, windows, cfg, with_null=True))
    back = masked_params_to_jax(masked_params_from_jax(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jax_run(windows):
    """JAX's `train_masked` (gene modules, a null stream, 3 epochs) and
    its init."""
    rng = np.random.default_rng(5)
    plane = np.zeros((D + 1, 3), np.float32)
    plane[:-1] = rng.uniform(0.3, 2.0, (D, 3))
    memb = rng.integers(0, 3, N).astype(np.int32)
    kw = dict(epochs=3, minibatch=32, learning_rate=5e-3, grad_clip=5.0, eval_mask_frac=0.2,
              eval_seed=4, seed=2, mask_schedule="uniform", feature_embedding_l2=1e-3,
              null_plane=plane, null_membership=memb)
    jm = jidx.MaskedTopicModel(n_genes=D, n_topics=T, embed_dim=H, hidden=16, n_gene_modules=2)
    jdata = jidx.IndexedData(ids=windows.ids, vals=windows.vals, log_q=windows.log_q, n_genes=D)
    init = _jax_init(jm, jdata, jidx.MaskedTrainConfig(**kw), with_null=True)
    variables, trace, eval_loss = jidx.train_masked(jm, jdata, jidx.MaskedTrainConfig(**kw))
    return dict(kw=kw, init=init, variables=variables, trace=trace, eval_loss=eval_loss, jm=jm)


def test_masked_eval_loss_from_jax_parameters(windows, jax_run):
    tm = _port_model(jax_run["variables"], modules=2, with_null=True)
    got = tidx.masked_eval_loss(tm, windows, tidx.MaskedTrainConfig(**jax_run["kw"]), device="cpu")
    assert abs(got - jax_run["eval_loss"]) <= 1e-5, (got, jax_run["eval_loss"])


def test_train_masked_follows_jax_from_its_init(windows, jax_run):
    """Same init, same key schedule (permutations, masks, rates, noise):
    the per-epoch losses and the eval loss follow JAX's within 1e-4."""
    tm = _port_model(jax_run["init"], modules=2, with_null=True)
    _, trace, eval_loss = tidx.train_masked(tm, windows, tidx.MaskedTrainConfig(**jax_run["kw"]),
                                            device="cpu")
    np.testing.assert_allclose(trace, jax_run["trace"], rtol=1e-4)
    assert abs(eval_loss - jax_run["eval_loss"]) <= 1e-4 * abs(jax_run["eval_loss"])
    z = tidx.encode_all(tm, windows, null_plane=jax_run["kw"]["null_plane"],
                        null_membership=jax_run["kw"]["null_membership"], device="cpu")
    np.testing.assert_allclose(np.exp(z).sum(1), 1.0, atol=1e-5)


# The JAX package's own spread over seeds 0, 1, 2 of the run below (its
# eval loss): computed in `test_train_masked_eval_loss_in_jax_band`.
BAND_KW = dict(epochs=4, minibatch=32, learning_rate=1e-2, eval_mask_frac=0.2, eval_seed=1)


def test_train_masked_eval_loss_in_jax_band(windows):
    """A port-initialised run's eval loss within the JAX package's mean
    over 3 seeds +- twice their spread (max - min)."""
    jdata = jidx.IndexedData(ids=windows.ids, vals=windows.vals, log_q=windows.log_q, n_genes=D)
    jl = [jidx.train_masked(jidx.MaskedTopicModel(n_genes=D, n_topics=T, embed_dim=H), jdata,
                            jidx.MaskedTrainConfig(**BAND_KW, seed=s))[2] for s in range(3)]
    spread = max(jl) - min(jl)
    tm = tidx.MaskedTopicModel(D, T, embed_dim=H, generator=torch.Generator().manual_seed(0))
    _, trace, got = tidx.train_masked(tm, windows, tidx.MaskedTrainConfig(**BAND_KW, seed=0),
                                      device="cpu")
    assert np.isfinite(trace).all() and trace[-1] < trace[0]
    assert abs(got - np.mean(jl)) <= 2 * spread, (got, jl)


@pytest.fixture(scope="module")
def files(tmp_path_factory, counts):
    tmp = tmp_path_factory.mktemp("masked")
    names = [f"g{i}" for i in range(D)]
    path = str(tmp / "train.zarr")
    create_sparse_from_csc(counts, path, names, [f"c{j}" for j in range(N)])
    held = _counts(seed=9, d=D + 4, n=90)
    rng = np.random.default_rng(2)
    hnames = names + [f"NEW{i}" for i in range(4)]
    perm = rng.permutation(D + 4)
    hpath = str(tmp / "held.zarr")
    create_sparse_from_csc(held.tocsr()[perm].tocsc(), hpath, [hnames[i] for i in perm],
                           [f"h{j}" for j in range(90)])
    bfile = tmp / "batch.txt"
    bfile.write_text("\n".join("ab"[j % 2] for j in range(N)) + "\n")
    return dict(tmp=tmp, path=path, hpath=hpath, bfile=str(bfile))


def _cli_argv(cmd, files, out, *extra):
    return ["senna", cmd, "--data-files", files["path"], "--out", out, "-k", str(T),
            "--window", str(WIN), "--embed-dim", str(H), "--epochs", "2", "--minibatch-size",
            "32", *extra]


@pytest.mark.parametrize("cmd", ["masked-topic", "masked-vae", "masked-sbp"])
def test_commands_write_jax_artifacts_and_predict_in_both(files, cmd):
    """Each command through the port's CLI (`--eval-mask-fraction`): JAX's
    artifact names and columns; JAX's predict of the port's model equals
    the port's predict within 1e-4."""
    from legume_tpu.senna import predict as jpred

    tmp = files["tmp"]
    out = str(tmp / f"port_{cmd}")
    extra = ["--gene-modules", "2"] if cmd == "masked-sbp" else []
    assert port_cli(_cli_argv(cmd, files, out, "--eval-mask-fraction", "0.2", *extra,
                              "--device", "cpu")) == 0
    col = "z" if cmd == "masked-vae" else "topic"
    lat = read_table(out + ".latent.parquet")
    assert list(lat) == ["cell", *[f"{col}{k}" for k in range(T)]]
    assert list(read_table(out + ".loss.parquet")) == ["epoch", "loss"]
    meta = json.loads(open(out + ".model.json").read())
    assert meta["model_type"] == cmd and meta["window"] == WIN and meta["embed_dim"] == H
    assert json.loads(open(out + ".eval.json").read())["eval_seed"] == 0
    assert json.loads(open(out + ".senna.json").read())["outputs"]["model"] == out + ".model.npz"
    got = tpred.predict_model(tpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                                out=out + "_tp"), device="cpu")
    want = jpred.predict_model(jpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                                 out=out + "_jp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert list(read_table(out + "_tp.latent.parquet")) == list(read_table(out + "_jp.latent.parquet"))


def test_jax_masked_model_predicts_in_port(files):
    """A model the JAX package trained and saved: the port's predict
    within 1e-4 of JAX's, and the same artifacts as JAX's command."""
    from legume_tpu.cli.senna_cli import run_senna as jax_cli
    from legume_tpu.senna import predict as jpred

    out = str(files["tmp"] / "jax_vae")
    jax_cli(_cli_argv("masked-vae", files, out, "--gene-modules", "2")[1:])
    port = str(files["tmp"] / "port_vae_cmp")
    port_cli(_cli_argv("masked-vae", files, port, "--gene-modules", "2", "--device", "cpu"))
    for suffix in ("latent.parquet", "loss.parquet", "model.npz", "model.json", "genes.txt",
                   "senna.json"):
        assert (files["tmp"] / f"jax_vae.{suffix}").exists()
        assert (files["tmp"] / f"port_vae_cmp.{suffix}").exists()
    assert set(np.load(out + ".model.npz").files) == set(np.load(port + ".model.npz").files)
    got = tpred.predict_model(tpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                                out=out + "_tp"), device="cpu")
    want = jpred.predict_model(jpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                                 out=out + "_jp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batch_null_model_predict_fails_in_both(files):
    """The reference's fault: a model trained with `--batch-files` pools a
    null stream that predict does not form. JAX's predict fails on it;
    the port's raises and names the cause."""
    from legume_tpu.senna import predict as jpred

    out = str(files["tmp"] / "nullm")
    assert port_cli(_cli_argv("masked-topic", files, out, "--batch-files", files["bfile"],
                              "--sort-dim", "3", "--iter-opt", "3", "--device", "cpu")) == 0
    assert json.loads(open(out + ".model.json").read())["model_type"] == "masked-topic"
    from flax.errors import ScopeParamShapeError

    with pytest.raises(ScopeParamShapeError, match="Dense_0"):
        jpred.predict_model(jpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                              out=out + "_jp"))
    with pytest.raises(ValueError, match="batch-null stream"):
        tpred.predict_model(tpred.PredictArgs(data_files=[files["hpath"]], model=out,
                                              out=out + "_tp"), device="cpu")


def test_data_parallel_raises(files, tmp_path):
    with pytest.raises(NotImplementedError, match="--data-parallel"):
        port_cli(_cli_argv("masked-topic", files, str(tmp_path / "dp"), "--data-parallel",
                           "--device", "cpu"))


def test_frozen_rho_rows_hold_and_follow_jax(windows):
    """`--frozen-features`: the frozen rows of rho keep their values
    through AdamW's decay, the others follow JAX's run from its init."""
    rng = np.random.default_rng(8)
    frozen = rng.standard_normal((D + 1, H)).astype(np.float32)
    fmask = (rng.random(D + 1) < 0.4).astype(np.float32)
    kw = dict(epochs=2, minibatch=32, learning_rate=1e-2, seed=3, frozen_rho_init=frozen,
              frozen_rho_mask=fmask)
    jm = jidx.MaskedTopicModel(n_genes=D, n_topics=T, embed_dim=H, hidden=16)
    jdata = jidx.IndexedData(ids=windows.ids, vals=windows.vals, log_q=windows.log_q, n_genes=D)
    init = _jax_init(jm, jdata, jidx.MaskedTrainConfig(**kw), with_null=False)
    jvars, jtrace, _ = jidx.train_masked(jm, jdata, jidx.MaskedTrainConfig(**kw))
    tm = _port_model(init)
    _, trace, _ = tidx.train_masked(tm, windows, tidx.MaskedTrainConfig(**kw), device="cpu")
    rho = tm.rho.detach().numpy()
    np.testing.assert_array_equal(rho[fmask > 0], frozen[fmask > 0])
    np.testing.assert_allclose(rho, np.asarray(jvars["params"]["rho"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-4)


def test_frozen_features_load_like_jax_and_pin_rows(files, tmp_path):
    """`load_frozen_features` (the port's own copy) matches JAX's on
    composite `ENSG..._SYMBOL` names either way; `--frozen-features`
    pins the matched genes' rho rows through training."""
    import pandas as pd

    from legume_tpu.data.knowledge import load_frozen_features as jload
    from legume_tpu_torch.data.knowledge import load_frozen_features as tload

    rng = np.random.default_rng(6)
    src = ["ENSG01_G1", "g3", "G5|x", "nope", "g7", "ENSG09_g9", "g1"]
    emb = rng.standard_normal((len(src), H)).astype(np.float32)
    path = str(tmp_path / "fe.parquet")
    pd.DataFrame(emb, index=src, columns=[f"h{i}" for i in range(H)]).reset_index(
        names="feature").to_parquet(path)
    targets = [f"g{i}" for i in range(D)] + ["ENSG77_G7"]
    got, want = tload(path, targets), jload(path, targets)
    np.testing.assert_array_equal(got.keep_target_indices, want.keep_target_indices)
    np.testing.assert_array_equal(got.e_feat, want.e_feat)
    assert got.h == want.h == H and len(got.keep_target_indices) == 6
    out = str(tmp_path / "frozen")
    assert port_cli(_cli_argv("masked-topic", files, out, "--frozen-features", path,
                              "--device", "cpu")) == 0
    from legume_tpu_torch.models.convert import masked_params_from_jax

    rho = masked_params_from_jax(dict(np.load(out + ".model.npz")))["rho"].numpy()
    ff = tload(path, [f"g{i}" for i in range(D)])
    np.testing.assert_array_equal(rho[ff.keep_target_indices], ff.e_feat)
