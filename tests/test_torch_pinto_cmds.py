"""The `pinto` commands through both packages, the port on the CPU, on a
planted-domain lattice (integer coordinates, so both packages build the
same spatial graph): `lc` (plain, and with batches, QC, gene-count
filter and mutual pairs), `lc --gene-network`, `cascade`, `prop`
(both forms), `dsvd`, `cage`, `lc-etm`, `lra`, `annotate`,
`interfaces` and `p`, and the two `pinto` parser trees."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
from flax import traverse_util

from legume_tpu.cli.main import run_pinto as j_pinto
from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.models import indexed as jidx
from legume_tpu.pinto import gene_network as jgn
from legume_tpu.pinto import lc as jlc
from legume_tpu.pinto import lc_etm as jetm
from legume_tpu.pinto import lra as jlra
from legume_tpu_torch.cli.main import run_pinto as t_pinto
from legume_tpu_torch.data import MemoryBackend as TMem
from legume_tpu_torch.models import indexed as tidx
from legume_tpu_torch.models.convert import masked_params_from_jax
from legume_tpu_torch.pinto import cage as tcage
from legume_tpu_torch.pinto import gene_network as tgn
from legume_tpu_torch.pinto import lc_etm as tetm
from legume_tpu_torch.pinto import lra as tlra
from torch_cpu import one_thread

SIDE, D, K = 12, 40, 3


def _lattice(seed=9):
    """SIDE x SIDE cells in three vertical stripes, each with its own 10
    marker genes over a shared background; a ligand (g36) and its
    receptor (g37) both raised in the middle stripe."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(SIDE), np.arange(SIDE))
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)
    domain = np.minimum((coords[:, 0] * K // SIDE).astype(int), K - 1)
    rates = np.full((K, D), 0.6)
    for c in range(K):
        rates[c, 10 * c : 10 * c + 10] = 5.0
    rates[1, 36:38] = 4.0
    counts = rng.poisson(rates[domain]).astype(np.float32).T  # [D, N]
    return coords, domain, counts


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pinto")
    coords, domain, counts = _lattice()
    n = counts.shape[1]
    genes = [f"g{i}" for i in range(D)]
    cells = [f"c{j}" for j in range(n)]
    store = str(tmp / "x.zarr")
    create_sparse_from_csc(sp.csc_matrix(counts), store, genes, cells)
    cf = tmp / "xy.tsv"
    cf.write_text("".join(f"c{j}\t{coords[j, 0]:.1f}\t{coords[j, 1]:.1f}\n" for j in range(n)))
    bf = tmp / "b.txt"
    bf.write_text("\n".join(f"s{int(y >= SIDE // 2)}" for y in coords[:, 1]) + "\n")
    gmt = tmp / "markers.gmt"
    gmt.write_text("".join(f"type{c}\tna\t" + "\t".join(genes[10 * c : 10 * c + 10]) + "\n"
                           for c in range(K)))
    net = tmp / "net.tsv"
    net.write_text("".join(f"g{i}\tg{i + s}\n" for base in range(0, 30, 10)
                           for i in range(base, base + 8) for s in (1, 2)))
    pairs = tmp / "lr.tsv"
    pairs.write_text("g36\tg37\ng0\tg25\n")
    return dict(tmp=tmp, store=store, coords=str(cf), batch=str(bf), gmt=str(gmt),
                net=str(net), pairs=str(pairs), xy=coords, domain=domain, counts=counts,
                genes=genes, cells=cells)


def _run_both(files, cmd, *extra, device=True):
    outs = {}
    for tag, run in (("j", j_pinto), ("t", t_pinto)):
        out = str(files["tmp"] / f"{tag}_{cmd}_{abs(hash(extra)) % 10**6}")
        dev = ["--device", "cpu"] if (tag == "t" and device) else []
        run([cmd, *extra, "--out", out, *dev])
        outs[tag] = out
    return outs["j"], outs["t"]


def _same_up_to_relabel(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a)) == len(set(b))


LC_VARIANTS = {
    "defaults": ["-k", "3", "--knn", "6", "--sweeps", "12", "--num-greedy", "5",
                 "--em-sweeps", "4", "--seed", "2"],
    "batch_qc_filter_mutual": ["-k", "3", "--knn", "8", "--sweeps", "10", "--em-sweeps", "3",
                               "--qc", "--qc-min-total", "40", "--min-gene-count", "60",
                               "--reciprocal", "--seed", "5"],
}


@pytest.mark.parametrize("variant", list(LC_VARIANTS))
def test_lc_cli_matches_jax(files, variant):
    extra = LC_VARIANTS[variant]
    if variant != "defaults":
        extra = extra + ["--batch-files", files["batch"]]
    j, t = _run_both(files, "lc", "--data-files", files["store"], "--coords", files["coords"],
                     *extra)
    ej, et = pd.read_parquet(j + ".edges.parquet"), pd.read_parquet(t + ".edges.parquet")
    pd.testing.assert_frame_equal(et, ej, check_dtype=False)
    pj, pt = pd.read_parquet(j + ".propensity.parquet"), pd.read_parquet(t + ".propensity.parquet")
    assert list(pt.columns) == list(pj.columns) and list(pt["cell"]) == list(pj["cell"])
    np.testing.assert_allclose(pt.iloc[:, 1:].to_numpy(), pj.iloc[:, 1:].to_numpy(), atol=1e-6)
    tj, tt = pd.read_parquet(j + ".score_trace.parquet"), pd.read_parquet(t + ".score_trace.parquet")
    assert list(tt["phase"]) == list(tj["phase"])
    np.testing.assert_allclose(tt["score"], tj["score"], rtol=1e-5)
    gj, gt = (pd.read_parquet(p + ".gene_community.parquet") for p in (j, t))
    assert list(gt["gene"]) == list(gj["gene"])
    np.testing.assert_allclose(gt.iloc[:, 1:].to_numpy(), gj.iloc[:, 1:].to_numpy(), rtol=1e-5)
    cj, ct = (pd.read_parquet(p + ".consensus.parquet") for p in (j, t))
    pd.testing.assert_frame_equal(ct, cj, check_dtype=False)
    mj, mt = (json.loads(open(p + ".metadata.json").read()) for p in (j, t))
    assert mt["command"] == mj["command"] == "lc"
    assert {k: os.path.basename(v) for k, v in mt["outputs"].items()} == \
        {k: os.path.basename(v).replace("j_", "t_", 1) for k, v in mj["outputs"].items()}
    if variant == "defaults":
        lab = pt.iloc[:, 1:4].to_numpy().argmax(1)
        assert _same_up_to_relabel(lab, files["domain"])


def test_lc_data_parallel_raises(files):
    """`lc --data-parallel` with no process group is a world of one: the
    plain run's tables."""
    argv = ["lc", "--data-files", files["store"], "--coords", files["coords"], "--device", "cpu"]
    tmp = files["tmp"]
    with one_thread():
        t_pinto(argv + ["--out", str(tmp / "lc_plain")])
        t_pinto(argv + ["--out", str(tmp / "lc_dp"), "--data-parallel"])
    for name in ("propensity", "edges", "score_trace", "gene_community", "consensus"):
        pd.testing.assert_frame_equal(pd.read_parquet(tmp / f"lc_dp.{name}.parquet"),
                                      pd.read_parquet(tmp / f"lc_plain.{name}.parquet"))


def test_gene_network_modules_and_profiles_match_jax(files):
    """The same network file: SNN-augmented graph, k-core, Leiden modules
    and the module-pair basis equal; the module sums (K3's plain version)
    within 1e-5; the pair profiles' pattern equal, values within 1e-5."""
    jb = JMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    tb = TMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    graphs = [m.GenePairGraph.from_edge_list(files["net"], files["genes"]) for m in (jgn, tgn)]
    for g in graphs:
        g.augment_with_snn(2)
    np.testing.assert_array_equal(graphs[1].edges, graphs[0].edges)
    keep = jgn.kcore_trim(graphs[0], 2)
    np.testing.assert_array_equal(tgn.kcore_trim(graphs[1], 2), keep)
    mog = jgn.leiden_gene_modules(graphs[0], keep, resolution=1.0, seed=3)
    np.testing.assert_array_equal(tgn.leiden_gene_modules(graphs[1], keep, resolution=1.0, seed=3),
                                  mog)
    bj = jgn.ModulePairBasis.build(graphs[0], mog)
    bt = tgn.ModulePairBasis.build(graphs[1], mog)
    np.testing.assert_array_equal(bt.pairs, bj.pairs)
    np.testing.assert_allclose(bt.null_ab, bj.null_ab)
    w = np.random.default_rng(0).uniform(0.5, 1.5, D).astype(np.float32)
    ej, tj = jgn.build_module_expression(jb, mog, bj.n_modules, gene_weights=w, block_size=50)
    et, tt = tgn.build_module_expression(tb, mog, bt.n_modules, gene_weights=w, block_size=50,
                                         device="cpu")
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    np.testing.assert_allclose(tt, tj, rtol=1e-5)
    edges = jlc.spatial_knn_edges(files["xy"], 6)
    pj = jgn.module_pair_edge_profiles(ej, tj, edges, bj)
    pt = tgn.module_pair_edge_profiles(et, tt, edges, bt)
    np.testing.assert_array_equal(pt.indptr, pj.indptr)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    np.testing.assert_allclose(pt.data, pj.data, rtol=1e-5)


def test_lc_gene_network_cli_matches_jax(files):
    j, t = _run_both(files, "lc", "--data-files", files["store"], "--coords", files["coords"],
                     "-k", "3", "--knn", "6", "--sweeps", "10", "--em-sweeps", "3",
                     "--gene-network", files["net"], "--seed", "4")
    ej, et = pd.read_parquet(j + ".edges.parquet"), pd.read_parquet(t + ".edges.parquet")
    np.testing.assert_array_equal(et[["src", "dst"]].to_numpy(), ej[["src", "dst"]].to_numpy())
    assert (et["community"].to_numpy() == ej["community"].to_numpy()).mean() >= 0.95


def test_cascade_cli_matches_jax(files):
    j, t = _run_both(files, "cascade", "--data-files", files["store"], "--coords",
                     files["coords"], "--levels", "3", "2", "--knn", "6", "--sweeps", "12")
    ej, et = pd.read_parquet(j + ".edges.parquet"), pd.read_parquet(t + ".edges.parquet")
    pd.testing.assert_frame_equal(et, ej, check_dtype=False)
    pj, pt = (pd.read_parquet(p + ".propensity.parquet") for p in (j, t))
    assert list(pt.columns) == list(pj.columns)
    np.testing.assert_allclose(pt.iloc[:, 1:].to_numpy(), pj.iloc[:, 1:].to_numpy(), atol=1e-6)


@pytest.mark.parametrize("method", ["kmeans", "leiden"])
def test_prop_cli_matches_jax(files, method):
    j, t = _run_both(files, "prop", "--data-files", files["store"], "--coords", files["coords"],
                     "--method", method, "-k", "3", "--knn", "6", "--proj-dim", "8")
    ej, et = pd.read_parquet(j + ".edges.parquet"), pd.read_parquet(t + ".edges.parquet")
    np.testing.assert_array_equal(et[["src", "dst"]].to_numpy(), ej[["src", "dst"]].to_numpy())
    assert _same_up_to_relabel(et["community"], ej["community"])


def _sign_aligned(a, b):
    s = np.sign((a * b).sum(0))
    return a * np.where(s == 0, 1.0, s)[None, :]


def test_dsvd_and_prop_latent_match_jax(files):
    """dsvd's factors equal JAX's up to sign where the singular values
    lie 5% apart (the rSVD's fragility elsewhere); `prop --latent` on
    each package's own factors gives the same labels up to relabelling."""
    j, t = _run_both(files, "dsvd", "--data-files", files["store"], "--coords", files["coords"],
                     "--rank", "4", "--knn", "6")
    fj, ft = (pd.read_parquet(p + ".pair_factors.parquet") for p in (j, t))
    np.testing.assert_array_equal(ft[["src", "dst"]].to_numpy(), fj[["src", "dst"]].to_numpy())
    a, b = ft.iloc[:, 2:].to_numpy(), fj.iloc[:, 2:].to_numpy()
    s = np.linalg.norm(b, axis=0)
    gap = np.ones(len(s), bool)
    rel = np.abs(np.diff(s)) / s[:-1]
    gap[:-1] &= rel > 0.05
    gap[1:] &= rel > 0.05
    assert gap.any()
    np.testing.assert_allclose(_sign_aligned(a, b)[:, gap], b[:, gap], rtol=1e-3,
                               atol=1e-3 * np.abs(b).max())
    for basis in ("shared_basis", "diff_basis"):
        bj, bt = (pd.read_parquet(f"{p}.{basis}.parquet") for p in (j, t))
        assert list(bt["gene"]) == list(bj["gene"])
    assert open(t + ".cells.txt").read() == open(j + ".cells.txt").read()
    labels = []
    for tag, run, src in (("j", j_pinto, j), ("t", t_pinto, t)):
        out = str(files["tmp"] / f"{tag}_prop_latent")
        run(["prop", "--latent", src + ".pair_factors.parquet", "--out", out, "-k", "3"]
            + (["--device", "cpu"] if tag == "t" else []))
        labels.append(pd.read_parquet(out + ".edges.parquet")["community"].to_numpy())
        assert list(pd.read_parquet(out + ".propensity.parquet")["cell"]) == files["cells"]
    assert _same_up_to_relabel(labels[1], labels[0])


def test_cage_follows_jax(files):
    """The activity gate (K1's plain version) equals JAX's within 1e-5,
    and the embedding follows fne's trace within 1e-4 (its own band)."""
    from legume_tpu.pinto import cage as jcage

    jb = JMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    tb = TMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    kw = dict(embedding_dim=6, knn=6, proj_dim=8, epochs=60, seed=3)
    j = jcage.fit_cage(jb, files["xy"], **kw)
    t = tcage.fit_cage(tb, files["xy"], device="cpu", **kw)
    np.testing.assert_array_equal(t.edges, j.edges)
    np.testing.assert_allclose(t.edge_weights, j.edge_weights, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.losses, j.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.embedding, j.embedding, rtol=0, atol=1e-4)
    out = t_pinto(["cage", "--data-files", files["store"], "--coords", files["coords"], "--out",
                   str(files["tmp"] / "cage"), "--epochs", "5", "-d", "4", "--device", "cpu"])
    assert out is None
    lat = pd.read_parquet(str(files["tmp"] / "cage.latent.parquet"))
    assert list(lat.columns) == ["cell", "h0", "h1", "h2", "h3"] and len(lat) == SIDE * SIDE


def _flat(variables):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(variables, sep="/").items()}


def test_lc_etm_follows_jax_from_its_init(files, monkeypatch):
    """The edge windows equal JAX's; from JAX's init (carried across by
    `models/convert.py`) the loss trace follows JAX's within 1e-4 and the
    edge topic proportions within 1e-4."""
    jb = JMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    tb = TMem(sp.csc_matrix(files["counts"]), files["genes"], files["cells"])
    kw = dict(n_communities=3, knn=6, window=16, embed_dim=8, epochs=4, minibatch=64, seed=5)
    j = jetm.fit_lc_etm(jb, files["xy"], **kw)
    edges = jlc.spatial_knn_edges(files["xy"], 6)
    prof = jlc.edge_profiles(jb, edges).tocsr()
    win = tetm.edge_windows(prof, 16)
    ids = np.full((len(edges), 16), D, np.int32)
    for i in range(len(edges)):  # the JAX package's loop
        row = prof.getrow(i)
        order = np.argsort(-row.data)[:16]
        ids[i, : len(order)] = row.indices[order]
    np.testing.assert_array_equal(win.ids, ids)
    jm = jidx.MaskedTopicModel(n_genes=D, n_topics=3, embed_dim=8)
    k_init, _ = jax.random.split(jax.random.key(5))
    u_cap = min(jidx.MaskedTrainConfig().union_size, D + 1)
    ids0, vals0 = jnp.asarray(win.ids[:64]), jnp.asarray(win.vals[:64])
    init = jm.init({"params": k_init, "reparam": k_init}, ids0, vals0,
                   jnp.arange(u_cap, dtype=jnp.int32), jnp.zeros(u_cap), jnp.ones(u_cap, bool),
                   jnp.zeros_like(vals0, bool), train=True, rngs_key=k_init, null_vals=None)
    tm = tidx.MaskedTopicModel(D, 3, embed_dim=8)
    tm.load_state_dict(masked_params_from_jax(_flat(init)))
    monkeypatch.setattr(tetm, "MaskedTopicModel", lambda *a, **k: tm)
    t = tetm.fit_lc_etm(tb, files["xy"], device="cpu", **kw)
    np.testing.assert_array_equal(t.edges, j.edges)
    np.testing.assert_allclose(t.loss_trace, j.loss_trace, rtol=1e-4)
    np.testing.assert_allclose(t.edge_theta, j.edge_theta, atol=1e-4)
    np.testing.assert_allclose(t.propensity, j.propensity, atol=1e-4)


def test_lc_etm_cli_runs(files):
    out = str(files["tmp"] / "etm")
    t_pinto(["lc-etm", "--data-files", files["store"], "--coords", files["coords"], "--out", out,
             "-k", "3", "--knn", "6", "--window", "16", "--embed-dim", "8", "--epochs", "3",
             "--minibatch-size", "64", "--device", "cpu"])
    prop = pd.read_parquet(out + ".propensity.parquet")
    np.testing.assert_allclose(prop.iloc[:, 1:].to_numpy().sum(1), 1.0, atol=1e-5)
    assert list(pd.read_parquet(out + ".edges.parquet").columns) == ["src", "dst", "community"]


def test_lra_matches_jax(files):
    """`tests/test_lra.py`'s coupled pair: Moran's I within 1e-6, the
    activities, null means and p-values equal (the same numpy null)."""
    rng = np.random.default_rng(0)
    n, d = 600, 300
    coords = rng.uniform(0, 10, size=(n, 2))
    field = np.exp(-((coords[:, 0] - 3) ** 2 + (coords[:, 1] - 5) ** 2) / 2)
    expr = rng.gamma(2, 0.3, size=(n, d))
    expr[:, 0] = 8 * field + rng.gamma(2, 0.1, n)
    expr[:, 1] = 8 * field + rng.gamma(2, 0.1, n)
    expr[:, 2] = rng.permutation(expr[:, 0])
    genes = ["LIG", "REC", "SHUF"] + [f"g{i}" for i in range(d - 3)]
    edges = jlc.spatial_knn_edges(coords, 8)
    w = sp.csr_matrix((np.ones(2 * len(edges)), (np.r_[edges[:, 0], edges[:, 1]],
                                                  np.r_[edges[:, 1], edges[:, 0]])), shape=(n, n))
    np.testing.assert_allclose(tlra.morans_i(expr, w), jlra.morans_i(expr, w), rtol=1e-6)
    args = (expr, genes, coords, [("LIG", "REC"), ("SHUF", "REC"), ("g5", "g9")])
    j = jlra.run_lra(*args, knn=8, n_null=100, seed=1)
    t = tlra.run_lra(*args, knn=8, n_null=100, seed=1, device="cpu")
    assert t.ligand == j.ligand and t.receptor == j.receptor
    np.testing.assert_array_equal(t.pvalue, j.pvalue)
    np.testing.assert_allclose(t.activity, j.activity, rtol=1e-12)
    np.testing.assert_allclose(t.null_mean, j.null_mean, rtol=1e-12)
    assert t.pvalue[0] < 0.05


def test_lra_annotate_interfaces_and_p_clis_match_jax(files):
    pytest.importorskip("matplotlib")
    jl, tl = _run_both(files, "lra", "--data-files", files["store"], "--coords", files["coords"],
                       "--pairs", files["pairs"], "--knn", "6", "--permutations", "30")
    pd.testing.assert_frame_equal(pd.read_parquet(tl + ".lra.parquet"),
                                  pd.read_parquet(jl + ".lra.parquet"))
    lc = str(files["tmp"] / "lc_for_figs")
    t_pinto(["lc", "--data-files", files["store"], "--coords", files["coords"], "--out", lc,
             "-k", "3", "--knn", "6", "--sweeps", "8", "--em-sweeps", "2", "--device", "cpu"])
    ja, ta = _run_both(files, "annotate", "--data-files", files["store"], "--edges",
                       lc + ".edges.parquet", "--markers", files["gmt"], device=False)
    pd.testing.assert_frame_equal(pd.read_parquet(ta + ".annotation.parquet"),
                                  pd.read_parquet(ja + ".annotation.parquet"))
    ji, ti = _run_both(files, "interfaces", "--coords", files["coords"], "--propensity",
                       lc + ".propensity.parquet", "--edges", lc + ".edges.parquet", device=False)
    pd.testing.assert_frame_equal(pd.read_csv(ti + ".interfaces.tsv", sep="\t"),
                                  pd.read_csv(ji + ".interfaces.tsv", sep="\t"))
    assert os.path.exists(ti + ".interfaces.pdf")
    jp, tp = _run_both(files, "p", "--coords", files["coords"], "--from", lc, "--lra",
                       tl + ".lra.parquet", "--data-files", files["store"], "--lr-max-p", "1.0",
                       "--top-lr", "1", device=False)
    fj, ft = (json.loads(open(os.path.join(p, "figures.json")).read()) for p in (jp, tp))
    assert sorted(ft) == sorted(fj) == ["heatmaps", "lr", "mesh", "propensity"]
    assert all(os.path.exists(f) for v in ft.values() for f in ([v] if isinstance(v, str) else v))
    one = str(files["tmp"] / "hex.png")
    t_pinto(["p", "--coords", files["coords"], "--values", lc + ".propensity.parquet",
             "--out", one])
    assert os.path.getsize(one) > 0


class _Parsed(Exception):
    pass


def _subparsers(run, monkeypatch):
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        run(["lc"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or (a.dest,)): (a.dest, a.default, a.nargs,
                                                            getattr(a.type, "__name__", a.type),
                                                            a.choices, a.required)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_pinto_parser_carries_jax_flags_and_defaults(monkeypatch):
    got, want = _subparsers(t_pinto, monkeypatch), _subparsers(j_pinto, monkeypatch)
    assert list(got) == list(want)
    for cmd in want:
        flags = dict(got[cmd])
        if cmd in ("lc", "cascade", "prop", "dsvd", "cage", "lc-etm", "lra"):
            assert flags.pop(("--device",))[1] == "cuda"
        assert flags == want[cmd], cmd


def test_main_dispatches_pinto(files, capsys):
    from legume_tpu_torch.cli.main import main

    out = str(files["tmp"] / "main_lc")
    assert main(["pinto", "lc", "--data-files", files["store"], "--coords", files["coords"],
                 "--out", out, "-k", "2", "--sweeps", "3", "--em-sweeps", "0", "--device",
                 "cpu"]) == 0
    assert os.path.exists(out + ".metadata.json")
