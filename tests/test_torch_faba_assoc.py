"""`faba dyn-assoc` in the port (`faba/assoc.py`, `faba/gam.py`,
`cli/faba_cmds/gem_cmds.py::_cmd_dyn_assoc`) against the JAX package's,
on the CPU.

`dyn_assoc` and `dyn_assoc_pseudotime` are numpy and scipy in both
packages, so they are held exactly. The spline GAM's batched IRLS runs
in float32 in both (JAX's on XLA, the port's in torch on the device),
for the same fixed `max_iter` steps, and their solves round differently.
So each output is held in float64 form: the port's float32 values lie
within twice the JAX package's largest distance from the same fit run in
float64 (`dtype=torch.float64`), or 16 float32 units in the last place of
the column's largest value, whichever is more; `ok` and `n_obs` exactly. The design (`spline_design`) is host float64 in both and
exactly equal. The CLI's tables are held the same way, the float64 fit
formed from the same store, branches and exposure as the command forms
them.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import assoc as jassoc
from legume_tpu.faba import gam as jgam
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.cli.main import run_sim as t_sim
from legume_tpu_torch.data.sparse_io import open_sparse_matrix
from legume_tpu_torch.faba import assoc as tassoc
from legume_tpu_torch.faba import gam as tgam


def _sites(seed=0, s=40, n=300, branches=3):
    rng = np.random.default_rng(seed)
    br = rng.integers(0, branches, n)
    rate = rng.uniform(0.02, 0.2, (s, branches))
    rate[: s // 4, 0] *= 4.0
    expo = rng.gamma(5.0, 10.0, n)
    return rng.poisson(rate[:, br] * expo).astype(np.float64), expo, br


@pytest.mark.parametrize("branches,a0", [(2, 1.0), (3, 1.0), (4, 0.25)])
def test_dyn_assoc_equals_jax(branches, a0):
    counts, expo, br = _sites(branches, branches=branches)
    got = tassoc.dyn_assoc(counts, expo, br, a0=a0, b0=a0)
    want = jassoc.dyn_assoc(counts, expo, br, a0=a0, b0=a0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pt = np.random.default_rng(3).random(len(br))
    got = tassoc.dyn_assoc_pseudotime(counts, expo, pt, n_windows=6)
    want = jassoc.dyn_assoc_pseudotime(counts, expo, pt, n_windows=6)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _trend(seed=0, s=24, m=160):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(m))
    slope = rng.normal(0, 2.0, s)
    slope[: s // 3] = 0.0
    p = 1.0 / (1.0 + np.exp(-(-1.0 + slope[:, None] * (x[None, :] - 0.5)
                               + 0.8 * np.sin(6 * x)[None, :] * (np.arange(s) % 2)[:, None])))
    n = rng.poisson(12, (s, m)).astype(np.float64)
    n[:, ::7] = 0.0  # uncovered cells drop out
    k = rng.binomial(n.astype(np.int64), p).astype(np.float64)
    return k, n, x


def _assert_gam_close(got, want, ref):
    """`got` (port float32) against `want` (JAX float32) in the float64
    form of `ref` (the port's float64 fit)."""
    np.testing.assert_array_equal(got["ok"], want["ok"])
    np.testing.assert_array_equal(got["n_obs"], want["n_obs"])
    ok = want["ok"]
    for col in ("effect", "stat", "pvalue", "dispersion"):
        r = np.asarray(ref[col], np.float64)[ok]
        gap_jax = np.abs(np.asarray(want[col], np.float64)[ok] - r).max(initial=0.0)
        gap_port = np.abs(np.asarray(got[col], np.float64)[ok] - r).max(initial=0.0)
        floor = 16 * np.finfo(np.float32).eps * np.abs(r).max(initial=0.0)
        assert gap_port <= max(2 * gap_jax, floor), (col, gap_port, gap_jax)


@pytest.mark.parametrize("over,knots", [(True, 5), (False, 5), (True, 3), (False, 8)])
def test_gam_association_batch_matches_jax(over, knots):
    k, n, x = _trend(knots)
    kw = dict(n_knots=knots, overdispersion=over)
    got = tgam.gam_association_batch(k, n, x, **kw, device="cpu")
    ref = tgam.gam_association_batch(k, n, x, **kw, device="cpu", dtype=torch.float64)
    _assert_gam_close(got, jgam.gam_association_batch(k, n, x, **kw), ref)
    tx, tc = tgam.spline_design(x, knots)
    jx, jc = jgam.spline_design(x, knots)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tc, jc)
    assert tgam.gam_association_batch(k[:, :3], n[:, :3], x[:3], device="cpu") is None
    assert tgam.spline_design(np.zeros(10)) is None


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("assoc")
    t_sim(["faba", "--genes", "30", "--cols", "240", "--seed", "2", "--output", str(tmp / "fs")])
    st = pd.read_parquet(tmp / "fs.state.parquet")
    st.rename(columns={"state": "branch"}).to_parquet(tmp / "br.parquet")
    pt = np.random.default_rng(5).random(len(st))
    pd.DataFrame({"cell": st.cell, "pseudotime": pt}).to_parquet(tmp / "pt.pseudotime.parquet")
    pd.DataFrame({"cell": st.cell, "pseudotime": pt, "branch": st.state % 2}).to_parquet(
        tmp / "ptb.parquet")
    (tmp / "memb.tsv").write_text("".join(f"{c}\tT{i % 2}\n" for i, c in enumerate(st.cell)))
    return tmp


@pytest.mark.parametrize("extra,exact", [
    (["--branches", "BR", "--fdr-alpha", "0.1", "--cell-membership", "MEMB"], True),
    (["--from", "PT", "--modality", "m6a", "--n-bins", "5"], True),
    (["--branches", "PTB", "--trend-method", "quasi", "--min-cells", "3"], False),
    (["--from", "PT", "--trend-method", "binomial", "--n-knots", "4", "--fdr-alpha", "0.2"], False),
], ids=["branches", "pseudotime", "gam-quasi", "gam-binomial"])
def test_dyn_assoc_command_equals_jax(sites, extra, exact):
    sub = {"BR": str(sites / "br.parquet"), "PT": str(sites / "pt"),
           "PTB": str(sites / "ptb.parquet"), "MEMB": str(sites / "memb.tsv")}
    argv = ["dyn-assoc", "--backend", str(sites / "fs.zarr")] + [sub.get(a, a) for a in extra]
    tag = extra[1].lower() + extra[-1]
    t_faba(argv + ["--output", str(sites / f"t{tag}"), "--device", "cpu"])
    j_faba(argv + ["--output", str(sites / f"j{tag}")])
    got = pd.read_parquet(sites / f"t{tag}.assoc.parquet")
    want = pd.read_parquet(sites / f"j{tag}.assoc.parquet")
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    if exact:
        pd.testing.assert_frame_equal(got, want)
    else:
        assert got.site.tolist() == want.site.tolist()
        ref = _gam_float64(sites, extra, sub)
        cols = ["effect", "stat", "pvalue", "dispersion"]
        _assert_gam_close(dict(got[cols], ok=np.ones(len(got), bool), n_obs=got.n_cells),
                          dict(want[cols], ok=np.ones(len(want), bool), n_obs=want.n_cells),
                          ref[cols])
    assert ((got.pvalue >= 0) & (got.pvalue <= 1)).all()
    if "--cell-membership" in extra:
        pd.testing.assert_frame_equal(pd.read_parquet(sites / f"t{tag}.assoc.celltype.parquet"),
                                      pd.read_parquet(sites / f"j{tag}.assoc.celltype.parquet"))


def _gam_float64(sites, extra, sub):
    """The command's GAM rows in float64: the store's counts, its
    exposure (totals + 1), the branches of `--branches` (one fit without
    a branch column), `--min-cells` and `--n-knots` as the command takes
    them."""
    be = open_sparse_matrix(str(sites / "fs.zarr"))
    counts = np.asarray(be.read_columns_csc(np.arange(be.num_columns)).todense())
    names = list(be.row_names())
    opt = dict(zip(extra[::2], extra[1::2]))
    keep = (counts > 0).sum(1) >= int(opt.get("--min-cells", 0))
    counts, names = counts[keep], [nm for nm, k in zip(names, keep) if k]
    path = (sub[opt["--branches"]] if "--branches" in opt
            else sub[opt["--from"]] + ".pseudotime.parquet")
    lab = pd.read_parquet(path)
    lab = lab.set_index(lab.columns[0]).reindex(be.column_names())
    x = lab["pseudotime"].to_numpy(np.float64)
    br = lab["branch"].to_numpy() if "branch" in lab.columns else np.zeros(len(x), np.int64)
    n_all = np.broadcast_to((counts.sum(0) + 1.0)[None, :], counts.shape)
    rows = []
    for b in np.unique(br):
        sel = (br == b) & np.isfinite(x)
        fit = tgam.gam_association_batch(
            counts[:, sel], n_all[:, sel], x[sel], n_knots=int(opt.get("--n-knots", 5)),
            overdispersion=opt.get("--trend-method") == "quasi", device="cpu",
            dtype=torch.float64)
        rows.append(pd.DataFrame({k: fit[k] for k in ("effect", "stat", "pvalue", "dispersion")}
                                 )[fit["ok"]])
    return pd.concat(rows, ignore_index=True)
