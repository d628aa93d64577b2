"""The port's `fagioli` (`legume_tpu_torch/fagioli/`, `cli/fagioli_cli.py`)
against the JAX package's, on the CPU.

- The simulators, PLINK IO and the running statistics give JAX's arrays
  exactly (numpy copies).
- The pseudobulk log-rates and precision weights (K3's plain version on
  the CPU, from the store's CSC or a dense array, hard or soft cell-type
  membership) lie within 1e-5 of JAX's (normwise relative: with soft
  membership the float32 sums round otherwise than JAX's float64 ones,
  and a log-rate near zero keeps that rounding as a large relative error).
- Every subcommand runs through both CLIs on the same small inputs: the
  simulators' files are equal (stores decode equal), the SGVB fits' PIPs
  and effects lie within 1e-4 of JAX's after 20 steps, the ESS fit's
  posterior means and sds within 1e-6 (its R-hat and ESS within 1e-6 of
  their size), and the pseudobulk tables within 1e-5 (normwise).
  The two parser trees are equal but for `--device` on the eight
  commands that do device work.
- The JAX package's own recovery bars (`tests/test_qtl.py`,
  `tests/test_cli_surface.py`) hold for the port's fits.
"""

import argparse
import gzip
import json
import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.cli.main import run_fagioli as j_fagioli
from legume_tpu.fagioli import plink as jplink
from legume_tpu.fagioli import qtl as jqtl
from legume_tpu.fagioli import sim as jsim
from legume_tpu.fagioli import sumstat as jss
from legume_tpu.utils import running_stats as jrs
from legume_tpu_torch.cli.main import run_fagioli as t_fagioli
from legume_tpu_torch.data import open_sparse_matrix
from legume_tpu_torch.fagioli import plink as tplink
from legume_tpu_torch.fagioli import qtl as tqtl
from legume_tpu_torch.fagioli import sim as tsim
from legume_tpu_torch.fagioli import sumstat as tss
from legume_tpu_torch.utils import running_stats as trs
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "__dataclass_fields__"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    if a is None or isinstance(a, (list, tuple)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("name", ["geno", "sumstat", "sumstat_full", "qtl", "qtl_full",
                                  "mediation", "mediation_full"])
def test_simulators_equal_jax(name):
    geno = jsim.simulate_genotypes(n=60, p=30, seed=3).genotypes
    calls = {
        "geno": lambda m: m.simulate_genotypes(n=80, p=40, block_size=7, seed=2),
        "sumstat": lambda m: m.simulate_sumstat(n=90, p=30, n_causal=2, seed=4),
        "sumstat_full": lambda m: m.simulate_sumstat_full(
            geno, None, num_traits=3, h2_polygenic=0.1, num_confounders=2, seed=5),
        "qtl": lambda m: m.simulate_qtl(n_genes=8, n_indv=12, cells_per_indv=5, n_variants=9,
                                        seed=6),
        "qtl_full": lambda m: m.simulate_qtl_full(
            geno, np.arange(30) * 1000, n_genes=7, gene_tss=np.arange(7) * 4000, n_cell_types=3,
            mean_cells_per_individual=6, cis_window=5000, seed=7),
        "mediation": lambda m: m.simulate_mediation(n=70, p=20, seed=8),
        "mediation_full": lambda m: m.simulate_mediation_full(
            geno, n_genes=6, num_mediator_genes=2, num_collider_genes=2,
            induce_collider_bias=True, n_eqtl_discovery=25, seed=9),
    }
    mods = {"geno": (jsim, tsim), "sumstat": (jss, tss), "sumstat_full": (jsim, tsim),
            "qtl": (jqtl, tqtl), "qtl_full": (jqtl, tqtl), "mediation": (jsim, tsim),
            "mediation_full": (jsim, tsim)}[name]
    assert _same(calls[name](mods[0]), calls[name](mods[1]))


def test_plink_io_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, (13, 7)).astype(np.float32)
    geno[2, 3] = np.nan
    jplink.write_plink(str(tmp_path / "j"), geno)
    tplink.write_plink(str(tmp_path / "t"), geno)
    for ext in (".bed", ".bim", ".fam"):
        assert (tmp_path / f"j{ext}").read_bytes() == (tmp_path / f"t{ext}").read_bytes()
    assert _same(jplink.read_plink(str(tmp_path / "j")), tplink.read_plink(str(tmp_path / "j")))


def test_running_statistics_equal_jax():
    xs = np.random.default_rng(1).gamma(2.0, 1.0, 300)
    for q in (0.1, 0.5, 0.93):
        a, b = jrs.RunningQuantile(q), trs.RunningQuantile(q)
        assert a.value() != a.value() and b.value() != b.value()  # nan before any update
        a.update_many(xs[:3]), b.update_many(xs[:3])
        assert a.value() == b.value()
        a.update_many(xs[3:]), b.update_many(xs[3:])
        assert a.value() == b.value()
    a, b = jrs.RunningMoments((4,)), trs.RunningMoments((4,))
    for row in xs.reshape(-1, 4):
        a.update(row), b.update(row)
    assert np.array_equal(a.mean, b.mean) and np.array_equal(a.std, b.std) and a.n == b.n


@pytest.mark.parametrize("form", ["dense", "csc", "soft"])
def test_pseudobulk_log_rates_match_jax(form):
    rng = np.random.default_rng(0)
    counts = (rng.poisson(3.0, size=(15, 120)) * (rng.random((15, 120)) < 0.6)).astype(np.float32)
    indv = np.repeat(np.arange(12), 10)
    # normwise: a log-rate near zero is a difference of two O(1) terms
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(a).max())  # noqa: E731
    if form == "soft":
        memb = rng.dirichlet(np.ones(3), 120).astype(np.float32)
        want = jqtl.pseudobulk_celltype_log_rates(counts, indv, 12, memb, a0=0.5, b0=2.0)
        got = tqtl.pseudobulk_celltype_log_rates(sp.csc_matrix(counts), indv, 12, memb, a0=0.5,
                                                 b0=2.0, device="cpu")
        assert np.array_equal(want[2], got[2])
    else:
        want = jqtl.pseudobulk_log_rates(counts, indv, 12)
        got = tqtl.pseudobulk_log_rates(counts if form == "dense" else sp.csc_matrix(counts),
                                        indv, 12, device="cpu")
    assert rel(want[0], got[0]) <= 1e-5 and rel(want[1], got[1]) <= 1e-5


# ---- both CLIs ----------------------------------------------------------------


class _Parsed(Exception):
    pass


def _subparsers(run, monkeypatch):
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        run(["sim-geno"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or (a.dest,)): (a.dest, a.default, a.nargs,
                                                            getattr(a.type, "__name__", a.type),
                                                            a.choices, a.required)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_fagioli_parser_carries_jax_flags_and_defaults(monkeypatch):
    from legume_tpu_torch.cli.fagioli_cli import DEVICE_COMMANDS

    got, want = _subparsers(t_fagioli, monkeypatch), _subparsers(j_fagioli, monkeypatch)
    assert list(got) == list(want) and len(want) == 12
    for cmd in want:
        flags = dict(got[cmd])
        if cmd in DEVICE_COMMANDS:
            assert flags.pop(("--device",))[1] == "cuda"
        assert flags == want[cmd], cmd


def _both(tmp, argv, device=False):
    """Run `argv` through both CLIs, writing under tmp/j and tmp/t."""
    out = {}
    for side, run in (("j", j_fagioli), ("t", t_fagioli)):
        d = tmp / side
        d.mkdir(exist_ok=True)
        args = [str(d / a[1:]) if a.startswith("@") else a for a in argv]
        run(args + (["--device", "cpu"] if device and side == "t" else []))
        out[side] = d
    return out["j"], out["t"]


def _frames_close(a, b, atol, relative=()):
    """Equal tables but for numbers within `atol` (within `atol` times the
    column's largest magnitude for the columns in `relative`)."""
    fa, fb = pd.read_parquet(a), pd.read_parquet(b)
    assert list(fa.columns) == list(fb.columns) and len(fa) == len(fb)
    for c in fa.columns:
        if pd.api.types.is_numeric_dtype(fa[c]):
            want, got = fa[c].to_numpy(np.float64), fb[c].to_numpy(np.float64)
            scale = np.abs(want).max() if c in relative or relative == "all" else 1.0
            assert np.abs(got - want).max() <= atol * scale, c
        else:
            assert fa[c].tolist() == fb[c].tolist(), c


@pytest.fixture(scope="module")
def locus(tmp_path_factory):
    """One locus through both CLIs' `sim-sumstat`, and `sim-geno`."""
    tmp = tmp_path_factory.mktemp("locus")
    j, t = _both(tmp, ["sim-sumstat", "--out", "@s", "--n", "90", "--p", "24",
                       "--num-causal-blocks", "2", "--num-independent-causal", "0",
                       "--seed", "3"])
    jl, tl = _both(tmp, ["sim-sumstat", "--legacy", "--out", "@l", "--n", "60", "--p", "20"])
    jg, tg = _both(tmp, ["sim-geno", "--out", "@g", "--n", "40", "--p", "12"])
    return {"tmp": tmp, "j": j, "t": t}


def test_cli_simulators_write_jax_files(locus, tmp_path):
    j, t = locus["j"], locus["t"]
    for name in ("s.geno.npy", "l.geno.npy", "g.geno.npy"):
        assert np.array_equal(np.load(j / name), np.load(t / name))
    for name in ("s.sumstat.tsv", "l.sumstat.tsv", "g.variants.tsv"):
        assert (j / name).read_text() == (t / name).read_text()
    assert pd.read_parquet(j / "s.truth.parquet").equals(pd.read_parquet(t / "s.truth.parquet"))

    j, t = _both(tmp_path, ["sim-mediation", "--out", "@m", "--n", "60", "--p", "15",
                            "--num-genes", "5", "--mediators", "2", "--num-collider-genes", "1",
                            "--induce-collider-bias", "--n-eqtl-discovery", "20"])
    _both(tmp_path, ["sim-mediation", "--legacy", "--out", "@ml", "--n", "50", "--p", "12"])
    for name in ("m.geno.npy", "m.alpha.npy", "m.instruments.npy", "ml.alpha.npy"):
        assert np.array_equal(np.load(j / name), np.load(t / name))
    for name in ("m.sumstat.tsv", "ml.sumstat.tsv"):
        assert (j / name).read_text() == (t / name).read_text()
    for name in ("m.phenotypes.parquet", "m.truth.parquet", "ml.truth.parquet"):
        assert pd.read_parquet(j / name).equals(pd.read_parquet(t / name))

    j, t = _both(tmp_path, ["sim-qtl", "--out", "@q", "--genes", "5", "--indv", "8",
                            "--variants", "6", "--num-cell-types", "2", "--cells-per-indv", "6",
                            "--seed", "2"])
    _both(tmp_path, ["sim-qtl", "--legacy", "--out", "@ql", "--genes", "4", "--indv", "6",
                     "--cells-per-indv", "5", "--variants", "5"])
    for name in ("q.zarr", "ql.zarr"):
        a, b = open_sparse_matrix(str(j / name)), open_sparse_matrix(str(t / name))
        assert a.row_names() == b.row_names() and a.column_names() == b.column_names()
        cols = np.arange(a.num_columns)
        assert (a.read_columns_csc(cols) != b.read_columns_csc(cols)).nnz == 0
    for name in ("q.geno.npy", "ql.geno.npy"):
        assert np.array_equal(np.load(j / name), np.load(t / name))
    assert (gzip.open(j / "q.annotations.tsv.gz").read()
            == gzip.open(t / "q.annotations.tsv.gz").read())
    assert (j / "ql.indv.txt").read_text() == (t / "ql.indv.txt").read_text()
    for name in ("q.truth.parquet", "ql.truth.parquet"):
        assert pd.read_parquet(j / name).equals(pd.read_parquet(t / name))


@pytest.mark.parametrize("cmd", ["map-sumstat", "map-sumstat-multilevel", "fit-sumstat-sgvb",
                                 "fit-sumstat-sgvb-ash", "fit-prs-susie", "fit-sumstat-mcmc"])
def test_cli_sumstat_fits_match_jax(locus, tmp_path, cmd):
    s = locus["j"]
    inputs = ["--zscores", str(s / "s.sumstat.tsv"), "--geno", str(s / "s.geno.npy")]
    argv, table, atol = {
        "map-sumstat": (["map-sumstat", "--steps", "20"], "finemap", 1e-4),
        "map-sumstat-multilevel": (["map-sumstat", "--steps", "20", "--multilevel"], "finemap",
                                   1e-4),
        "fit-sumstat-sgvb": (["fit-sumstat-sgvb", "--steps", "20", "--prior-var", "0.1", "1.0"],
                             "finemap", 1e-4),
        "fit-sumstat-sgvb-ash": (["fit-sumstat-sgvb", "--steps", "20", "--prior-type", "ash"],
                                 "finemap", 1e-4),
        "fit-prs-susie": (["fit-prs-susie", "--steps", "20", "--score-geno",
                           str(s / "s.geno.npy")], "prs_weights", 1e-4),
        "fit-sumstat-mcmc": (["fit-sumstat-mcmc", "--samples", "10", "--burn-in", "3"], "mcmc",
                             1e-6),
    }[cmd]
    j, t = _both(tmp_path, argv[:1] + inputs + ["--out", "@o"] + argv[1:], device=True)
    # the chains' diagnostics (ESS near 40, R-hat) are held relative to their size
    _frames_close(j / f"o.{table}.parquet", t / f"o.{table}.parquet", atol, ("rhat", "ess"))
    if cmd == "fit-prs-susie":
        _frames_close(j / "o.prs.parquet", t / "o.prs.parquet", 1e-3)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A small single-cell cohort (the port's `sim-qtl`), with its labels."""
    tmp = tmp_path_factory.mktemp("cohort")
    out = str(tmp / "c")
    t_fagioli(["sim-qtl", "--legacy", "--out", out, "--genes", "4", "--indv", "20",
               "--cells-per-indv", "6", "--variants", "8", "--frac-egenes", "1.0",
               "--effect-sd", "1.0"])
    t_fagioli(["sim-qtl", "--out", str(tmp / "f"), "--genes", "3", "--indv", "16",
               "--variants", "6", "--num-cell-types", "2", "--cells-per-indv", "8", "--seed", "4"])
    return tmp


@pytest.mark.parametrize("cmd", ["map-qtl", "fit-qtl-sgvb", "pseudobulk", "fit-regression"])
def test_cli_qtl_fits_match_jax(cohort, tmp_path, cmd):
    c = str(cohort / "c")
    if cmd == "fit-regression":
        rng = np.random.default_rng(0)
        x = rng.standard_normal((50, 4))
        df = pd.DataFrame(x, columns=[f"c{i}" for i in range(4)])
        df["resp"] = 2.0 * x[:, 1] + 0.3 * rng.standard_normal(50)
        df.to_csv(tmp_path / "tab.tsv", sep="\t", index=False)
        argv = ["fit-regression", "--table", str(tmp_path / "tab.tsv"), "--response", "resp",
                "--out", "@o", "--steps", "20", "-L", "2"]
        tables, atol = ["regression"], 1e-4
    elif cmd == "pseudobulk":
        argv = ["pseudobulk", "--backend", f"{c}.zarr", "--indv", f"{c}.indv.txt", "--out", "@o"]
        tables, atol = ["pseudobulk", "weights"], 1e-5  # normwise, as the log-rates above
    elif cmd == "map-qtl":
        argv = ["map-qtl", "--backend", f"{c}.zarr", "--indv", f"{c}.indv.txt", "--geno",
                f"{c}.geno.npy", "--out", "@o", "--steps", "20", "-L", "2"]
        tables, atol = ["qtl"], 1e-4
    else:
        f = str(cohort / "f")
        argv = ["fit-qtl-sgvb", "--backend", f"{f}.zarr", "--annot", f"{f}.annotations.tsv.gz",
                "--geno", f"{f}.geno.npy", "--out", "@o", "--steps", "20", "--min-weight", "1",
                "--prior-var", "0.5"]
        tables, atol = ["qtl"], 1e-4
    j, t = _both(tmp_path, argv, device=True)
    for name in tables:
        _frames_close(j / f"o.{name}.parquet", t / f"o.{name}.parquet", atol,
                      "all" if cmd == "pseudobulk" else ())
    if cmd == "fit-qtl-sgvb":
        assert json.load(open(j / "o.parameters.json")) == json.load(open(t / "o.parameters.json"))
        assert len(gzip.open(t / "o.results.bed.gz").read().splitlines()) == len(
            pd.read_parquet(t / "o.qtl.parquet")) + 1


def test_main_dispatches_fagioli(tmp_path):
    from legume_tpu_torch.cli.main import main

    out = str(tmp_path / "g")
    assert main(["fagioli", "sim-geno", "--out", out, "--n", "10", "--p", "5"]) == 0
    assert os.path.exists(out + ".geno.npy")


# ---- the JAX package's recovery bars, on the port ------------------------------


def test_map_qtl_recovers_egenes():
    sim = tqtl.simulate_qtl(n_genes=12, n_indv=80, cells_per_indv=20, n_variants=30,
                            frac_egenes=0.5, effect_sd=0.8, seed=4)
    out = tqtl.map_qtl(sp.csc_matrix(sim.counts), sim.cell_indv, sim.genotypes, L=2,
                       num_steps=600, device="cpu")
    assert out["pip"].shape == (12, 30)
    hits, fps = 0, 0
    for gi in range(12):
        top = out["pip"][gi].argmax()
        if sim.causal_variant[gi] >= 0:
            hits += top == sim.causal_variant[gi] and out["pip"][gi, top] > 0.3
        else:
            fps += out["pip"][gi].max() > 0.8
    n_egenes = (sim.causal_variant >= 0).sum()
    assert hits >= max(n_egenes - 2, 1) and fps <= 2


def test_fit_qtl_sgvb_celltype_specific_effect():
    rng = np.random.default_rng(4)
    g, i, p, cpi = 4, 60, 20, 24
    maf = rng.uniform(0.2, 0.5, p)
    geno = rng.binomial(2, maf[None, :], size=(i, p)).astype(np.float64)
    gs = (geno - geno.mean(0)) / np.maximum(geno.std(0), 1e-8)
    cell_indv = np.repeat(np.arange(i), cpi)
    n = len(cell_indv)
    ct = np.tile(np.repeat([0, 1], cpi // 2), i)
    causal = 7
    log_mu = np.tile(np.log(rng.gamma(2.0, 1.0, g))[:, None], (1, n))
    log_mu[0, ct == 0] += 0.9 * gs[cell_indv[ct == 0], causal]
    counts = rng.poisson(40.0 * np.exp(np.clip(log_mu, -6, 6))).astype(np.float32)
    rows = tqtl.fit_qtl_sgvb(sp.csc_matrix(counts), cell_indv, geno,
                             membership_nc=np.eye(2, dtype=np.float32)[ct],
                             celltype_names=["a", "b"], num_steps=500, prior_vars=[0.1, 1.0],
                             device="cpu")
    df = pd.DataFrame(rows)
    pip_a = float(df[(df.celltype == "a") & (df.gene == 0) & (df.variant == causal)]["pip"].iloc[0])
    pip_b = float(df[(df.celltype == "b") & (df.gene == 0) & (df.variant == causal)]["pip"].iloc[0])
    assert pip_a > 0.5 and pip_a > pip_b + 0.3
    sub = df[(df.celltype == "a") & (df.gene == 0)]
    assert int(sub.loc[sub["pip"].idxmax(), "variant"]) == causal


def test_sim_qtl_full_roundtrip_and_cli_surface(tmp_path):
    """sim-qtl -> fit-qtl-sgvb recovers shared causal variants; the --annot,
    PLINK, --empirical-bayes, covariates and output contract of
    `tests/test_qtl.py`, on the port's CLI."""
    from legume_tpu_torch.fagioli.plink import write_plink

    out = str(tmp_path / "sim")
    t_fagioli(["sim-qtl", "--out", out, "--genes", "6", "--indv", "50", "--variants", "15",
               "--num-cell-types", "2", "--frac-egenes", "1.0", "--shared-eqtl-proportion",
               "1.0", "--independent-eqtl-proportion", "0.0", "--genetic-variance", "0.6",
               "--cells-per-indv", "20", "--depth-per-cell", "3000", "--seed", "3"])
    truth = pd.read_parquet(f"{out}.truth.parquet")
    assert set(truth["kind"]) == {"shared"}
    t_fagioli(["fit-qtl-sgvb", "--backend", f"{out}.zarr", "--annot", f"{out}.annotations.tsv.gz",
               "--geno", f"{out}.geno.npy", "--out", str(tmp_path / "fit"), "--steps", "300",
               "--min-weight", "1", "--device", "cpu"])
    res = pd.read_parquet(tmp_path / "fit.qtl.parquet")
    want = dict(zip(truth["gene"], truth["variant"]))
    hits = sum(int(sub.loc[sub["pip"].idxmax(), "variant"].lstrip("v")) == want[gene]
               for (gene, _), sub in res.groupby(["gene", "celltype"]))
    assert hits >= int(0.6 * res.groupby(["gene", "celltype"]).ngroups)

    rng = np.random.default_rng(5)
    g, i, p, cpi = 3, 50, 12, 16
    geno = rng.binomial(2, rng.uniform(0.2, 0.5, p)[None, :], size=(i, p)).astype(np.float64)
    gs = (geno - geno.mean(0)) / np.maximum(geno.std(0), 1e-8)
    cell_indv = np.repeat(np.arange(i), cpi)
    log_mu = np.zeros((g, len(cell_indv)))
    log_mu[0] += 1.0 * gs[cell_indv, 4]
    counts = rng.poisson(30.0 * np.exp(np.clip(log_mu, -6, 6))).astype(np.float32)
    from legume_tpu_torch.data import create_sparse_from_csc

    be = str(tmp_path / "counts.zarr")
    create_sparse_from_csc(sp.csc_matrix(counts), be, [f"G{k}" for k in range(g)],
                           [f"c{j}" for j in range(len(cell_indv))])
    write_plink(str(tmp_path / "panel"), geno, variant_ids=[f"rs{j}" for j in range(p)],
                sample_ids=[f"I{k}" for k in range(i)])
    (tmp_path / "annot.tsv").write_text("".join(
        f"c{j}\tI{cell_indv[j]}\t{'A' if j % 2 else 'B'}\n" for j in range(len(cell_indv))))
    (tmp_path / "cov.tsv").write_text("indv\tage\n" + "".join(
        f"I{k}\t{30 + k % 7}\n" for k in range(i)))
    t_fagioli(["fit-qtl-sgvb", "--backend", be, "--annot", str(tmp_path / "annot.tsv"),
               "--plink", str(tmp_path / "panel"), "--out", str(tmp_path / "eb"), "--steps", "300",
               "--empirical-bayes", "--prior-var", "0.01", "0.3", "--covariates",
               str(tmp_path / "cov.tsv"), "--composition-covariates", "--min-weight", "1",
               "--seed", "0", "--device", "cpu"])
    df = pd.read_parquet(tmp_path / "eb.qtl.parquet")
    assert set(df["celltype"]) == {"A", "B"} and df["prior_var"].nunique() == 1
    for ct in ("A", "B"):
        sub = df[(df["gene"] == "G0") & (df["celltype"] == ct)]
        assert sub.set_index("variant")["pip"].idxmax() == "rs4"


def test_fagioli_cli_surface_recovery(tmp_path):
    """`tests/test_cli_surface.py`'s fagioli bars: fit-regression finds the
    driving covariate, sim-qtl --legacy -> map-qtl recovers eGenes, and the
    mediation / pseudobulk outputs are well formed."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((150, 5))
    df = pd.DataFrame(x, columns=[f"c{i}" for i in range(5)])
    df["resp"] = 2.0 * x[:, 2] + 0.3 * rng.standard_normal(150)
    df.to_csv(tmp_path / "tab.tsv", sep="\t", index=False)
    t_fagioli(["fit-regression", "--table", str(tmp_path / "tab.tsv"), "--response", "resp",
               "--out", str(tmp_path / "reg"), "--steps", "600", "-L", "2", "--device", "cpu"])
    res = pd.read_parquet(tmp_path / "reg.regression.parquet").set_index("covariate")
    assert res.loc["c2", "pip"] > 0.9 and res["pip"].drop("c2").max() < 0.5

    out = str(tmp_path / "qtl")
    t_fagioli(["sim-qtl", "--legacy", "--out", out, "--genes", "6", "--indv", "50",
               "--cells-per-indv", "15", "--variants", "20", "--frac-egenes", "1.0",
               "--effect-sd", "1.0"])
    t_fagioli(["map-qtl", "--backend", f"{out}.zarr", "--indv", f"{out}.indv.txt", "--geno",
               f"{out}.geno.npy", "--out", str(tmp_path / "map"), "--steps", "400", "-L", "2",
               "--device", "cpu"])
    res = pd.read_parquet(tmp_path / "map.qtl.parquet")
    truth = pd.read_parquet(f"{out}.truth.parquet")
    hits = 0
    for _, row in truth.iterrows():
        if row["causal_variant"] < 0 or abs(row["beta"]) < 0.3:
            continue
        grp = res[res["gene"] == row["gene"]]
        hits += int(grp.loc[grp["pip"].idxmax(), "variant"][1:]) == row["causal_variant"]
    assert hits >= 2

    med = str(tmp_path / "med")
    t_fagioli(["sim-mediation", "--legacy", "--out", med, "--n", "300", "--p", "40"])
    ss = pd.read_csv(f"{med}.sumstat.tsv", sep="\t")
    assert {"variant", "z", "z_med0"} <= set(ss.columns) and np.isfinite(ss["z"]).all()
    t_fagioli(["pseudobulk", "--backend", f"{out}.zarr", "--indv", f"{out}.indv.txt", "--out",
               str(tmp_path / "pb"), "--device", "cpu"])
    pb = pd.read_parquet(tmp_path / "pb.pseudobulk.parquet")
    assert pb.shape == (6, 51) and np.isfinite(pb.iloc[:, 1:].to_numpy()).all()
