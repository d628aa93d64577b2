"""The copy-number HMM and the CNV side-channels through both packages,
the port on the CPU (`ops/cnv_hmm.py`, `cocoa/cnv_call.py`, `cocoa diff
--cnv-ground-truth`, `senna topic --cnv`).

On `tests/test_cnv_hmm.py`'s track: Viterbi states equal, posteriors
within 1e-5, EM scales and variances within 1e-4, the k-means-BIC state
count equal. The per-sample CNV calls of `cocoa diff` on
`tests/test_cocoa_e2e.py`'s amplified block: states equal, cn_score
within 1e-4. `senna topic --cnv` writes the JAX package's table.
"""

import gzip

import numpy as np
import pandas as pd
import pytest

from legume_tpu.cocoa import cnv_call as jcnv
from legume_tpu.cocoa.diff import CocoaDiffArgs, run_cocoa_diff
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.ops import cnv_hmm as jhmm
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.cocoa import cnv_call as tcnv
from legume_tpu_torch.ops import cnv_hmm as thmm


@pytest.fixture(scope="module")
def track():
    rng = np.random.default_rng(0)
    states = np.concatenate([np.full(60, 1), np.full(40, 0), np.full(50, 1), np.full(30, 2),
                             np.full(40, 1)])
    y = np.asarray([-0.5, 0.0, 0.3])[states] + rng.normal(0, 0.12, len(states))
    return y.astype(np.float32), states


def test_infer_sample_matches_jax(track):
    y, states = track
    for kw in (dict(alpha=1.0, sigma_sq=0.0144), dict()):
        want = jhmm.infer_sample(jhmm.CnvHmmParams.default_3state(), y, **kw)
        got = thmm.infer_sample(thmm.CnvHmmParams.default_3state(), y, **kw, device="cpu")
        np.testing.assert_array_equal(got.viterbi_path, want.viterbi_path)
        np.testing.assert_allclose(got.posteriors, want.posteriors, rtol=0, atol=1e-5)
        assert abs(got.log_likelihood - want.log_likelihood) < 1e-4 * abs(want.log_likelihood)
    assert (got.viterbi_path == states).mean() > 0.9


def test_fit_em_matches_jax(track):
    y, _ = track
    ys = np.stack([y, 2.0 * y, 0.5 * y[::-1]])
    want = jhmm.fit_em(jhmm.CnvHmmParams.default_3state(), ys, n_iter=25)
    got = thmm.fit_em(thmm.CnvHmmParams.default_3state(), ys, n_iter=25, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    paths = thmm.viterbi_batch(thmm.CnvHmmParams.default_3state(), ys, got[0], got[1],
                               device="cpu")
    for b in range(3):
        want_path = jhmm.infer_sample(jhmm.CnvHmmParams.default_3state(), ys[b],
                                      alpha=float(want[0][b]), sigma_sq=float(want[1][b]))
        np.testing.assert_array_equal(paths[b], want_path.viterbi_path)


def test_kmeans_bic_state_count_matches_jax():
    rng = np.random.default_rng(0)
    for levels in ((-0.6, 0.0, 0.45), (-0.8, -0.4, 0.0, 0.35, 0.7)):
        y = np.concatenate([rng.normal(m, 0.05, 300) for m in levels])
        want = jhmm.CnvHmmParams.from_kmeans_bic(y, k_range=(3, 4, 5, 6))
        got = thmm.CnvHmmParams.from_kmeans_bic(y, k_range=(3, 4, 5, 6), device="cpu")
        assert got.n_states == want.n_states
        np.testing.assert_allclose(got.emission_means, want.emission_means, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.log_pi, want.log_pi)


def _amplified(tmp_path):
    """`tests/test_cocoa_e2e.py::test_cocoa_cnv_side_channel_recovers_amplified_block`'s data."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    g, n_indv, cpi = 60, 8, 40
    n = n_indv * cpi
    base = rng.gamma(2.0, 1.0, size=g)
    cell_indv = np.repeat(np.arange(n_indv), cpi)
    rate = np.tile(base[:, None], (1, n))
    for i in range(2):
        rate[20:36, cell_indv == i] *= 2.2
    counts = rng.poisson(rate * 5.0).astype(np.float32)
    path = str(tmp_path / "cnv_counts.zarr")
    create_sparse_from_csc(sp.csc_matrix(counts), path, [f"g{i}" for i in range(g)],
                           [f"c{j}" for j in range(n)])
    (tmp_path / "indv.txt").write_text("\n".join(f"i{v}" for v in cell_indv) + "\n")
    (tmp_path / "exp.tsv").write_text(
        "".join(f"i{i}\t{x}\n" for i, x in enumerate(np.tile([0, 1], n_indv // 2))))
    truth = tmp_path / "truth.tsv.gz"
    with gzip.open(truth, "wt") as f:
        f.write("gene_idx\tchr\tpos\n")
        for i in range(g):
            f.write(f"{i}\t{'chr1' if i < 45 else 'chr2'}\t{i * 1000 + 500}\n")
    return path, str(truth)


def test_cocoa_cnv_side_channel_matches_jax(tmp_path):
    # two permutations: the replay path reads each column once (the
    # single collection re-reads every matched column from the .zarr)
    path, truth = _amplified(tmp_path)
    common = ["--data-files", path, "--indv", str(tmp_path / "indv.txt"), "--exposure",
              str(tmp_path / "exp.tsv"), "--n-pb-samples", "4", "--knn", "5", "--iter-opt", "40",
              "--cnv-ground-truth", truth, "--no-match-cache", "--permutations", "2"]
    run_cocoa_diff(CocoaDiffArgs(
        data_files=[path], out=str(tmp_path / "j"), indv_file=str(tmp_path / "indv.txt"),
        exposure_file=str(tmp_path / "exp.tsv"), n_pb_samples=4, knn=5, n_opt_iter=40,
        cnv_ground_truth=truth, match_cache=False, n_permutations=2))
    assert port_cli(["cocoa", "diff", *common, "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    for name in ("states", "cn_score"):
        j = pd.read_parquet(tmp_path / f"j.cnv.{name}.parquet")
        t = pd.read_parquet(tmp_path / f"t.cnv.{name}.parquet")
        assert list(t.columns) == list(j.columns) and (t.gene == j.gene).all()
        if name == "states":
            np.testing.assert_array_equal(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy())
        else:
            np.testing.assert_allclose(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy(),
                                       rtol=0, atol=1e-4)
    for name in ("normal_samples.tsv.gz", "segments.bed.gz"):
        with gzip.open(tmp_path / f"j.cnv.{name}", "rt") as a, \
                gzip.open(tmp_path / f"t.cnv.{name}", "rt") as b:
            assert a.read() == b.read(), name
    j = pd.read_parquet(tmp_path / "j.effect.parquet")
    t = pd.read_parquet(tmp_path / "t.effect.parquet")
    assert list(t.columns) == list(j.columns)
    np.testing.assert_array_equal(t.cnv_state, j.cnv_state)
    np.testing.assert_allclose(t.cnv_concordance_r, j.cnv_concordance_r, rtol=0, atol=1e-4)
    # the carriers' block stands out
    score = pd.read_parquet(tmp_path / "t.cnv.cn_score.parquet").set_index("gene")
    carriers = [c for c in score.columns if int(c.split("@")[0][1:]) < 2]
    others = [c for c in score.columns if c not in carriers]
    blk = [f"g{i}" for i in range(20, 36)]
    assert score.loc[blk, carriers].to_numpy().mean() > score.loc[blk, others].to_numpy().mean()


def test_call_cnv_on_residuals_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    mu = rng.gamma(3.0, 1.0, (120, 9)).astype(np.float32)
    mu[40:70, :3] *= 2.0
    want = jcnv.call_cnv_on_residuals(mu, mu.mean(1), genes_per_bin=10)
    got = tcnv.call_cnv_on_residuals(mu, mu.mean(1), genes_per_bin=10, device="cpu")
    np.testing.assert_array_equal(got.states, want.states)
    np.testing.assert_allclose(got.log_ratio, want.log_ratio, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.posteriors, want.posteriors, rtol=0, atol=1e-5)
    # the GFF gene order (ported with faba's GFF reader) equals JAX's
    gff = tmp_path / "g.gff3"
    gff.write_text("".join(f"chr{1 + i % 2}\tsim\tgene\t{1000 - 7 * i}\t{1100 - 7 * i}\t.\t"
                           f"{'+-'[i % 3 == 0]}\t.\tID=gene:g{i};Name=g{i}\n" for i in range(12)))
    names = [f"g{i}" for i in range(0, 14, 2)]
    got, want = tcnv.genome_order_from_gff(names, str(gff)), jcnv.genome_order_from_gff(names,
                                                                                         str(gff))
    for f in ("ordered", "chrom", "pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_topic_cnv_writes_jax_columns(tmp_path):
    """`senna topic --cnv` through the port's CLI: the JAX package's
    `{out}.cnv` table, one row per (pseudobulk, bin)."""
    from legume_tpu.data.sim import simulate_topic, write_topic_sim

    path = write_topic_sim(simulate_topic(rows=100, cols=200, factors=3, seed=2),
                           str(tmp_path / "sim"))
    out = str(tmp_path / "t")
    assert port_cli(["senna", "topic", "--data-files", path, "--out", out, "-k", "3",
                     "--encoder-layers", "16", "--epochs", "2", "--num-levels", "2",
                     "--sort-dim", "4", "--cnv", "--preload-data", "--device", "cpu"]) == 0
    t = pd.read_parquet(out + ".cnv.parquet")
    assert list(t.columns) == ["pseudobulk", "bin", "state", "log_ratio"]
    n_pb, n_bins = t.pseudobulk.nunique(), t.bin.nunique()
    assert n_bins == 4 and len(t) == n_pb * n_bins  # 100 genes, 25 a bin
    assert set(np.unique(t.state)) <= {0, 1, 2} and np.isfinite(t.log_ratio).all()
