"""`senna svd` and `senna joint-svd` through both packages, port on the
CPU: the pseudobulk planes within 1e-5, the basis and the per-cell
factors (the port's through K2's plain version) within 1e-4 up to each
column's sign (the subspace where two singular values lie within 5%),
the adjusted `.zarr` within 1e-5, and the commands' artifacts."""

import numpy as np
import pytest

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.data.sparse_io import open_sparse_matrix as jopen
from legume_tpu.senna import svd as jsvd
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.data.sim import simulate_multimodal, simulate_topic
from legume_tpu_torch.senna import svd as tsvd
from legume_tpu_torch.utils.output import read_table

COMMON = dict(n_factors=6, block_size=128, sort_dim=6, iter_opt=10)


def assert_factors_match(got_u, want_u, got_f, want_f, s, atol=1e-4):
    """Column by column up to sign, scaled by each matrix's largest value;
    a group of singular values within 5% of each other is compared as a
    subspace (the projector)."""
    k = len(s)
    j = 0
    while j < k:
        e = j + 1
        while e < k and s[e - 1] - s[e] <= 0.05 * s[e - 1]:
            e += 1
        if e - j == 1:
            sign = np.sign(np.dot(got_u[:, j], want_u[:, j]))
            np.testing.assert_allclose(got_u[:, j] * sign, want_u[:, j], rtol=0, atol=atol)
            scale = np.abs(want_f[:, j]).max()
            np.testing.assert_allclose(got_f[:, j] * sign / scale, want_f[:, j] / scale, rtol=0,
                                       atol=atol)
        else:
            pg, pw = got_u[:, j:e] @ got_u[:, j:e].T, want_u[:, j:e] @ want_u[:, j:e].T
            np.testing.assert_allclose(pg, pw, rtol=0, atol=atol)
        j = e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("svd")
    sim = simulate_topic(rows=90, cols=300, factors=4, batches=2, seed=31)
    files = []
    for b in range(2):
        cols = np.nonzero(sim.batch == b)[0]
        path = str(tmp / f"b{b}.zarr")
        create_sparse_from_csc(sim.counts[:, cols], path, sim.row_names,
                               [sim.col_names[j] for j in cols])
        files.append(path)
    # the options on one file, one batch (no matched statistics: fast)
    one = str(tmp / "all.zarr")
    create_sparse_from_csc(sim.counts, one, sim.row_names, sim.col_names)
    out = {}
    for name, data, kw in (("plain", files, dict(save_adjusted=True)),
                           ("norm_hvg", [one], dict(column_sum_norm=1000.0, hvg_genes=40))):
        out[name] = (
            jsvd.fit_svd(jsvd.SvdArgs(data_files=data, out=str(tmp / f"j_{name}"), **COMMON, **kw)),
            tsvd.fit_svd(tsvd.SvdArgs(data_files=data, out=str(tmp / f"t_{name}"), **COMMON, **kw),
                         device="cpu"),
        )
    return dict(tmp=tmp, files=files, one=one, runs=out)


def test_pseudobulk_planes_within_1e5(runs):
    import legume_tpu.senna.topic as jtopic

    j, t = runs["runs"]["plain"]
    jlv = jtopic.load_and_collapse(jtopic.load_data_vec(runs["files"]), jtopic.TopicArgs(
        data_files=runs["files"], num_levels=1, sort_dim=6, iter_opt=10, block_size=128))
    for plane in ("mu_observed", "mu_adjusted", "mu_residual"):
        jp = getattr(jlv.collapsed[0], plane)
        tp = getattr(t["levels"].collapsed[0], plane)
        np.testing.assert_allclose(tp.a.numpy(), np.asarray(jp.a), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["plain", "norm_hvg"])
def test_basis_and_factors_within_1e4_up_to_sign(runs, name):
    j, t = runs["runs"][name]
    s = np.asarray(j["singular_values"])
    np.testing.assert_allclose(t["singular_values"], s, rtol=1e-4)
    assert_factors_match(t["basis"], np.asarray(j["basis"]), t["factors"], j["factors"], s)
    if name == "norm_hvg":  # genes outside the 40 HVGs carry zero loadings
        assert (np.abs(t["basis"]).sum(1) == 0).sum() == 90 - 40


def test_adjusted_backend_within_1e5(runs):
    tmp = runs["tmp"]
    jb, tb = jopen(str(tmp / "j_plain.adjusted.zarr")), jopen(str(tmp / "t_plain.adjusted.zarr"))
    jm = jb.read_columns_csc(np.arange(jb.num_columns))
    tm = tb.read_columns_csc(np.arange(tb.num_columns))
    np.testing.assert_array_equal(tm.indptr, jm.indptr)
    np.testing.assert_array_equal(tm.indices, jm.indices)
    np.testing.assert_allclose(tm.data, jm.data, rtol=1e-5, atol=1e-5)
    assert list(tb.column_names()) == list(jb.column_names())


def test_artifacts_match_jax(runs):
    tmp = runs["tmp"]
    for name in ("latent", "dictionary", "singular_values"):
        assert list(read_table(str(tmp / f"t_plain.{name}.parquet"))) == \
            list(read_table(str(tmp / f"j_plain.{name}.parquet")))


def test_joint_svd_within_1e4_up_to_sign(tmp_path):
    sim = simulate_multimodal(rows_per_modality=(50, 70), cols=240, factors=4, seed=9)
    files = []
    for m, c in enumerate(sim.counts):
        files.append([str(tmp_path / f"m{m}.zarr")])
        create_sparse_from_csc(c, files[-1][0], [f"m{m}g{i}" for i in range(c.shape[0])],
                               [f"c{j}" for j in range(c.shape[1])])
    kw = dict(n_factors=5, sort_dim=5, iter_opt=10, block_size=100)
    j = jsvd.fit_joint_svd(files, str(tmp_path / "j"), **kw)
    assert port_cli(["senna", "joint-svd", "--data-files", *files[0], "--data-files", *files[1],
                     "--out", str(tmp_path / "t"), "--n-factors", "5", "--sort-dim", "5",
                     "--block-size", "100", "--device", "cpu"]) == 0
    t = tsvd.fit_joint_svd(files, str(tmp_path / "t2"), **kw, device="cpu")
    assert_factors_match(t["basis"], np.asarray(j["basis"]), t["factors"], j["factors"],
                         t["singular_values"])
    for name in ("latent", "dictionary"):
        assert list(read_table(str(tmp_path / f"t.{name}.parquet"))) == \
            list(read_table(str(tmp_path / f"j.{name}.parquet")))


def test_svd_cli_cnv_and_data_parallel(runs, tmp_path):
    out = str(tmp_path / "cli")
    argv = ["senna", "svd", "--data-files", runs["one"], "--out", out, "--n-factors", "4",
            "--block-size", "128", "--cnv", "--device", "cpu"]
    assert port_cli(argv) == 0
    cnv = read_table(out + ".cnv.parquet")
    assert list(cnv) == ["pseudobulk", "bin", "state", "log_ratio"]
    assert set(np.unique(cnv["state"])) <= {0, 1, 2}
    assert list(read_table(out + ".latent.parquet")) == ["cell", "f0", "f1", "f2", "f3"]
    with pytest.raises(NotImplementedError, match="--data-parallel"):
        port_cli(argv + ["--data-parallel"])
