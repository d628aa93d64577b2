"""The port's multi-GPU layer in a world of two ranks over gloo, on the
CPU: two subprocesses on one torch thread each, started once, run every
check of the module (the host collectives, the trainer, the `senna
topic`, `svd` and `vae --data-parallel` commands, then the kNN, cocoa's
match cache and replay, gem's fits, bge's two phases, the masked trainer
and lc's sweeps, and the `cocoa diff`, `senna bge`, `faba gem` /
`gem-encoder`, `senna masked-topic` and `pinto lc --data-parallel`
commands). Two more, a world of their own, run the posterior samplers
beside them: their gene blocks wait on one gather a shrink iteration.
This process holds what they wrote against a world of one (the same
command with `--data-parallel` and no process group) and against the JAX
package on `make_mesh(2)` over the virtual CPU devices. Each rank's
process group has a 60 s timeout; the parent kills every rank after
180 s.

Bars: the JAX package's own for a run over more processes
(`tests/test_multiprocess.py`, `tests/test_multihost.py`,
`tests/test_trainer_mesh.py`): the partition and the QC keep mask equal,
topic proportions within 0.05 with the dominant topic agreeing for more
than 95% of cells, the llik trace within rtol 2e-2, atol 1e-2; the
trainer's latent within 2e-3 and its last llik within 1e-4; svd's
factors within rtol 1e-5, atol 1e-6; the kNN's and the match cache's
indices equal, distances within 1e-5 (`tests/test_cocoa_mesh.py`); the
replay's planes within rtol 2e-4, atol 1e-4; the samplers' recovery bars
(`tests/test_posterior.py`) at its sweep counts with an odd anchor count,
`pb_gibbs`' and `gem_gibbs`' PIPs within 0.1 of JAX's two-device run on
average; gem within rtol 2e-3, atol 2e-5 and
bge's cell embedding within rtol 5e-3, atol 5e-5
(`tests/test_trainer_mesh.py`); the masked trace within rtol 1e-4 and
rho within rtol 2e-3, atol 2e-5 (`tests/test_indexed.py`); lc above 0.85
accuracy on planted communities (`tests/test_pinto.py`)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.utils.output import read_table
from torch_dp import (SLICE19_CASES, TOPIC_ARGV, bge_inputs, cocoa_inputs, dist_inputs, ess_inputs,
                      gem_gibbs_inputs, knn_inputs, lc_inputs, pb_gibbs_inputs, slice19_cases,
                      slice19_commands, slice19_stores, trainer_fit, two_batch_store)

VAE_ARGV = ["-k", "4", "--encoder-layers", "16", "8", "--epochs", "6", "--minibatch-size", "40",
            "--block-size", "64", "--sort-dim", "3", "--hvg-genes", "30", "--seed", "11"]
SVD_ARGV = ["--n-factors", "5", "--block-size", "64", "--seed", "11"]

# Both ranks run this; every collective comes in the same order on each.
_WORKER = textwrap.dedent(
    """
    import json, sys
    from datetime import timedelta
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    work, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    from legume_tpu_torch.parallel.multihost import DistContext, maybe_initialize_distributed
    assert maybe_initialize_distributed(coord, 2, rank, device="cpu",
                                        timeout=timedelta(seconds=60))
    sys.path.insert(0, sys.argv[4])
    from torch_dp import dist_inputs, trainer_fit

    ctx = DistContext.detect()
    assert ctx is not None and (ctx.process_index, ctx.process_count) == (rank, 2)
    rows, bounds, sums, stat = dist_inputs(rank)
    gathered = ctx.allgather_rows(rows, bounds)
    reduced = ctx.reduce_sums(*sums)
    stat = ctx.reduce_stat(stat)
    z, llik = trainer_fit("cpu", True)
    np.savez(f"{work}/rank{rank}.npz", gathered=gathered, z=z, llik=llik,
             **{f"sum{i}": r for i, r in enumerate(reduced)},
             **{f"stat_{k}": v for k, v in vars(stat).items()})

    from legume_tpu_torch.cli.main import main
    cmd = json.loads(sys.argv[5])
    for argv in cmd:
        assert main(argv) == 0, argv

    from legume_tpu_torch.parallel.mesh import make_mesh
    from torch_dp import SLICE19_CASES, slice19_cases
    items = [k for k in SLICE19_CASES if k != "posterior_samplers"]
    np.savez(f"{work}/s19_rank{rank}.npz", **slice19_cases(make_mesh("cpu"), items=items))
    dist.destroy_process_group()
    """
)

# The posterior samplers in a world of two of their own.
_SAMPLER_WORKER = textwrap.dedent(
    """
    import sys
    from datetime import timedelta
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    work, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    from legume_tpu_torch.parallel.mesh import make_mesh
    from legume_tpu_torch.parallel.multihost import maybe_initialize_distributed
    assert maybe_initialize_distributed(coord, 2, rank, device="cpu",
                                        timeout=timedelta(seconds=60))
    sys.path.insert(0, sys.argv[4])
    from torch_dp import slice19_cases
    out = slice19_cases(make_mesh("cpu"), items=["posterior_samplers"])
    np.savez(f"{work}/samplers_rank{rank}.npz", **out)
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _slice19_commands(stores: dict, prefix) -> list[list[str]]:
    """`slice19_commands` on the CPU, two of them cut for the two-rank run:
    gem without `--posterior` (the sampler's mesh is held by the function
    cases) and masked-topic at 2 epochs."""
    cmds = slice19_commands(stores, prefix)
    gem = cmds["gem"]
    i = gem.index("--posterior")
    cmds["gem"] = gem[:i] + gem[i + 2 :]
    masked = cmds["masked"]
    masked[masked.index("--epochs") + 1] = "2"
    return list(cmds.values())


def _commands(files, out: dict) -> list[list[str]]:
    data = ["--data-files", *files]
    return [["senna", "topic", *data, "--out", out["topic"], *TOPIC_ARGV],
            ["senna", "vae", *data, "--out", out["vae"], *VAE_ARGV],
            ["senna", "svd", *data, "--out", out["svd"], *SVD_ARGV]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, started first; the world of one and the JAX package's
    partition meanwhile in this process."""
    import torch

    tmp = tmp_path_factory.mktemp("dp")
    files = two_batch_store(tmp)
    stores = {w: slice19_stores(tmp, f"_{w}") for w in (1, 2)}
    for r in range(2):
        (tmp / f"rank{r}").mkdir()
    # the topic run's prefix is relative: each rank writes under its own
    # working directory, so rank 1's stays empty if it writes nothing
    two = {"topic": "topic2", "vae": str(tmp / "vae2"), "svd": str(tmp / "svd2")}
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
           "OMP_NUM_THREADS": "1"}
    argv = json.dumps([c + ["--data-parallel", "--device", "cpu"] for c in _commands(files, two)]
                      + _slice19_commands(stores[2], "."))

    def spawn(name, source, *extra):
        """Two ranks running `source`, each logging to `<name><rank>.log`."""
        script = tmp / f"{name}.py"
        script.write_text(source)
        coord = f"127.0.0.1:{_free_port()}"
        procs = []
        for r in range(2):
            with open(tmp / f"{name}{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(tmp), coord, str(r),
                     str(Path(__file__).parent), *extra],
                    cwd=tmp / f"rank{r}", env=env, stdout=log, stderr=subprocess.STDOUT))
        return procs

    procs, deadline = [], time.monotonic() + 180
    try:
        procs += spawn("samplers", _SAMPLER_WORKER)
        procs += spawn("worker", _WORKER, argv)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        one = {k: str(tmp / f"{k}1") for k in ("topic", "vae", "svd")}
        for c in _commands(files, one):
            assert port_cli(c + ["--data-parallel", "--device", "cpu"]) == 0
        z1, llik1 = trainer_fit("cpu", False)
        (tmp / "one19").mkdir()
        for c in _slice19_commands(stores[1], str(tmp / "one19")):
            assert port_cli(c) == 0, c
        # the world of one of every case the world of two is compared with
        # (the samplers are held to their recovery bars instead)
        s19_one = slice19_cases(None, items=[k for k in SLICE19_CASES
                                             if k != "posterior_samplers"])
        torch.set_num_threads(threads)
        jax_groups = _jax_fine_groups(files)
        s19_jax = _jax_slice19()
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp / f"{name}{r}.log").read_text() for name in ("samplers", "worker")
            for r in range(2)]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    logs = logs[2:]  # the command ranks'
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    s19 = [{**np.load(tmp / f"s19_rank{r}.npz"), **np.load(tmp / f"samplers_rank{r}.npz")}
           for r in range(2)]
    return dict(tmp=tmp, one=one, ranks=ranks, trainer1=(z1, llik1), jax_groups=jax_groups,
                logs=logs, s19=s19, s19_one=s19_one, s19_jax=s19_jax, stores=stores)


def _jax_fine_groups(files):
    from legume_tpu.data.qc import compute_cell_qc
    from legume_tpu.senna import topic as jtopic

    args = jtopic.TopicArgs(data_files=files, n_latent_topics=4, proj_dim=8, sort_dim=3,
                            num_levels=2, block_size=64, hvg_genes=30, knn_cells=4, seed=11)
    vec = jtopic.load_data_vec(files)
    vec = vec.subset_columns(compute_cell_qc(vec, block_size=64).keep_mask(min_total=1.0))
    return jtopic.load_and_collapse(vec, args).groups_per_level[0]


def _jax_slice19() -> dict:
    """The JAX package's runs of `slice19_cases`' inputs on `make_mesh(2)`."""
    import scipy.sparse as sp
    from legume_tpu.cocoa.collapse import build_match_cache
    from legume_tpu.data.sparse_io import MemoryBackend
    from legume_tpu.embedding.nce import NceConfig, fit_bge
    from legume_tpu.embedding.posterior import gem_gibbs, pb_gibbs
    from legume_tpu.ops.knn import knn_search
    from legume_tpu.parallel.mesh import make_mesh
    from legume_tpu.pinto.lc import _fit_edge_labels

    mesh, out = make_mesh(2), {}
    q, pts = knn_inputs()
    out["knn_dist"], out["knn_idx"] = knn_search(q, pts, 6, chunk=32, mesh=mesh)
    _, proj, cell_indv, *_ = cocoa_inputs()
    cache = build_match_cache(proj, cell_indv, 8, knn=4, mesh=mesh)
    out["cache_idx"], out["cache_dist"], out["cache_valid"] = cache.idx, cache.dist, cache.valid
    args, kw, _ = pb_gibbs_inputs()
    out["pb_gibbs_pip"] = pb_gibbs(*args, **kw, mesh=mesh).pip
    args, kw = gem_gibbs_inputs()
    res = gem_gibbs(*args, **kw, mesh=mesh)
    out["gem_gibbs_beta_pip"], out["gem_gibbs_delta_pip"] = res.beta_pip, res.delta_pip
    pbp, y, cfg = bge_inputs()
    out["bge_e_cell"] = fit_bge([pbp], data=MemoryBackend(sp.csc_matrix(y.T)),
                                config=NceConfig(**cfg), mesh=mesh).e_cell
    prof, _, kw = lc_inputs()
    out["lc_labels"] = _fit_edge_labels(prof, 3, **kw, mesh=mesh)[0]
    return out


def test_host_collectives_concatenate_and_sum_in_rank_order(runs):
    inputs = [dist_inputs(r) for r in range(2)]
    want_rows = np.concatenate([inputs[0][0], inputs[1][0]])
    for got in runs["ranks"]:
        np.testing.assert_array_equal(got["gathered"], want_rows)
        for i, (a, b) in enumerate(zip(inputs[0][2], inputs[1][2])):
            want = (a + b).astype(a.dtype)
            assert got[f"sum{i}"].dtype == a.dtype
            np.testing.assert_array_equal(got[f"sum{i}"], want)
        for name, a in vars(inputs[0][3]).items():
            np.testing.assert_array_equal(got[f"stat_{name}"], a + getattr(inputs[1][3], name))


def test_trainer_world_of_two_matches_world_of_one(runs):
    z1, llik1 = runs["trainer1"]
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r0["z"], r1["z"])  # every rank holds the same model
    np.testing.assert_allclose(r0["z"], z1, atol=2e-3)
    np.testing.assert_allclose(r0["llik"], llik1, rtol=1e-4, atol=1e-4)


def _topic_table(prefix, name):
    return read_table(f"{prefix}.{name}.parquet")


def _matrix(table) -> np.ndarray:
    """The numeric columns of a per-cell table, cells as rows."""
    return np.column_stack([v for k, v in table.items() if k != "cell"])


def test_topic_cli_world_of_two_matches_world_of_one(runs):
    tmp, one = runs["tmp"], runs["one"]["topic"]
    two = str(tmp / "rank0" / "topic2")
    assert list((tmp / "rank1").iterdir()) == []  # only rank 0 writes
    assert (_topic_table(one, "qc")["keep"] == _topic_table(two, "qc")["keep"]).all()
    with np.load(f"{one}.partition.npz") as a, np.load(f"{two}.partition.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    z1, z2 = (np.exp(_matrix(_topic_table(p, "latent"))) for p in (one, two))
    assert list(_topic_table(one, "latent")["cell"]) == list(_topic_table(two, "latent")["cell"])
    np.testing.assert_allclose(z2, z1, atol=0.05)
    assert (z1.argmax(1) == z2.argmax(1)).mean() > 0.95
    np.testing.assert_allclose(_topic_table(two, "log_likelihood")["llik"],
                               _topic_table(one, "log_likelihood")["llik"], rtol=2e-2, atol=1e-2)
    # the ranks' cell ranges: disjoint, covering every cell QC kept
    ranges = []
    for log in runs["logs"]:
        line = next(ln for ln in log.splitlines() if "owns cells" in ln)
        lb, ub = line.rsplit("[", 1)[1].rstrip(")").split(", ")
        ranges.append((int(lb), int(ub)))
    assert ranges[0][0] == 0 and ranges[0][1] == ranges[1][0] and ranges[1][1] == len(z1)


def test_topic_partition_equals_the_jax_packages(runs):
    with np.load(str(runs["tmp"] / "rank0" / "topic2.partition.npz")) as z:
        np.testing.assert_array_equal(z["fine_groups"], runs["jax_groups"])


def test_vae_and_svd_world_of_two_match_world_of_one(runs):
    one, tmp = runs["one"], runs["tmp"]
    llik1 = read_table(one["vae"] + ".log_likelihood.parquet")["llik"]
    llik2 = read_table(str(tmp / "vae2.log_likelihood.parquet"))["llik"]
    np.testing.assert_allclose(llik2[-1], llik1[-1], rtol=1e-4, atol=1e-4)
    f1 = _matrix(read_table(one["svd"] + ".latent.parquet"))
    f2 = _matrix(read_table(str(tmp / "svd2.latent.parquet")))
    np.testing.assert_allclose(f2, f1, rtol=1e-5, atol=1e-6)


def test_world_of_two_model_loads_in_both_packages(runs, monkeypatch):
    """Rank 0's saved model is a plain run's: the port's loader and the JAX
    package's encode alike from it (its gene list is named relative to the
    rank's working directory, as a plain run's with a relative prefix)."""
    import torch
    from legume_tpu.models.encoders import LogSoftmaxEncoder
    from legume_tpu.senna import topic as jtopic
    from legume_tpu_torch.senna import topic as ttopic

    monkeypatch.chdir(runs["tmp"] / "rank0")
    prefix = "topic2"
    meta, flat, genes = ttopic.load_model(prefix)
    encoder = ttopic.build_encoder(meta, flat, device="cpu")
    _, variables, jgenes = jtopic.load_model(prefix)
    assert genes == jgenes and meta["n_features"] == 40
    x = np.random.default_rng(0).poisson(2.0, (16, 40)).astype(np.float32)
    with torch.no_grad():
        got = encoder(torch.from_numpy(x), train=False)[0].numpy()
    enc = LogSoftmaxEncoder(n_topics=4, layers=(16, 16))
    want = enc.apply({"params": variables["params"]["encoder"],
                      "batch_stats": variables["batch_stats"]["encoder"]}, x, None, train=False)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


# ---- the kNN, cocoa, the samplers, gem, bge, the masked trainer, lc --------


def test_every_rank_holds_the_same_results(runs):
    r0, r1 = runs["s19"]
    assert set(runs["s19_one"]) < set(r0)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)


def test_knn_and_match_cache_world_of_two_equal_jax_and_world_of_one(runs):
    two, one, jx = runs["s19"][0], runs["s19_one"], runs["s19_jax"]
    for ref in (one, jx):
        np.testing.assert_array_equal(two["knn_idx"], ref["knn_idx"])
        np.testing.assert_allclose(two["knn_dist"], ref["knn_dist"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(two["cache_idx"], ref["cache_idx"])
        np.testing.assert_array_equal(two["cache_valid"], ref["cache_valid"])
        np.testing.assert_allclose(two["cache_dist"], ref["cache_dist"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", ["replay", "replay3"])
def test_replay_world_of_two_matches_world_of_one(runs, tag):
    """T = 6 over two ranks: whole chunks, and `t_chunk=3` (each chunk pads
    one exposure-0 row that must not reach the output)."""
    two, one = runs["s19"][0], runs["s19_one"]
    for plane in ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip"):
        got = two[f"{tag}_{plane}"]
        assert got.shape[0] == 6
        np.testing.assert_allclose(got, one[f"{tag}_{plane}"], rtol=2e-4, atol=1e-4,
                                   err_msg=plane)


def test_posterior_samplers_world_of_two_recover(runs):
    two, jx = runs["s19"][0], runs["s19_jax"]
    _, _, truth = pb_gibbs_inputs()
    active, e_pb, z_true = truth["active"], truth["e_pb"], truth["z_true"]
    pip = two["pb_gibbs_pip"]
    assert pip.shape == active.shape and two["pb_gibbs_e_pb_mean"].shape == e_pb.shape
    num = den = 0.0
    for dim in range(active.shape[1]):
        for a in pip[active[:, dim], dim]:
            for b in pip[~active[:, dim], dim]:
                den += 1
                num += (a > b) + 0.5 * (a == b)
    assert num / den > 0.75
    s_est = two["pb_gibbs_e_pb_mean"] @ two["pb_gibbs_e_feat_mean"].T
    assert np.corrcoef((e_pb @ z_true.T).ravel(), s_est.ravel())[0, 1] > 0.8
    assert np.abs(pip - jx["pb_gibbs_pip"]).mean() < 0.1
    dpip = two["gem_gibbs_delta_pip"]
    assert dpip[:10].mean() > dpip[20:55].mean() + 0.25
    assert np.all(dpip <= two["gem_gibbs_beta_pip"] + 1e-6)
    assert two["gem_gibbs_e_pb_mean"].shape == (35, 4)
    for name in ("gem_gibbs_beta_pip", "gem_gibbs_delta_pip"):
        assert np.abs(two[name] - jx[name]).mean() < 0.1, name
    _, _, e_true = ess_inputs()
    assert two["ess_e_mean"].shape == e_true.shape and np.isfinite(two["ess_lnpdf"]).all()
    for hh in range(e_true.shape[1]):
        assert np.corrcoef(two["ess_e_mean"][:, hh], e_true[:, hh])[0, 1] > 0.75


def test_gem_and_bge_world_of_two_match_world_of_one(runs):
    two, one = runs["s19"][0], runs["s19_one"]
    for name in ("gem_e_feat", "gem_delta", "gem_pb_e", "gem_enc_rho"):
        np.testing.assert_allclose(two[name], one[name], rtol=2e-3, atol=2e-5, err_msg=name)
    assert two["bge_pb"].shape == one["bge_pb"].shape == (31, 6)  # the pad row dropped
    for ref in (one, runs["s19_jax"]):
        np.testing.assert_allclose(two["bge_e_cell"], ref["bge_e_cell"], rtol=5e-3, atol=5e-5)
    np.testing.assert_allclose(two["bge_p1"], one["bge_p1"], rtol=1e-4)
    np.testing.assert_allclose(two["bge_p2"], one["bge_p2"], rtol=1e-4)


def test_masked_trainer_world_of_two_matches_world_of_one(runs):
    two, one = runs["s19"][0], runs["s19_one"]
    np.testing.assert_allclose(two["masked_trace"], one["masked_trace"], rtol=1e-4)
    np.testing.assert_allclose(two["masked_rho"], one["masked_rho"], rtol=2e-3, atol=2e-5)


def test_lc_world_of_two_recovers_and_follows_jax(runs):
    labels = runs["s19"][0]["lc_labels"]
    _, true, _ = lc_inputs()
    acc = sum(np.bincount(true[labels == kk], minlength=3).max()
              for kk in range(3) if (labels == kk).any()) / len(true)
    assert acc > 0.85, acc
    differ = int((labels != runs["s19_jax"]["lc_labels"]).sum())
    print(f"lc at a world of two: accuracy {acc:.3f}, {differ} of {len(labels)} labels "
          "differ from JAX's two-device run")
    assert differ <= 0.01 * len(labels)


def _table(path):
    t = read_table(path)
    return np.column_stack([np.asarray(v, np.float64) for k, v in t.items()
                            if k not in ("cell", "gene", "phase", "feature")])


@pytest.mark.parametrize("cmd", ["cocoa", "bge", "gem", "gem_encoder", "masked", "lc"])
def test_commands_world_of_two_match_world_of_one(runs, cmd, monkeypatch):
    """Each command at a world of two (rank 0's outputs under its working
    directory; rank 1 writes nothing) against the world of one."""
    tmp = runs["tmp"]
    two, one = tmp / "rank0" / cmd, tmp / "one19" / cmd
    assert list((tmp / "rank1").iterdir()) == []
    if cmd == "cocoa":
        for name in ("effect", "pvalue"):
            np.testing.assert_allclose(_table(f"{two}.{name}.parquet"),
                                       _table(f"{one}.{name}.parquet"), rtol=1e-4, atol=1e-4)
        # one cache file beside the store (the store is a directory), rank 0's
        caches = [p.name for p in (Path(runs["stores"][2]["cocoa"]) / "match_cache").iterdir()]
        assert len(caches) == 1 and caches[0].endswith(".npz"), caches
    elif cmd == "bge":
        for name in ("latent", "feature_embedding"):
            np.testing.assert_allclose(_table(f"{two}.{name}.parquet"),
                                       _table(f"{one}.{name}.parquet"), rtol=5e-3, atol=5e-5)
        pip = [read_table(f"{p}.feature_posterior.parquet")["pip"] for p in (two, one)]
        assert np.abs(np.asarray(pip[0]) - np.asarray(pip[1])).mean() < 0.1
    elif cmd in ("gem", "gem_encoder"):
        for name in ("gene_embedding", "velocity", "latent"):
            np.testing.assert_allclose(_table(f"{two}.{name}.parquet"),
                                       _table(f"{one}.{name}.parquet"), rtol=2e-3, atol=2e-5)
    elif cmd == "masked":
        np.testing.assert_allclose(_table(f"{two}.loss.parquet"),
                                   _table(f"{one}.loss.parquet"), rtol=1e-4)
        np.testing.assert_allclose(_table(f"{two}.latent.parquet"),
                                   _table(f"{one}.latent.parquet"), rtol=2e-3, atol=2e-4)
        # rank 0's model loads in both packages as the world of one's does
        # (its gene list is named relative to the rank's working directory)
        from legume_tpu.senna.topic import load_model as jload
        from legume_tpu_torch.senna.topic import load_model as tload

        monkeypatch.chdir(tmp / "rank0")
        (m2, f2, g2), (m1, f1, g1) = tload(str(two)), tload(str(one))
        assert m2["model_type"] == m1["model_type"] == "masked-topic" and g2 == g1
        np.testing.assert_allclose(f2["params/rho"], f1["params/rho"], rtol=2e-3, atol=2e-5)
        assert jload(str(two))[2] == g2
    else:
        domain = runs["stores"][2]["domain"]
        for prefix in (two, one):
            prop = _table(f"{prefix}.propensity.parquet")[:, :3]
            lab = prop.argmax(1)
            acc = sum(np.bincount(domain[lab == kk], minlength=3).max()
                      for kk in range(3) if (lab == kk).any()) / len(domain)
            assert acc > 0.85, (prefix, acc)
        e2, e1 = (read_table(f"{p}.edges.parquet")["community"] for p in (two, one))
        print(f"lc: {int((np.asarray(e2) != np.asarray(e1)).sum())} of {len(e1)} edge labels "
              "differ between the worlds of two and one")
        line = next(ln for ln in runs["logs"][1].splitlines() if "sweeps edges" in ln)
        assert "rank 1" in line
