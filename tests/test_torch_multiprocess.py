"""The port's multi-GPU layer in a world of two ranks over gloo, on the
CPU: two subprocesses on one torch thread each, started once, run every
check of the module (the host collectives, the trainer, and the `senna
topic`, `svd` and `vae --data-parallel` commands), and this process
holds what they wrote against a world of one (the same command with
`--data-parallel` and no process group) and, for the partition, against
the JAX package's `load_and_collapse`. Each rank's process group has a
60 s timeout; the parent kills both after 180 s.

Bars: the JAX package's own for a run over more processes
(`tests/test_multiprocess.py`, `tests/test_multihost.py`,
`tests/test_trainer_mesh.py`): the partition and the QC keep mask equal,
topic proportions within 0.05 with the dominant topic agreeing for more
than 95% of cells, the llik trace within rtol 2e-2, atol 1e-2; the
trainer's latent within 2e-3 and its last llik within 1e-4; svd's
factors within rtol 1e-5, atol 1e-6."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.utils.output import read_table
from torch_dp import TOPIC_ARGV, dist_inputs, trainer_fit, two_batch_store

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
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    for r in range(2):
        (tmp / f"rank{r}").mkdir()
    # the topic run's prefix is relative: each rank writes under its own
    # working directory, so rank 1's stays empty if it writes nothing
    two = {"topic": "topic2", "vae": str(tmp / "vae2"), "svd": str(tmp / "svd2")}
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
           "OMP_NUM_THREADS": "1"}
    argv = json.dumps([c + ["--data-parallel", "--device", "cpu"] for c in _commands(files, two)])
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp), coord, str(r),
                               str(Path(__file__).parent), argv],
                              cwd=tmp / f"rank{r}", env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        one = {k: str(tmp / f"{k}1") for k in ("topic", "vae", "svd")}
        for c in _commands(files, one):
            assert port_cli(c + ["--data-parallel", "--device", "cpu"]) == 0
        z1, llik1 = trainer_fit("cpu", False)
        torch.set_num_threads(threads)
        jax_groups = _jax_fine_groups(files)
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return dict(tmp=tmp, one=one, ranks=ranks, trainer1=(z1, llik1), jax_groups=jax_groups,
                logs=logs)


def _jax_fine_groups(files):
    from legume_tpu.data.qc import compute_cell_qc
    from legume_tpu.senna import topic as jtopic

    args = jtopic.TopicArgs(data_files=files, n_latent_topics=4, proj_dim=8, sort_dim=3,
                            num_levels=2, block_size=64, hvg_genes=30, knn_cells=4, seed=11)
    vec = jtopic.load_data_vec(files)
    vec = vec.subset_columns(compute_cell_qc(vec, block_size=64).keep_mask(min_total=1.0))
    return jtopic.load_and_collapse(vec, args).groups_per_level[0]


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
