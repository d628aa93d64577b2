"""The port's multi-GPU layer in one process, on the CPU: the shard plans,
per-column nonzeros and the padded COO shards equal the JAX package's;
the sharded collapse sums (through K3's plain version) within 1e-5 of the
JAX package's over its 8 virtual devices, from a `.zarr` store, with the
balanced and the uniform split, a plane wider than the groups present
and the simulated two-process view (the same reads, partials summing to
the whole); the gene moments' merge equals JAX's; and in a gloo world of
one the synced BatchNorm and the data-parallel trainer are bit-equal to
the plain module and trainer, and every path the second slice shards
(the kNN, cocoa's match cache and replay, the posterior samplers, gem,
bge, the masked trainer, lc) equals its run without a mesh. Two ranks:
`tests/test_torch_multiprocess.py`."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.data.sparse_io import open_sparse_matrix as jopen
from legume_tpu.ops import gene_stats as jgs
from legume_tpu.parallel import mesh as jmesh
from legume_tpu.parallel import multihost as jmh
from legume_tpu_torch.data import SparseIoVec
from legume_tpu_torch.data.sparse_io import open_sparse_matrix as topen
from legume_tpu_torch.models.encoders import FlaxBatchNorm
from legume_tpu_torch.ops import gene_stats as tgs
from legume_tpu_torch.parallel import mesh as tmesh
from legume_tpu_torch.parallel import multihost as tmh
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)
from torch_dp import WORLD_OF_ONE_CASES, trainer_fit


def _counts(seed: int, d: int, n: int, lam: float = 1.0) -> np.ndarray:
    return np.random.default_rng(seed).poisson(lam, (d, n)).astype(np.float32)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Two backends of 40 genes (120 and 80 cells), each package's vec over
    both, and a column subset of each."""
    tmp = tmp_path_factory.mktemp("par")
    dense = _counts(0, 40, 200)
    dense[:, 10:30] = 0  # an all-zero stretch
    dense[:, :8] *= 5  # a heavy head
    paths = []
    for b, (lb, ub) in enumerate([(0, 120), (120, 200)]):
        paths.append(str(tmp / f"b{b}.zarr"))
        create_sparse_from_csc(sp.csc_matrix(dense[:, lb:ub]), paths[-1],
                               [f"g{i}" for i in range(40)], [f"c{j}" for j in range(lb, ub)])
    from legume_tpu.data.vec import SparseIoVec as JVec

    jvec, tvec = JVec(), SparseIoVec()
    for p in paths:
        jvec.push(jopen(p))
        tvec.push(topen(p))
    keep = np.random.default_rng(1).random(200) > 0.3
    return dict(dense=dense, jvec=jvec, tvec=tvec, keep=keep)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank on a `HashStore`, destroyed after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["uniform", "heavy_head", "zeros", "more_shards_than_cols"])
def test_plan_column_shards_equals_jax(case):
    rng = np.random.default_rng(3)
    nnz = {"uniform": rng.integers(0, 50, 300),
           "heavy_head": np.concatenate([rng.integers(50, 100, 30), rng.integers(0, 5, 270)]),
           "zeros": np.concatenate([np.zeros(100, int), rng.integers(0, 9, 50)]),
           "more_shards_than_cols": rng.integers(0, 9, 5)}[case]
    for n_shards in (1, 2, 3, 8):
        np.testing.assert_array_equal(tmh.plan_column_shards(nnz, n_shards),
                                      jmh.plan_column_shards(nnz, n_shards))


def test_column_nnz_of_both_vecs_equals_jax(store):
    np.testing.assert_array_equal(tmh.column_nnz(store["tvec"]), jmh.column_nnz(store["jvec"]))
    np.testing.assert_array_equal(store["tvec"].column_nnz(), store["jvec"].column_nnz())
    sub_t, sub_j = (store[k].subset_columns(store["keep"]) for k in ("tvec", "jvec"))
    np.testing.assert_array_equal(sub_t.column_nnz(), sub_j.column_nnz())
    # a subset of a subset (the QC mask, then a rank's range) reads one hop
    half = np.arange(sub_t.num_columns) < sub_t.num_columns // 2
    np.testing.assert_array_equal(sub_t.subset_columns(half).column_nnz(),
                                  sub_j.subset_columns(half).column_nnz())
    np.testing.assert_array_equal(
        sub_t.subset_columns(half).read_columns_csc(np.arange(5)).toarray(),
        sub_j.subset_columns(half).read_columns_csc(np.arange(5)).toarray())


def test_shard_coo_by_cells_equals_jax(store):
    csc = sp.csc_matrix(store["dense"])
    groups = np.random.default_rng(2).integers(0, 6, 200)
    for n_shards in (1, 3, 8):
        for a, b in zip(tmh.shard_coo_by_cells(csc, groups, n_shards),
                        jmh.shard_coo_by_cells(csc, groups, n_shards)):
            np.testing.assert_array_equal(a, b)


def test_collapse_stats_sharded_matches_jax(store):
    csc = sp.csc_matrix(store["dense"])
    groups = np.random.default_rng(4).integers(0, 6, 200).astype(np.int32)
    shards = jmh.shard_coo_by_cells(csc, groups, 8)
    want = jmh.collapse_stats_sharded(jmesh.make_mesh(8), *shards, num_genes=40, num_groups=6)
    got = tmh.collapse_stats_sharded(tmesh.make_mesh("cpu"), *shards, num_genes=40,
                                     num_groups=6)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("extra_groups", [0, 3])
def test_collapse_observed_multihost_from_zarr_matches_jax(store, balanced, extra_groups):
    groups = np.random.default_rng(5).integers(0, 6, 200)
    kw = dict(num_groups=6 + extra_groups, block_size=32, nnz_balanced=balanced)
    want = jmh.collapse_observed_multihost(store["jvec"], groups, jmesh.make_mesh(8), **kw)
    got = tmh.collapse_observed_multihost(store["tvec"], groups, tmesh.make_mesh("cpu"),
                                          shards_per_rank=8, **kw)
    assert got.shape == (40, 6 + extra_groups)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    dense = np.zeros((40, 6 + extra_groups))
    np.add.at(dense.T, groups, store["dense"].T)
    np.testing.assert_allclose(got, dense, rtol=1e-5)


def test_simulated_two_process_view_reads_as_jax(store):
    groups = np.random.default_rng(6).integers(0, 5, 200)
    mesh = tmesh.make_mesh("cpu")
    partials = []
    for p in range(2):
        logs = {"jax": [], "port": []}
        want = jmh.collapse_observed_multihost(
            store["jvec"], groups, jmesh.make_mesh(8), num_groups=5, block_size=16,
            process_index=p, num_processes=2, read_log=logs["jax"])
        got = tmh.collapse_observed_multihost(
            store["tvec"], groups, mesh, num_groups=5, block_size=16, shards_per_rank=8,
            process_index=p, num_processes=2, read_log=logs["port"])
        assert logs["port"] == logs["jax"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        partials.append(got)
    whole = np.zeros((40, 5))
    np.add.at(whole.T, groups, store["dense"].T)
    np.testing.assert_allclose(partials[0] + partials[1], whole, rtol=1e-5)


def test_reduce_gene_stats_equals_jax(store):
    """Two halves' moments merged through a stand-in collective that adds
    the other half's raw sums: the merge equals JAX's and the whole's."""
    halves = [tgs.streaming_gene_stats(store["tvec"].subset_columns(
        (np.arange(200) < 90) == first), block_size=64, device="cpu") for first in (True, False)]
    other = halves[1]
    n = other.n_cells
    partner = [other.mean * n, (other.var + other.mean * other.mean) * n, other.pi * n,
               np.asarray([float(n)])]

    def reduce_sums(*arrays):
        return [a + b for a, b in zip(arrays, partner)]

    got = tgs.reduce_gene_stats(halves[0], reduce_sums)
    want = jgs.reduce_gene_stats(jgs.GeneStreamStats(halves[0].mean, halves[0].var,
                                                     halves[0].pi, halves[0].n_cells),
                                 reduce_sums)
    for name in ("mean", "var", "pi", "n_cells"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    whole = tgs.streaming_gene_stats(store["tvec"], block_size=64, device="cpu")
    np.testing.assert_allclose(got.mean, whole.mean, rtol=1e-5)
    np.testing.assert_allclose(got.var, whole.var, rtol=1e-4, atol=1e-5)
    assert got.n_cells == 200


def test_mesh_shares_rows_as_jax_pads_them():
    shares = [tmesh.data_sharding(tmesh.Mesh(4, r, torch.device("cpu"), {tmesh.DATA_AXIS: 4}),
                                  10) for r in range(4)]
    assert shares == [(0, 3), (3, 6), (6, 9), (9, 10)]
    mesh = tmesh.Mesh(4, 3, torch.device("cpu"), {tmesh.DATA_AXIS: 4})
    rows = tmesh.shard_rows(mesh, np.arange(20, dtype=np.float32).reshape(10, 2))
    np.testing.assert_array_equal(rows.numpy(), [[18, 19], [0, 0], [0, 0]])
    np.testing.assert_array_equal(tmh.block_bounds(10, 3, 2), [0, 6, 10])
    with pytest.raises(AssertionError):
        tmesh.make_mesh("cpu", gene_parallel=2)


def test_world_of_one_has_no_dist_context(world_of_one):
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert tmh.DistContext.detect() is None
    t = torch.arange(4.0)
    assert tmesh.replicate(mesh, t) is t


def test_synced_batchnorm_world_of_one_equals_plain(world_of_one):
    mesh = tmesh.Mesh(1, 0, torch.device("cpu"), {tmesh.DATA_AXIS: 1}, group=dist.group.WORLD)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(33, 7)).astype(np.float32))
    out = {}
    for name in ("plain", "synced"):
        bn = FlaxBatchNorm(7)
        bn.mesh = mesh if name == "synced" else None
        xi = x.clone().requires_grad_(True)
        y = bn(xi, train=True)
        (y * torch.arange(7.0)).sum().backward()
        out[name] = (y.detach(), xi.grad, bn.weight.grad, bn.running_mean, bn.running_var)
    for a, b in zip(out["plain"], out["synced"]):
        assert torch.equal(a, b)


def test_trainer_world_of_one_equals_plain(world_of_one):
    z_mesh, llik_mesh = trainer_fit("cpu", True)
    dist.destroy_process_group()
    z_plain, llik_plain = trainer_fit("cpu", False)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    np.testing.assert_array_equal(z_mesh, z_plain)
    assert llik_mesh == llik_plain


@pytest.mark.parametrize("item", sorted(WORLD_OF_ONE_CASES))
def test_world_of_one_is_the_plain_run(world_of_one, item):
    """The kNN, the match cache, the replay, the posterior samplers, gem's
    fits, bge's two phases, the masked trainer and lc's sweeps on the mesh
    of a gloo world of one: bit-equal to `mesh=None` (the JAX package's
    one-device rule, `tests/test_posterior.py::test_pb_gibbs_mesh_single_device_exact`)."""
    mesh = tmesh.make_mesh("cpu")
    assert mesh.size == 1
    plain = WORLD_OF_ONE_CASES[item](None, "cpu")
    one = WORLD_OF_ONE_CASES[item](mesh, "cpu")
    assert sorted(one) == sorted(plain)
    for name, want in plain.items():
        np.testing.assert_array_equal(one[name], want, err_msg=name)
