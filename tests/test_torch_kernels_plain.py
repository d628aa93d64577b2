"""The port's plain block ops (the CPU path of kernels K1, K2 and K3)
against the JAX package's XLA functions and its Pallas kernels in
interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from legume_tpu.data.visitors import csc_to_coo_block as j_csc_to_coo_block
from legume_tpu.ops import sparse as jsparse
from legume_tpu.ops.pallas_kernels import (
    CHUNK,
    collapse_block_tiled,
    coo_project_pallas,
    project_block_tiled,
)
from legume_tpu.ops.random_projection import _project_block_normed as j_project_normed
from legume_tpu_torch.data.visitors import csc_to_coo_block
from legume_tpu_torch.ops import kernels
from legume_tpu_torch.ops import sparse as tsparse


def _block(d, n, density, seed, max_count=9):
    rng = np.random.default_rng(seed)
    dense = rng.integers(1, max_count, (d, n)) * (rng.random((d, n)) < density)
    dense[:, 3] = 0  # an empty cell
    return sp.csc_matrix(dense.astype(np.float32)), rng


def _torch_block(csc):
    blk = csc_to_coo_block(csc)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return blk, t(blk.row_ids), t(blk.col_ptr), t(blk.col_ids), t(blk.vals)


def _jax_xla_inputs(csc):
    blk = j_csc_to_coo_block(csc)
    return (
        blk,
        jnp.asarray(blk.row_ids.astype(np.int32)),
        jnp.asarray(blk.col_ids),
        jnp.asarray(blk.vals.astype(np.float32)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_project_block_matches_xla(seed):
    csc, rng = _block(300, 200, 0.1, seed)
    basis = rng.standard_normal((300, 16)).astype(np.float32)
    jblk, jr, jc, jv = _jax_xla_inputs(csc)
    want = np.asarray(jsparse.project_block(jnp.asarray(basis), jr, jc, jv, ncols=jblk.ncols))
    blk, r, p, c, v = _torch_block(csc)
    got = tsparse.project_block(torch.from_numpy(basis), r, c, v, ncols=blk.ncols).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    via_wrapper = kernels.project(torch.from_numpy(basis), r, p, v, normed=False).numpy()
    np.testing.assert_array_equal(via_wrapper, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_project_block_normed_matches_xla(seed):
    csc, rng = _block(300, 200, 0.1, seed)
    basis = rng.standard_normal((300, 24)).astype(np.float32)
    jblk, jr, jc, jv = _jax_xla_inputs(csc)
    want = np.asarray(j_project_normed(jnp.asarray(basis), jr, jc, jv, ncols=jblk.ncols))
    blk, r, p, c, v = _torch_block(csc)
    got = tsparse.project_block_normed(torch.from_numpy(basis), r, c, v, ncols=blk.ncols).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.all(got[3] == 0)  # the empty cell stays zero (1e-8 norm floor)
    via_wrapper = kernels.project(torch.from_numpy(basis), r, p, v, normed=True).numpy()
    np.testing.assert_array_equal(via_wrapper, got)


@pytest.mark.parametrize("num_groups", [7, 130])
def test_collapse_block_matches_xla(num_groups):
    csc, rng = _block(150, 400, 0.2, 5)
    seg = rng.integers(0, num_groups + 3, 400).astype(np.int32)  # some cells dropped
    jblk, jr, jc, jv = _jax_xla_inputs(csc)
    jseg = np.minimum(np.append(seg, num_groups), num_groups).astype(np.int32)
    want = np.asarray(jsparse.collapse_block(
        jr, jc, jv, jnp.asarray(jseg), num_genes=150, num_groups=num_groups
    ))
    blk, r, p, c, v = _torch_block(csc)
    got = tsparse.collapse_block(
        r, c, v, torch.from_numpy(seg), num_genes=150, num_groups=num_groups
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out = torch.ones(150, num_groups)
    kernels.collapse(r, p, v, torch.from_numpy(seg), num_genes=150, num_groups=num_groups, out=out)
    np.testing.assert_allclose(out.numpy(), got + 1.0, rtol=1e-6)


def test_raw_projection_matches_coo_pallas_interpret():
    rng = np.random.default_rng(0)
    d, n, k = 300, 200, 16
    m = sp.random(d, n, density=0.1, format="csc", random_state=1, dtype=np.float32)
    jblk = j_csc_to_coo_block(m, pad_to=CHUNK)
    basis = rng.normal(size=(d, k)).astype(np.float32)
    want = np.asarray(coo_project_pallas(
        jnp.asarray(basis), jnp.asarray(jblk.row_ids.astype(np.int32)),
        jnp.asarray(jblk.col_ids), jnp.asarray(jblk.vals.astype(np.float32)),
        ncols=jblk.ncols, interpret=True,
    ))
    blk, r, p, c, v = _torch_block(m)
    got = kernels.project(torch.from_numpy(basis), r, p, v, normed=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_projection_matches_tiled_pallas_interpret():
    rng = np.random.default_rng(3)
    d, k, ncols, nnz = 500, 48, 700, 20_000
    basis = rng.standard_normal((d, k)).astype(np.float32)
    rows = rng.integers(0, d, nnz)
    cols = np.sort(rng.integers(0, ncols, nnz))
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    lv = np.log1p(vals)
    proj = np.asarray(project_block_tiled(basis, rows, cols, lv, ncols=ncols, interpret=True))
    sq = np.zeros(ncols, np.float32)
    np.add.at(sq, cols, lv * lv)
    want = proj / np.maximum(np.sqrt(sq), 1e-8)[:, None]  # the function K1 serves
    ptr = np.zeros(ncols + 1, np.int32)
    np.cumsum(np.bincount(cols, minlength=ncols), out=ptr[1:])
    got = kernels.project(
        torch.from_numpy(basis), torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(ptr), torch.from_numpy(vals), normed=True,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_collapse_matches_tiled_pallas_interpret():
    rng = np.random.default_rng(4)
    d, ncols, s = 260, 300, 150
    csc, _ = _block(d, ncols, 0.1, 9)
    seg = rng.integers(0, s, ncols).astype(np.int32)
    jblk = j_csc_to_coo_block(csc)
    want = np.asarray(collapse_block_tiled(
        jblk.row_ids, jblk.col_ids, jblk.vals, np.append(seg, s),
        ncols=ncols, num_genes=d, num_groups=s, interpret=True,
    ))
    blk, r, p, c, v = _torch_block(csc)
    got = kernels.collapse(r, p, v, torch.from_numpy(seg), num_genes=d, num_groups=s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_helpers_match_xla():
    csc, _ = _block(120, 90, 0.3, 2)
    jblk, jr, jc, jv = _jax_xla_inputs(csc)
    blk, r, p, c, v = _torch_block(csc)
    np.testing.assert_array_equal(tsparse.col_ids_from_ptr(p).numpy(), blk.col_ids)
    np.testing.assert_array_equal(
        tsparse.col_ids_from_counts(torch.from_numpy(blk.col_counts)).numpy(),
        np.asarray(jsparse.col_ids_from_counts(
            jnp.asarray(jblk.col_counts), cap=len(jblk.row_ids), ncols=jblk.ncols
        ))[: blk.nnz],
    )
    np.testing.assert_allclose(
        tsparse.densify_block(r, c, v, ncols=90, num_genes=120).numpy(),
        np.asarray(jsparse.densify_block(jr, jc, jv, ncols=90, num_genes=120)),
    )
    np.testing.assert_allclose(
        tsparse.block_col_sums(c, v, ncols=90).numpy(),
        np.asarray(jsparse.block_col_sums(jc, jv, ncols=90)), rtol=1e-6,
    )
    for got, want in zip(
        tsparse.block_row_stats(r, v, num_genes=120), jsparse.block_row_stats(jr, jv, num_genes=120)
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on any device but the CPU goes to the kernel path: on a
    device the kernels cannot serve, the wrapper raises."""
    dev = torch.device("meta")
    basis = torch.empty(10, 4, device=dev)
    rows = torch.empty(5, dtype=torch.int32, device=dev)
    ptr = torch.empty(3, dtype=torch.int32, device=dev)
    vals = torch.empty(5, device=dev)
    with pytest.raises(ValueError):
        kernels.project(basis, rows, ptr, vals, normed=True)
    with pytest.raises(ValueError):
        kernels.collapse(rows, ptr, vals, torch.empty(2, dtype=torch.int32, device=dev),
                         num_genes=10, num_groups=2)
    with pytest.raises(ValueError):
        kernels.nce_epoch(torch.empty(3, 10, device=dev), torch.empty(10, device=dev),
                          torch.empty(10, 4, device=dev), torch.empty(10, device=dev),
                          torch.empty(3, 4, device=dev), torch.empty(3, device=dev),
                          torch.empty(3, device=dev), 5.0)
    assert kernels.launch_counts == {
        "project_normed": 0, "project_raw": 0, "collapse": 0, "nce_epoch": 0, "nce_epoch_axis": 0,
    }


def test_cpu_path_takes_any_width():
    basis = torch.zeros(10, 200)
    rows = torch.zeros(2, dtype=torch.int32)
    ptr = torch.tensor([0, 2], dtype=torch.int32)
    # the CPU path runs the plain version for any width
    assert kernels.project(basis, rows, ptr, torch.ones(2), normed=False).shape == (1, 200)
