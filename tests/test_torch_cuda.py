"""The port's CUDA kernels (K1, K2, K3) against their plain torch
versions on the card, and the `senna topic` slice on the card against
the same slice on the CPU.

Marked `cuda`: without a CUDA device every test skips. On a machine with
one, run them (the JAX package need not be installed there) with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from legume_tpu_torch.data import MemoryBackend, SparseIoVec
from legume_tpu_torch.data.sim import simulate_topic
from legume_tpu_torch.data.visitors import csc_to_coo_block
from legume_tpu_torch.ops import kernels
from legume_tpu_torch.senna import topic as ttopic

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()
    return torch.device("cuda")


def _block(d, n, density, seed):
    rng = np.random.default_rng(seed)
    dense = rng.integers(1, 30, (d, n)) * (rng.random((d, n)) < density)
    dense[:, 3] = 0  # an empty cell
    return csc_to_coo_block(sp.csc_matrix(dense.astype(np.float32))), rng


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("k", [7, 32, 50, 128])
@pytest.mark.parametrize("normed", [True, False])
def test_project_kernel_matches_plain(dev, k, normed):
    blk, rng = _block(500, 300, 0.2, k)
    basis = rng.standard_normal((500, k)).astype(np.float32)
    b, rows, ptr, vals = _to(dev, basis, blk.row_ids, blk.col_ptr, blk.vals)
    before = dict(kernels.launch_counts)
    got = kernels.project(b, rows, ptr, vals, normed=normed)
    want = kernels.project_plain(b, rows, ptr, vals, normed=normed)
    torch.cuda.synchronize()
    name = "project_normed" if normed else "project_raw"
    assert kernels.launch_counts[name] == before[name] + 1
    rtol = 2e-4 if normed else 1e-4
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    assert float(got[3].abs().max()) == 0.0  # the empty cell


@pytest.mark.parametrize("num_groups", [1, 7, 130])
def test_collapse_kernel_matches_plain(dev, num_groups):
    blk, rng = _block(400, 300, 0.2, num_groups)
    seg = rng.integers(0, num_groups + 2, blk.ncols).astype(np.int32)  # >= S drops the cell
    rows, ptr, vals, s = _to(dev, blk.row_ids, blk.col_ptr, blk.vals, seg)
    kw = dict(num_genes=400, num_groups=num_groups)
    got = kernels.collapse(rows, ptr, vals, s, **kw)
    want = kernels.collapse_plain(rows, ptr, vals, s, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # accumulation into a resident plane
    plane = want.clone()
    kernels.collapse(rows, ptr, vals, s, out=plane, **kw)
    torch.testing.assert_close(plane, 2 * want, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    blk, rng = _block(50, 20, 0.3, 0)
    rows, ptr, vals = _to(dev, blk.row_ids, blk.col_ptr, blk.vals)
    basis = torch.randn(50, 16, device=dev)
    with pytest.raises(TypeError):
        kernels.project(basis, rows.long(), ptr, vals, normed=True)
    with pytest.raises(ValueError):
        kernels.project(torch.randn(50, 129, device=dev), rows, ptr, vals, normed=True)
    with pytest.raises(ValueError):
        kernels.project(torch.randn(16, 50, device=dev).T, rows, ptr, vals, normed=True)
    with pytest.raises(ValueError):
        kernels.collapse(rows, ptr, vals, torch.zeros(3, dtype=torch.int32, device=dev),
                         num_genes=50, num_groups=2)


def _small_vec():
    sim = simulate_topic(rows=200, cols=600, factors=4, batches=2, seed=17)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    vec.register_batches(sim.batch.astype(str))
    return vec


def test_slice_on_the_card_matches_the_cpu(dev, tmp_path):
    vec = _small_vec()
    common = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=3, block_size=256)
    kernels.reset_launch_counts()
    gpu = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "gpu"), **common),
                                 vec=vec, device=dev)
    launches = dict(kernels.launch_counts)
    cpu = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "cpu"), **common),
                                 vec=vec, device="cpu")
    assert launches["project_normed"] > 0 and launches["collapse"] > 0
    gl, cl = gpu["levels"], cpu["levels"]
    np.testing.assert_allclose(gl.proj_kn, cl.proj_kn, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(gl.fine_codes, cl.fine_codes)
    for g, c in zip(gl.groups_per_level, cl.groups_per_level):
        np.testing.assert_array_equal(g, c)
    for go, co in zip(gl.collapsed, cl.collapsed):
        for plane in ("mu_observed", "mu_adjusted", "mu_residual"):
            gp, cp = getattr(go, plane), getattr(co, plane)
            np.testing.assert_allclose(gp.a.cpu().numpy(), cp.a.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(gp.b.cpu().numpy(), cp.b.numpy(), rtol=1e-5, atol=1e-5)
    z = gpu["latent"]
    assert z.shape == (600, 4) and np.isfinite(z).all()
    np.testing.assert_allclose(np.exp(z.astype(np.float64)).sum(1), 1.0, atol=1e-3)
    assert np.isfinite(gpu["scores"].llik).all()
