"""The port's CUDA kernels (K1, K2, K3, K4) against their plain torch
versions on the card, and the `senna topic` and `fit_bge` slices on the
card against the same slices on the CPU.

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
from legume_tpu_torch.embedding.nce import NceConfig, fit_bge
from legume_tpu_torch.ops import kernels
from legume_tpu_torch.ops import random_projection as rp
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


def _shuffle_cells(blk, rng):
    """The same block with the entries of each cell in a random order."""
    rows, vals = blk.row_ids.copy(), blk.vals.copy()
    for c in range(blk.ncols):
        lb, ub = blk.col_ptr[c], blk.col_ptr[c + 1]
        perm = lb + rng.permutation(ub - lb)
        rows[lb:ub], vals[lb:ub] = rows[perm], vals[perm]
    return rows, vals


def _check_project(dev, basis, rows, ptr, vals, normed):
    """Kernel against the plain version, launched twice: bit-equal runs."""
    b, r, p, v = _to(dev, basis, rows, ptr, vals)
    name = "project_normed" if normed else "project_raw"
    before = kernels.launch_counts[name]
    got = kernels.project(b, r, p, v, normed=normed)
    again = kernels.project(b, r, p, v, normed=normed)
    want = kernels.project_plain(b, r, p, v, normed=normed)
    torch.cuda.synchronize()
    assert kernels.launch_counts[name] == before + 2
    rtol = 2e-4 if normed else 1e-4
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("k", [7, 32, 50, 128, 200])
@pytest.mark.parametrize("normed", [True, False])
def test_project_kernel_matches_plain(dev, k, normed):
    """Genes that fit one shared-memory tile; widths below, at and past
    one 16-column slice, up to K = 200."""
    blk, rng = _block(500, 300, 0.2, k)
    basis = rng.standard_normal((500, k)).astype(np.float32)
    got = _check_project(dev, basis, blk.row_ids, blk.col_ptr, blk.vals, normed)
    assert float(got[3].abs().max()) == 0.0  # the empty cell


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("normed", [True, False])
def test_project_kernel_tiles_the_genes(dev, normed, shuffled):
    """5,000 genes: the basis slice overflows shared memory, so the kernel
    walks double-buffered gene tiles; with each cell's entries shuffled
    it rescans the cell in every tile."""
    d = 5000
    blk, rng = _block(d, 300, 0.05, 11)
    assert kernels.project_plan(blk.ncols, d, 50).gene_tiles > 1
    rows, vals = _shuffle_cells(blk, rng) if shuffled else (blk.row_ids, blk.vals)
    basis = rng.standard_normal((d, 50)).astype(np.float32)
    got = _check_project(dev, basis, rows, blk.col_ptr, vals, normed)
    assert float(got[3].abs().max()) == 0.0  # the empty cell


def test_project_kernel_takes_any_width_at_4_byte_alignment(dev):
    """K = 129 (no longer capped), and a basis view that starts off a
    16-byte boundary, which takes the 4-byte staging copies."""
    blk, rng = _block(300, 260, 0.2, 5)
    wide = rng.standard_normal((300, 129)).astype(np.float32)
    _check_project(dev, wide, blk.row_ids, blk.col_ptr, blk.vals, True)
    flat = torch.randn(300 * 64 + 1, device=dev)
    basis = flat[1:].view(300, 64)  # contiguous, 4 bytes past an aligned start
    r, p, v = _to(dev, blk.row_ids, blk.col_ptr, blk.vals)
    got = kernels.project(basis, r, p, v, normed=False)
    want = kernels.project_plain(basis, r, p, v, normed=False)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _check_collapse(dev, rows, ptr, vals, seg, num_genes, num_groups):
    """Kernel against the plain version (atol = rtol = 1e-5), launched
    twice for bit-equal runs, then accumulated into a resident plane. The
    values are scaled off the integers: float sums of whole numbers come
    out the same in any order, and would not test the order."""
    vals = (vals * np.linspace(0.3, 1.7, len(vals))).astype(np.float32)
    r, p, v, s = _to(dev, rows, ptr, vals, seg)
    kw = dict(num_genes=num_genes, num_groups=num_groups)
    before = kernels.launch_counts["collapse"]
    got = kernels.collapse(r, p, v, s, **kw)
    again = kernels.collapse(r, p, v, s, **kw)
    want = kernels.collapse_plain(r, p, v, s, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["collapse"] == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    plane = want.clone()
    kernels.collapse(r, p, v, s, out=plane, **kw)
    torch.testing.assert_close(plane, 2 * want, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("num_groups", [1, 2, 7, 130, 1024])
def test_collapse_kernel_matches_plain(dev, num_groups):
    """From one group (8 warps split its cells, many chunks) to 1,024 (a
    warp per group, one chunk); cells with seg >= S are dropped."""
    blk, rng = _block(400, 3000, 0.05, num_groups)
    seg = rng.integers(0, num_groups + 2, blk.ncols).astype(np.int32)  # >= S drops the cell
    _check_collapse(dev, blk.row_ids, blk.col_ptr, blk.vals, seg, 400, num_groups)


@pytest.mark.parametrize("num_groups", [2, 130])
def test_collapse_kernel_with_shuffled_and_repeated_genes(dev, num_groups):
    """Each cell's entries shuffled; then one gene repeated inside a run of
    32 entries, which the kernel adds lane by lane."""
    blk, rng = _block(300, 400, 0.3, 3)
    seg = rng.integers(0, num_groups + 1, blk.ncols).astype(np.int32)
    seg[0] = 0  # cell 0 is kept
    rows, vals = _shuffle_cells(blk, rng)
    _check_collapse(dev, rows, blk.col_ptr, vals, seg, 300, num_groups)
    rep = rows.copy()
    lb = blk.col_ptr[0]
    assert blk.col_ptr[1] - lb >= 8
    rep[lb + 1:lb + 5] = rep[lb]  # a gene four times more in cell 0
    _check_collapse(dev, rep, blk.col_ptr, vals, seg, 300, num_groups)


@pytest.mark.parametrize("num_groups", [3, 20])
def test_collapse_kernel_tiles_a_long_gene_column(dev, num_groups):
    """60,000 genes: a column past shared memory, cut into gene tiles."""
    d = 60_000
    rng = np.random.default_rng(7)
    dense = sp.random(d, 40, density=0.02, format="csc", random_state=8, dtype=np.float32)
    blk = csc_to_coo_block(dense)
    assert kernels.collapse_plan(blk.ncols, d, num_groups).gene_tiles > 1
    seg = rng.integers(0, num_groups + 1, blk.ncols).astype(np.int32)
    _check_collapse(dev, blk.row_ids, blk.col_ptr, blk.vals, seg, d, num_groups)


def test_collapse_kernel_past_the_shared_counters(dev):
    """13,000 groups: more than the counting sort keeps in shared memory,
    so its counters and cursors live in device memory."""
    blk, rng = _block(60, 5000, 0.1, 13)
    seg = rng.integers(0, 13_000, blk.ncols).astype(np.int32)
    seg[:50] = 7  # one group of many items
    assert kernels.collapse_plan(blk.ncols, 60, 13_000).cap > 0
    _check_collapse(dev, blk.row_ids, blk.col_ptr, blk.vals, seg, 60, 13_000)


@pytest.mark.parametrize("num_groups", [2, 300])
def test_collapse_kernel_on_unaligned_views(dev, num_groups):
    """Entry arrays that start 4 bytes past a 16-byte boundary take the
    scalar loads; the sums are the same."""
    blk, rng = _block(200, 500, 0.2, 21)
    seg = rng.integers(0, num_groups, blk.ncols).astype(np.int32)
    r, p, v, sg = _to(dev, np.append(0, blk.row_ids).astype(np.int32), blk.col_ptr,
                      np.append(0, blk.vals).astype(np.float32), seg)
    kw = dict(num_genes=200, num_groups=num_groups)
    got = kernels.collapse(r[1:], p, v[1:], sg, **kw)
    want = kernels.collapse_plain(r[1:], p, v[1:], sg, **kw)
    torch.cuda.synchronize()
    assert r[1:].data_ptr() % 16 != 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_project_columns_past_128_on_the_card_matches_the_cpu(dev):
    """`project_columns` at 150 columns (`--proj-dim 150`) through K1 on
    the card against the CPU run; one K1 launch per block."""
    vec = _small_vec()
    kernels.reset_launch_counts()
    gb, gp = rp.project_columns(vec, 150, block_size=256, device=dev)
    assert kernels.launch_counts["project_normed"] == -(-vec.num_columns // 256)
    cb, cp = rp.project_columns(vec, 150, block_size=256, device="cpu")
    np.testing.assert_array_equal(gb, cb)
    assert gp.shape == (150, vec.num_columns) and np.isfinite(gp).all()
    np.testing.assert_allclose(gp, cp, rtol=2e-4, atol=2e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    blk, rng = _block(50, 20, 0.3, 0)
    rows, ptr, vals = _to(dev, blk.row_ids, blk.col_ptr, blk.vals)
    basis = torch.randn(50, 16, device=dev)
    with pytest.raises(TypeError):
        kernels.project(basis, rows.long(), ptr, vals, normed=True)
    assert kernels.project(torch.randn(50, 129, device=dev), rows, ptr, vals,
                           normed=True).shape == (20, 129)  # any width
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


def _nce_inputs(dev, p, d, h, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    counts = torch.poisson(torch.full((p, d), 1.5), generator=g)
    q = counts.sum(0) ** 0.75
    q = q / q.sum()
    t = [counts.to(dtype), q, 0.1 * torch.randn(d, h, generator=g),
         0.01 * torch.randn(d, generator=g), 0.1 * torch.randn(p, h, generator=g),
         0.01 * torch.randn(p, generator=g), counts.sum(1)]
    return [x.to(dev).contiguous() for x in t]


def _check_nce(got, want):
    """Loss within a relative 2e-5, gradients normwise within 1e-4 (the
    tolerances of tests/test_nce_pallas.py)."""
    assert abs(float(got[0]) - float(want[0])) <= 2e-5 * abs(float(want[0]))
    for g_, w in zip(got[1:], want[1:]):
        if w is None:
            assert g_ is None
            continue
        assert g_.shape == w.shape and bool(torch.isfinite(g_).all())
        assert float((g_ - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 8, 16, 17, 128])
@pytest.mark.parametrize("p,d", [(1, 200), (37, 200), (300, 1000), (37, 1001), (300, 1001)])
def test_nce_epoch_kernel_matches_plain(dev, p, d, h, dtype):
    """One row and P that divides no band; D that divides no gene tile,
    and D = 1,001, whose rows start off a 16-byte boundary (the count
    tiles' 4-byte path); H off the multiple of 8 the products step in."""
    args = _nce_inputs(dev, p, d, h, dtype)
    before = kernels.launch_counts["nce_epoch"]
    got = kernels.nce_epoch(*args, 5.0)
    want = kernels.nce_epoch_plain(*args, 5.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nce_epoch"] == before + 1
    _check_nce(got, want)
    again = kernels.nce_epoch(*args, 5.0)  # deterministic: no atomics
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 16, 17, 128])
@pytest.mark.parametrize("p,d", [(37, 1001), (2048, 2000)])
def test_nce_epoch_axis_form_matches_plain(dev, p, d, h, dtype):
    """The phase-2 form (`need_feat=False`): no feature-side gradients,
    the rest as the full form computes it, bit-equal on a second launch."""
    args = _nce_inputs(dev, p, d, h, dtype)
    before = dict(kernels.launch_counts)
    got = kernels.nce_epoch(*args, 5.0, need_feat=False)
    want = kernels.nce_epoch_plain(*args, 5.0, need_feat=False)
    full = kernels.nce_epoch(*args, 5.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nce_epoch"] == before["nce_epoch"] + 2
    assert kernels.launch_counts["nce_epoch_axis"] == before["nce_epoch_axis"] + 1
    _check_nce(got, want)
    assert got[1] is None and got[2] is None
    again = kernels.nce_epoch(*args, 5.0, need_feat=False)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    # the same sums as the full form's, up to the compiler's contractions
    torch.testing.assert_close(got[0], full[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[3], full[3], rtol=1e-5, atol=1e-5 * float(full[3].abs().max()))


def test_nce_epoch_kernel_at_a_trained_pseudobulk_state(dev):
    """Pseudobulk counts in the thousands at a trained state, where g_s
    cancels: the bias gradients sum large terms to small totals, and even
    the plain version in f32 lies well off the float64 sums there. The
    kernel, held against float64, errs by at most twice the plain f32
    version's error on each output (and 1e-5 normwise when that is less)."""
    sim = simulate_topic(rows=2000, cols=20_000, factors=8, batches=1, seed=5)
    x = sim.counts.tocsc()
    pb = np.stack([np.asarray(x[:, i::64].sum(1)).ravel() for i in range(64)]).astype(np.float32)
    assert pb.max() > 1000
    fit = fit_bge([pb], config=NceConfig(embedding_dim=16, epochs=300, seed=1), device=dev)
    c = torch.from_numpy(pb).to(dev)
    q = c.sum(0) ** 0.75
    args = [c, q / q.sum()] + [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (
        fit.e_feat, fit.b_feat, fit.pb_embeddings[0], fit.pb_biases[0])] + [c.sum(1)]
    got = kernels.nce_epoch(*args, 5.0)
    plain = kernels.nce_epoch_plain(*args, 5.0)
    exact = kernels.nce_epoch_plain(*(a.double() for a in args), 5.0)
    torch.cuda.synchronize()
    for k, p_, w in zip(got, plain, exact):
        scale = float(w.abs().max())
        err_k = float((k.double() - w).abs().max()) / scale
        err_p = float((p_.double() - w).abs().max()) / scale
        assert err_k <= max(2 * err_p, 1e-5), (err_k, err_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nce_epoch_kernel_on_an_unaligned_plane(dev, dtype):
    """A count plane that starts off a 16-byte boundary (D = 256 would
    take the 16-byte copies) is staged with plain loads; same results."""
    args = _nce_inputs(dev, 70, 256, 16, dtype)
    flat = torch.zeros(70 * 256 + 1, dtype=dtype, device=dev)
    flat[1:] = args[0].reshape(-1)
    c = flat[1:].view(70, 256)
    assert c.data_ptr() % 16 != 0
    got = kernels.nce_epoch(c, *args[1:], 5.0)
    want = kernels.nce_epoch_plain(*args, 5.0)
    torch.cuda.synchronize()
    _check_nce(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,d", [(2627, 34008), (2048, 2000)])
def test_nce_plan_ctas_fit_side_by_side(dev, p, d, dtype):
    """At H = 16 the plan's CTAs fit three to an SM (registers and shared
    memory), as `nce_plan` assumes, in both forms."""
    plan = kernels.nce_plan(p, d, 16)
    for need_feat in (True, False):
        assert kernels.nce_ctas_per_sm(16, plan.range_tiles, dtype, need_feat) >= 3


def test_nce_epoch_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = _nce_inputs(dev, 20, 50, 16, torch.float32)
    with pytest.raises(TypeError):
        kernels.nce_epoch(args[0].half(), *args[1:], 5.0)
    with pytest.raises(TypeError):
        kernels.nce_epoch(args[0], args[1].double(), *args[2:], 5.0)
    with pytest.raises(ValueError):
        kernels.nce_epoch(args[0], args[1][:-1].contiguous(), *args[2:], 5.0)
    with pytest.raises(ValueError):
        kernels.nce_epoch(args[0].T.contiguous().T, *args[1:], 5.0)
    wide = _nce_inputs(dev, 20, 50, 129, torch.float32)
    with pytest.raises(ValueError):
        kernels.nce_epoch(*wide, 5.0)
    with pytest.raises(ValueError):
        kernels.nce_epoch(args[0], args[1].cpu(), *args[2:], 5.0)


def test_fit_bge_on_the_card_matches_the_cpu(dev):
    """Phase 1 through K4 on the card against the plain version on the
    CPU, at the bar of tests/test_nce_pallas.py (embeddings atol 2e-4,
    losses rtol 1e-4); phase 2 on a 600-cell backend likewise."""
    vec = _small_vec()
    x = vec.read_columns_csc(np.arange(vec.num_columns))
    pb = np.stack([np.asarray(x[:, i::23].sum(1)).ravel() for i in range(23)]).astype(np.float32)
    cfg = NceConfig(embedding_dim=6, epochs=40, learning_rate=0.05, seed=3, cell_batch=256,
                    phase2_epochs=20)
    kernels.reset_launch_counts()
    gpu = fit_bge([pb], data=vec, config=cfg, device=dev)
    assert kernels.launch_counts["nce_epoch"] == 40 + 3 * 20
    assert kernels.launch_counts["nce_epoch_axis"] == 3 * 20  # phase 2 takes the axis form
    cpu = fit_bge([pb], data=vec, config=cfg, device="cpu")
    np.testing.assert_allclose(gpu.e_feat, cpu.e_feat, atol=2e-4)
    np.testing.assert_allclose(gpu.pb_embeddings[0], cpu.pb_embeddings[0], atol=2e-4)
    np.testing.assert_allclose(gpu.phase1_losses, cpu.phase1_losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gpu.e_cell, cpu.e_cell, atol=2e-4)
    np.testing.assert_allclose(gpu.phase2_losses, cpu.phase2_losses, rtol=1e-4)


def _same_partition(a, b) -> bool:
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def test_predict_on_the_card_matches_the_cpu(dev, tmp_path):
    """A port-fitted model, held-out cells with a per-batch null,
    iterated delta, refinement and the residual matrix: card against CPU
    (latent 1e-4, delta and residual 1e-5)."""
    from legume_tpu_torch.senna import predict as tpred

    vec = _small_vec()
    model = str(tmp_path / "m")
    ttopic.fit_topic_model(ttopic.TopicArgs(out=model, n_latent_topics=4, encoder_layers=(32, 16),
                                            epochs=3, block_size=256), vec=vec, device="cpu")
    bfile = tmp_path / "b.txt"
    bfile.write_text("\n".join(f"b{i % 3}" for i in range(vec.num_columns)) + "\n")
    out = {}
    for name, device in (("gpu", dev), ("cpu", "cpu")):
        args = tpred.PredictArgs(model=model, out=str(tmp_path / name), block_size=128,
                                 batch_files=[str(bfile)], refine_steps=10, delta_iters=2)
        z = tpred.predict_model(args, vec=vec, device=device)
        _, _, genes = ttopic.load_model(model)
        remap = tpred.build_gene_remap(genes, vec.row_names())
        log_dict = tpred._load_log_dictionary(model, genes)
        delta = tpred._model_table(str(tmp_path / name), "delta")
        delta = np.stack([delta[f"batch{b}"] for b in range(3)], 1)
        res = tpred.residual_csc(vec, z, log_dict, remap, delta_db=delta,
                                 cell_batch=np.arange(vec.num_columns) % 3, device=device)
        out[name] = (z, delta, res)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["gpu"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)
    rg, rc = out["gpu"][2], out["cpu"][2]
    np.testing.assert_array_equal(rg.indices, rc.indices)
    np.testing.assert_allclose(rg.data, rc.data, rtol=1e-5, atol=1e-5)


def test_kmeans_and_hsblock_on_the_card_match_the_cpu(dev):
    from legume_tpu_torch.ops.hsblock import hsblock_clustering
    from legume_tpu_torch.ops.kmeans import kmeans
    from legume_tpu_torch.ops.leiden import knn_adjacency

    rng = np.random.default_rng(0)
    centres = rng.normal(0.0, 10.0, (6, 5))
    x = (centres[rng.integers(0, 6, 3000)] + rng.normal(0.0, 1.0, (3000, 5))).astype(np.float32)
    gc, gl = kmeans(x, 6, seed=2, device=dev)
    cc, cl = kmeans(x, 6, seed=2, device="cpu")
    np.testing.assert_array_equal(gl, cl)
    np.testing.assert_allclose(gc, cc, rtol=1e-5, atol=1e-5)
    adj = knn_adjacency(x, k=10, device="cpu")
    g = hsblock_clustering(adj, max_depth=4, seed=3, device=dev)
    c = hsblock_clustering(adj, max_depth=4, seed=3, device="cpu")
    assert _same_partition(g.membership, c.membership)


def test_bhc_sums_launch_k3_and_match_collapse_plain(dev):
    from legume_tpu_torch.senna.clustering import cluster_sums

    vec = _small_vec()
    labels = np.random.default_rng(1).integers(-1, 7, vec.num_columns)
    kernels.reset_launch_counts()
    got = cluster_sums(vec, labels, 7, block_size=256, device=dev)
    assert kernels.launch_counts["collapse"] == -(-vec.num_columns // 256)
    want = cluster_sums(vec, labels, 7, block_size=256, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _simplex_cells(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.dirichlet(np.full(6, 0.3), 5)
    return (c[rng.integers(0, 5, n)] * 0.8 + rng.dirichlet(np.ones(6), n) * 0.2).astype(np.float32)


def test_umap_on_the_card_matches_the_cpu_and_reruns_bit_equal(dev):
    from legume_tpu_torch.ops import umap

    x = _simplex_cells(600)
    src, dst, w = umap.fuzzy_edges(x, 15, device="cpu")
    u, s, _ = np.linalg.svd(x - x.mean(0), full_matrices=False)
    emb0 = umap.init_2d_from_scores(u[:, :2] * s[:2], 0)
    a, b = umap._fit_ab(0.1, 1.0)
    kw = dict(n_steps=50, batch=1024, n_points=len(x), a=a, b=b)
    probs = w / w.sum()
    card = umap._umap_sgd(0, emb0, src, dst, probs, device=dev, **kw)
    again = umap._umap_sgd(0, emb0, src, dst, probs, device=dev, **kw)
    cpu = umap._umap_sgd(0, emb0, src, dst, probs, device="cpu", **kw)
    np.testing.assert_array_equal(card, again)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-3)
    e_card, n_card = umap.sgd_draws(3, probs, n_steps=7, batch=100, n_points=600, device=dev)
    e_cpu, n_cpu = umap.sgd_draws(3, probs, n_steps=7, batch=100, n_points=600, device="cpu")
    assert torch.equal(e_card.cpu(), e_cpu) and torch.equal(n_card.cpu(), n_cpu)


def test_tsne_and_phate_on_the_card_match_the_cpu(dev):
    from legume_tpu_torch.ops import layouts

    x = _simplex_cells(500, seed=1)
    np.testing.assert_allclose(layouts.tsne(x, n_iter=50, device=dev),
                               layouts.tsne(x, n_iter=50, device="cpu"), rtol=0, atol=1e-3)
    pd_card, y0 = layouts.phate_init(x, knn=15, device=dev)
    pd_cpu, y0_cpu = layouts.phate_init(x, knn=15, device="cpu")
    np.testing.assert_array_equal(pd_card, pd_cpu)
    np.testing.assert_array_equal(y0, y0_cpu)
    np.testing.assert_allclose(layouts.phate_refine(pd_card, y0, n_iter=200, device=dev),
                               layouts.phate_refine(pd_card, y0, n_iter=200, device="cpu"),
                               rtol=0, atol=1e-3)


def test_pseudotime_on_the_card_matches_the_cpu(dev):
    from legume_tpu_torch.embedding.lineage import velocity_oriented_lineage
    from legume_tpu_torch.ops import principal_graph as pg

    x = _simplex_cells(2000, seed=2)
    g = pg.pseudotime(x, n_nodes=30, root_cell=0, device=dev)
    c = pg.pseudotime(x, n_nodes=30, root_cell=0, device="cpu")
    np.testing.assert_allclose(g.nodes, c.nodes, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g.edges, c.edges)
    np.testing.assert_array_equal(g.cell_to_node, c.cell_to_node)
    np.testing.assert_array_equal(g.branch, c.branch)
    assert g.root == c.root
    edges, _ = pg.edge_list_from_adjacency(c.nodes, c.edges)
    ge, gt = pg.project_cells_to_edges(x, c.nodes, edges, device=dev)
    ce, ct = pg.project_cells_to_edges(x, c.nodes, edges, device="cpu")
    np.testing.assert_array_equal(ge, ce)
    np.testing.assert_allclose(gt, ct, rtol=0, atol=1e-5)
    vel = np.roll(x, -1, axis=0) - x
    lg = velocity_oriented_lineage(x, vel, n_nodes=12, device=dev)
    lc = velocity_oriented_lineage(x, vel, n_nodes=12, device="cpu")
    assert lg.root_node == lc.root_node
    np.testing.assert_allclose(lg.pseudotime, lc.pseudotime, rtol=0, atol=1e-5)


def _decoder_forward_and_grads(name, x, log_z, fw, device, dtype=torch.float32):
    """llik [N] and the gradients of sum(llik) (parameters and log z) of a
    seeded decoder of family `name` on `device`, as float64 on the CPU."""
    from legume_tpu_torch.models.decoders import DECODERS

    kw = dict(rho_prior_weight=10.0) if name == "nb-mixture" else {}
    dec = DECODERS[name](x.shape[1], log_z.shape[1], generator=torch.Generator().manual_seed(4), **kw)
    with torch.no_grad():  # nuisance parameters off their constant inits
        g = torch.Generator().manual_seed(5)
        for pname, p in dec.named_parameters():
            if pname != "dictionary":
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    dec = dec.to(device, dtype)
    t = lambda a: torch.from_numpy(a).to(device, dtype)  # noqa: E731
    lz = t(log_z).requires_grad_(True)
    _, llik = dec(lz, t(x), t(fw)[None, :])
    llik.sum().backward()
    out = {n: p.grad for n, p in dec.named_parameters()}
    out["log_z"], out["llik"] = lz.grad, llik.detach()
    return {k: v.cpu().double() for k, v in out.items()}


@pytest.mark.parametrize("name", ["multinomial", "poisson", "nb-mixture"])
def test_decoder_families_on_the_card_match_the_cpu(dev, name):
    """Forward llik and every gradient (nb-mixture with its rho prior on),
    each normwise against the same computation in float64: the card within
    a relative 1e-5, or within twice the CPU's float32 distance where that
    is larger (the log_phi gradient sums 512 cells' terms of either sign,
    and float32 alone puts the CPU 8.8e-6 from float64 there)."""
    rng = np.random.default_rng(1)
    x = rng.poisson(2.0, (512, 300)).astype(np.float32)
    log_z = np.log(rng.dirichlet(np.ones(6), 512)).astype(np.float32)
    fw = rng.uniform(0.2, 1.0, 300).astype(np.float32)
    card = _decoder_forward_and_grads(name, x, log_z, fw, dev)
    cpu = _decoder_forward_and_grads(name, x, log_z, fw, "cpu")
    exact = _decoder_forward_and_grads(name, x, log_z, fw, "cpu", torch.float64)
    assert set(card) == set(cpu) == set(exact)
    for k, ref in exact.items():
        scale = float(ref.abs().max())
        err_card, err_cpu = (float((v[k] - ref).abs().max()) / scale for v in (card, cpu))
        assert err_card <= max(1e-5, 2.0 * err_cpu), (k, err_card, err_cpu)


def test_cell_qc_on_the_card_matches_the_cpu(dev):
    from legume_tpu_torch.data.qc import compute_cell_qc, feature_cells_kept

    sim = simulate_topic(rows=200, cols=600, factors=4, batches=2, seed=17)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, [f"MT-{g}" if i < 7 else g
                                        for i, g in enumerate(sim.row_names)], sim.col_names))
    gpu = compute_cell_qc(vec, block_size=256, ribo_pattern="^g1", with_feature_cells=True,
                          device=dev)
    cpu = compute_cell_qc(vec, block_size=256, ribo_pattern="^g1", with_feature_cells=True,
                          device="cpu")
    for field in ("total", "n_genes", "mito_frac", "ribo_frac", "feature_cells"):
        np.testing.assert_array_equal(getattr(gpu, field), getattr(cpu, field), err_msg=field)
    assert gpu.mito_frac.max() > 0
    keep = gpu.keep_mask(min_total=1000.0, max_mito_frac=float(np.quantile(gpu.mito_frac, 0.9)))
    np.testing.assert_array_equal(feature_cells_kept(vec, keep, block_size=256, device=dev),
                                  feature_cells_kept(vec, keep, block_size=256, device="cpu"))


def test_topic_options_on_the_card_match_the_cpu(dev, tmp_path):
    """`--qc`, `--max-coarse-features` and `--decoder a,b` on the card and
    the CPU: the same cells kept, partitions equal, coarse groups equal as
    a set partition, the artifacts written; then `--from` on the card
    reproduces the partition without sorting, and `--init-from` runs."""
    from legume_tpu_torch.utils.output import table_path

    sim = simulate_topic(rows=200, cols=600, factors=4, batches=2, seed=17)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, [f"MT-{g}" if i < 7 else g
                                        for i, g in enumerate(sim.row_names)], sim.col_names))
    vec.register_batches(sim.batch.astype(str))
    common = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=3, block_size=256,
                  decoder="nb-mixture,multinomial", decoder_weights=[1.0, 0.5],
                  rho_prior_weight=10.0, max_coarse_features=100, qc=True, qc_max_mito_frac=0.05)
    kernels.reset_launch_counts()
    gpu = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "gpu"), **common),
                                 vec=vec, device=dev)
    launches = dict(kernels.launch_counts)
    cpu = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "cpu"), **common),
                                 vec=vec, device="cpu")
    assert launches["project_normed"] > 0 and launches["collapse"] > 0
    assert len(gpu["latent"]) == len(cpu["latent"]) < 600
    for g, c in zip(gpu["levels"].groups_per_level, cpu["levels"].groups_per_level, strict=True):
        np.testing.assert_array_equal(g, c)
    for g, c in zip(gpu["coarsenings"], cpu["coarsenings"], strict=True):
        assert _same_partition(g.fine_to_coarse, c.fine_to_coarse)
    for stem in ("nb-mixture.dictionary", "multinomial.dictionary", "nb-mixture.alpha",
                 "nb-mixture.rho", "nb-mixture.dispersion", "qc"):
        assert table_path(str(tmp_path / f"gpu.{stem}")) is not None, stem
    z = gpu["latent"]
    assert np.isfinite(z).all() and np.isfinite(gpu["scores"].llik).all()
    np.testing.assert_allclose(np.exp(z.astype(np.float64)).sum(1), 1.0, atol=1e-3)

    base = dict(n_latent_topics=4, encoder_layers=(32, 16), epochs=2, block_size=256)
    first = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "nb"), **base), vec=vec,
                                   device=dev)
    kernels.reset_launch_counts()
    again = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "poisson"),
                                                    decoder="poisson", from_run=str(tmp_path / "nb"),
                                                    **base), vec=vec, device=dev)
    assert kernels.launch_counts["project_normed"] > 0 and kernels.launch_counts["collapse"] > 0
    assert "sort_refine_s" not in again["timings"]
    for a, b in zip(first["levels"].level_maps, again["levels"].level_maps, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(first["levels"].groups_per_level[0],
                                  again["levels"].groups_per_level[0])
    warm = ttopic.fit_topic_model(ttopic.TopicArgs(out=str(tmp_path / "warm"),
                                                   init_from=str(tmp_path / "nb"), **base),
                                  vec=vec, device=dev)
    assert np.isfinite(warm["latent"]).all()


def test_ess_step_on_card_matches_cpu(dev):
    from legume_tpu_torch.ops import mcmc
    from legume_tpu_torch.utils import prng

    rng = np.random.default_rng(3)
    cur, nu, mu = (rng.normal(size=(500, 4)).astype(np.float32) for _ in range(3))

    def run(device):
        m = torch.from_numpy(mu).to(device)
        lnpdf = lambda s, i: -0.5 * ((s - (m if i is None else m[i])) ** 2 * 4.0).sum(1)  # noqa: E731
        c = torch.from_numpy(cur).to(device)
        out, ln = mcmc.elliptical_slice_step_batched(prng.key(3), c, torch.from_numpy(nu).to(device),
                                                     lnpdf, lnpdf(c, None))
        return out.cpu().numpy(), ln.cpu().numpy()

    (g, gl), (c, cl) = run(dev), run("cpu")
    np.testing.assert_allclose(g, c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=1e-4)


def test_rest_fit_on_card_matches_cpu(dev):
    from legume_tpu_torch.embedding.resolve import rest_fit

    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.full(5, 0.5), 400).astype(np.float32)
    y = rng.poisson(20 * (theta @ rng.gamma(1.0, 1.0, (90, 5)).T) / 5).astype(np.float32)
    be = MemoryBackend(sp.csc_matrix(y.T))
    g = rest_fit(theta, be, epochs=200, seed=3, device=dev)
    c = rest_fit(theta, be, epochs=200, seed=3, device="cpu")
    np.testing.assert_allclose(g["losses"], c["losses"], rtol=1e-4)
    for name in ("cell_embedding", "feature_embedding", "topic_embedding"):
        assert np.abs(g[name] - c[name]).max() <= 1e-3 * np.abs(c[name]).max(), name


def test_cocoa_statistics_on_card_match_cpu(dev):
    from legume_tpu_torch.cocoa import collapse as col
    from legume_tpu_torch.cocoa import stat as cst
    from legume_tpu_torch.cocoa.sim import simulate_one

    sim = simulate_one(n_genes=80, n_indv=12, cells_per_indv=40, n_causal=10,
                       pve_exposure_gene=0.6, depth=4000, seed=3)
    be = MemoryBackend(sim.counts)
    _, proj_kn = rp.project_columns(be, 16, seed=1, device="cpu")
    proj = proj_kn.T.copy()
    cache = col.build_match_cache(proj, sim.cell_indv, 12, knn=5, device="cpu")
    gcache = col.build_match_cache(proj, sim.cell_indv, 12, knn=5, device=dev)
    np.testing.assert_array_equal(gcache.idx, cache.idx)
    n = sim.counts.shape[1]
    z = np.random.default_rng(0).dirichlet([2.0, 1.0], n).astype(np.float32)
    pb = (np.arange(n) % 4).astype(np.int64)
    ex = np.stack([sim.exposure, np.random.default_rng(7).permutation(sim.exposure)])
    kw = dict(cell_block=200)
    for fn, args in ((col.collect_cocoa_stat, (sim.exposure,)), (col.collect_cocoa_stat_multi, (ex,))):
        g = fn(be, z, sim.cell_indv, pb, 4, *args, cache, device=dev, **kw)
        c = fn(be, z, sim.cell_indv, pb, 4, *args, cache, device="cpu", **kw)
        for gs, cs in zip(g if isinstance(g, list) else [g], c if isinstance(c, list) else [c]):
            for name in ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip"):
                a, b = getattr(gs, name), getattr(cs, name)
                assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    pg = cst.estimate_parameters(c[0], n_opt_iter=40, device=dev)
    pc = cst.estimate_parameters(c[0], n_opt_iter=40, device="cpu")
    np.testing.assert_allclose(cst.compute_exposure_contrast(pg, sim.exposure),
                               cst.compute_exposure_contrast(pc, sim.exposure), rtol=0, atol=1e-4)


def test_chunked_loss_matches_dense_on_card(dev):
    from legume_tpu_torch.embedding.nce import (AxisSide, FeatSide, expected_nce_loss,
                                                expected_nce_loss_chunked)

    rng = np.random.default_rng(1)
    p, d, h = 64, 1000, 16
    c = torch.from_numpy(np.pad(rng.poisson(1.0, (p, d)).astype(np.float32), ((0, 0), (0, 24))))
    q = c.sum(0) ** 0.75
    q = q / q.sum()
    m = c.sum(1)
    feat = FeatSide(torch.from_numpy(rng.normal(0, 0.1, (d + 24, h)).astype(np.float32)),
                    torch.from_numpy(rng.normal(0, 0.1, d + 24).astype(np.float32)))
    axis = AxisSide(torch.from_numpy(rng.normal(0, 0.1, (p, h)).astype(np.float32)),
                    torch.zeros(p))

    def grads(fn, device, **kw):
        f = FeatSide(*(t.clone().to(device).requires_grad_(True) for t in feat))
        a = AxisSide(*(t.clone().to(device).requires_grad_(True) for t in axis))
        loss = fn(f, a, c.to(device), q.to(device), m.to(device), k_neg=5.0, ridge=0.01, **kw)
        loss.backward()
        return [loss.item()] + [t.grad.cpu().numpy() for t in (*f, *a)]

    want = grads(expected_nce_loss, "cpu")
    got = grads(expected_nce_loss_chunked, dev, gene_chunk=256)
    assert abs(got[0] - want[0]) <= 2e-5 * abs(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


# ---- slice 10: vae, svd, joint-topic, the masked models ------------------------


def _normwise(got, want) -> float:
    return float((got.cpu() - want).abs().max() / max(float(want.abs().max()), 1e-30))


def test_topk_windows_and_union_on_the_card_equal_the_cpu(dev):
    from legume_tpu_torch.models import indexed as idx

    rng = np.random.default_rng(4)
    counts = sp.csc_matrix((rng.poisson(0.8, (300, 500)) * (rng.random((300, 500)) < 0.5))
                           .astype(np.float32))
    w = np.tile(np.asarray([1.0, 0.5, 0.0], np.float32), 100)
    for weights in (None, w):
        got = idx.build_topk_windows(MemoryBackend(counts), 32, gene_weights=weights,
                                     block_size=128, device=dev)
        want = idx.build_topk_windows(MemoryBackend(counts), 32, gene_weights=weights,
                                      block_size=128, device="cpu")
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.vals, want.vals)
        np.testing.assert_array_equal(got.log_q, want.log_q)
    ids = torch.from_numpy(want.ids[:64])
    for cap in (50, 301):
        np.testing.assert_array_equal(idx.union_ids(ids.to(dev), cap, 300).cpu().numpy(),
                                      idx.union_ids(ids, cap, 300).numpy())


def _forward_and_grads(module, fn, device):
    module = module.to(device)
    module.zero_grad()
    out = fn(module, device)
    out.sum().backward()
    return out.detach().cpu(), {n: p.grad.detach().cpu().clone()
                                for n, p in module.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("which", ["vae", "joint_delta", "masked_simplex", "masked_gaussian",
                                   "masked_sbp"])
def test_new_models_forward_and_grads_card_vs_cpu(dev, which):
    import copy

    from legume_tpu_torch.models import decoders, encoders, indexed

    g = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    if which == "vae":
        x = torch.from_numpy(rng.poisson(2.0, (64, 200)).astype(np.float32))
        module = torch.nn.ModuleList([encoders.GaussianEncoder(200, 8, (32, 16), generator=g),
                                      decoders.GaussianNbDecoder(200, 8, generator=g)])
        eps = torch.randn(64, 8, generator=g)

        def fn(m, d, dt=torch.float32):
            z, kl = m[0](x.to(d, dt), None, train=True, eps=eps.to(d, dt))
            return m[1](z, x.to(d, dt))[1] - kl
    elif which == "joint_delta":
        x = torch.from_numpy(rng.poisson(2.0, (64, 300)).astype(np.float32))
        module = torch.nn.ModuleList([
            encoders.LogSoftmaxJointEncoder((150, 150), 6, (32,), generator=g),
            decoders.DeltaTopicDecoder(150, 6, 2, generator=g)])
        eps = torch.randn(2, 64, 6, generator=g)

        def fn(m, d, dt=torch.float32):
            log_z, kl = m[0](x.to(d, dt), None, train=True, eps=eps.to(d, dt))
            return m[1](log_z, x.to(d, dt))[1] - kl
    else:
        latent = which.split("_")[1]
        n_genes = 300
        ids = torch.from_numpy(np.sort(rng.choice(n_genes + 1, (64, 32)), 1).astype(np.int32))
        vals = torch.from_numpy(rng.poisson(2.0, (64, 32)).astype(np.float32))
        mask = torch.from_numpy(rng.random((64, 32)) < 0.3)
        null = torch.from_numpy(rng.uniform(0.3, 2.0, (64, 32)).astype(np.float32))
        module = indexed.MaskedTopicModel(n_genes, 6, embed_dim=16, hidden=32, latent=latent,
                                          n_gene_modules=4, with_null=True, generator=g)
        union = indexed.union_ids(ids, 400, n_genes)
        lq = torch.from_numpy(rng.normal(-5, 1, 400).astype(np.float32))
        eps = torch.randn(64, 6, generator=g)

        def fn(m, d, dt=torch.float32):
            return m(ids.to(d), vals.to(d, dt), union.to(d), lq.to(d, dt), (union < n_genes).to(d),
                     mask.to(d), train=True, eps=eps.to(d, dt), null_vals=null.to(d, dt))[0]
    want, gw = _forward_and_grads(copy.deepcopy(module), fn, "cpu")
    _, g64 = _forward_and_grads(copy.deepcopy(module).double(),
                                lambda m, d: fn(m, d, torch.float64), "cpu")
    got, gg = _forward_and_grads(module, fn, dev)
    assert _normwise(got, want) <= 1e-5
    for name in gw:
        # within 1e-5 of the CPU's, or else as near float64 as the CPU's
        # float32 gradient is, within a factor 2 (two float32 sums in
        # different orders each lie up to their rounding from float64)
        if _normwise(gg[name], gw[name]) > 1e-5:
            cpu_f64 = _normwise(gw[name].double(), g64[name])
            assert _normwise(gg[name].double(), g64[name]) <= 2 * cpu_f64, name


def _svd_held_errors(got, want, gap=0.05):
    """As `chip_smoke.py::svd_held_errors`: each group of singular values within
    `gap` compared up to its rotation, the last group (whose gap to the
    truncated components is unknown) not held."""
    s = want["singular_values"]
    bounds, j = [], 0
    while j < len(s):
        e = j + 1
        while e < len(s) and s[e - 1] - s[e] <= gap * s[e - 1]:
            e += 1
        bounds.append((j, e))
        j = e
    held, basis_err, f_err = [], 0.0, 0.0
    for a, b in bounds[:-1]:
        rot = got["basis"][:, a:b].T @ want["basis"][:, a:b]
        basis_err = max(basis_err, float(np.abs(got["basis"][:, a:b] @ rot
                                                - want["basis"][:, a:b]).max()))
        f_err = max(f_err, float((np.abs(got["factors"][:, a:b] @ rot - want["factors"][:, a:b])
                                  / np.abs(want["factors"][:, a:b]).max(0)).max()))
        held.extend(range(a, b))
    return held, basis_err, f_err


def _vec(counts, batch=None):
    vec = SparseIoVec()
    vec.push(MemoryBackend(counts))
    if batch is not None:
        vec.register_batches(np.asarray(batch).astype(str))
    return vec


def _masked_eval_loss_f64(a, data) -> float:
    """The held-out eval loss of `run_masked(a)`'s training (the same init,
    keys and windows) in float64 on the CPU."""
    from legume_tpu_torch.models.indexed import (IndexedData, MaskedTopicModel,
                                                 MaskedTrainConfig, masked_keys, train_masked)
    from legume_tpu_torch.utils import prng

    model = MaskedTopicModel(
        data.n_genes, a.n_latent_topics, embed_dim=a.embed_dim, latent=a.latent,
        kl_weight=a.kl_weight, masked_likelihood=a.masked_likelihood,
        n_gene_modules=a.gene_modules,
        generator=prng.generator_from_key(masked_keys(a.seed)[0])).double()
    d64 = IndexedData(ids=data.ids, vals=data.vals.astype(np.float64),
                      log_q=data.log_q.astype(np.float64), n_genes=data.n_genes)
    cfg = MaskedTrainConfig(
        epochs=a.epochs, minibatch=a.minibatch_size, learning_rate=a.learning_rate,
        mask_frac=a.mask_frac, mask_schedule=a.mask_schedule, mask_rate_lo=a.mask_rate_lo,
        mask_rate_hi=a.mask_rate_hi, weight_decay=a.weight_decay, grad_clip=a.grad_clip,
        feature_embedding_l2=a.feature_embedding_l2, eval_mask_frac=a.eval_mask_fraction,
        eval_seed=a.eval_seed, seed=a.seed)
    return float(train_masked(model, d64, cfg, device="cpu")[2])


def test_vae_svd_and_masked_runs_on_the_card_match_the_cpu(dev, tmp_path):
    """vae at 0 epochs (the same CPU-drawn init on both) within 1e-4;
    svd's partition equal, its pseudobulk plane within 1e-5, the rSVD of
    one plane and the per-cell projection with one basis within 1e-4; a
    masked run (JAX's key schedule, drawn alike on both) with its trace
    within 1e-4 and its eval loss within twice the CPU's distance from
    the same training in float64 (1e-4 at the least)."""
    import types

    from legume_tpu_torch.cli.senna_cmds.masked_cmds import run_masked
    from legume_tpu_torch.ops.rsvd import rsvd
    from legume_tpu_torch.senna import svd as tsvd
    from legume_tpu_torch.utils.prng import key_from_seed
    from legume_tpu_torch.senna import vae as tvae

    sim = simulate_topic(rows=300, cols=1500, factors=5, batches=2, seed=7)
    runs = {}
    for d in (dev, "cpu"):
        runs[str(d)] = tvae.fit_vae(tvae.VaeArgs(out=str(tmp_path / f"vae_{d}"), epochs=0,
                                                 n_latent=6, block_size=512),
                                    vec=_vec(sim.counts, sim.batch), device=d)
    np.testing.assert_array_equal(runs["cuda"]["levels"].groups_per_level[0],
                                  runs["cpu"]["levels"].groups_per_level[0])
    np.testing.assert_allclose(runs["cuda"]["latent"], runs["cpu"]["latent"], rtol=0, atol=1e-4)
    # svd stage by stage (`chip_smoke.py::svd_card_vs_cpu`): the plane the
    # basis is fitted on, the rSVD of one plane, the per-cell projection
    svd = {str(d): tsvd.fit_svd(tsvd.SvdArgs(out=str(tmp_path / f"svd_{d}"), block_size=512),
                                vec=_vec(sim.counts, sim.batch), device=d) for d in (dev, "cpu")}
    g, c = svd["cuda"], svd["cpu"]
    np.testing.assert_array_equal(g["levels"].groups_per_level[0], c["levels"].groups_per_level[0])
    assert np.abs(g["pb_dp"] - c["pb_dp"]).max() <= 1e-5 * np.abs(c["pb_dp"]).max()
    x = torch.from_numpy(np.log1p(c["pb_dp"]).astype(np.float32))
    rs = {}
    for d in (dev, "cpu"):
        u, sv, _ = rsvd(x.to(d), 20, key=key_from_seed(tsvd.SvdArgs.seed, 23))
        rs[str(d)] = {"basis": u, "singular_values": sv, "factors": tsvd.project_cells(
            _vec(sim.counts), u, block_size=512, device="cpu")}
    held, basis_err, f_err = _svd_held_errors(rs["cuda"], rs["cpu"])
    assert len(held) >= 5 and basis_err <= 1e-4 and f_err <= 1e-4, (held, basis_err, f_err)
    proj = {str(d): tsvd.project_cells(_vec(sim.counts), c["basis"], block_size=512, device=d)
            for d in (dev, "cpu")}
    np.testing.assert_allclose(proj["cuda"] / np.abs(proj["cpu"]).max(0),
                               proj["cpu"] / np.abs(proj["cpu"]).max(0), rtol=0, atol=1e-4)
    masked = {}
    for d in (dev, "cpu"):
        a = types.SimpleNamespace(
            cmd="masked-topic", data_files=[], out=str(tmp_path / f"m_{d}"), n_latent_topics=6,
            window=32, embed_dim=16, gene_modules=2, epochs=2, minibatch_size=128,
            mask_frac=0.15, mask_schedule="fixed", mask_rate_lo=0.05, mask_rate_hi=0.5,
            masked_likelihood="nb", learning_rate=1e-3, weight_decay=0.01, grad_clip=0.0,
            feature_embedding_l2=0.0, kl_weight=1e-3, eval_mask_fraction=0.1, eval_seed=0,
            data_parallel=False, frozen_features=None, init_feature_embedding=None,
            batch_files=None, adj_method="residual", sort_dim=6, iter_opt=10,
            feature_network=None, seed=0, latent="simplex", device=str(d))
        masked[str(d)] = run_masked(a, vec=_vec(sim.counts))
    np.testing.assert_allclose(masked["cuda"]["trace"], masked["cpu"]["trace"], rtol=1e-4)
    # The eval loss: the card's run is the same in every process (its
    # gathers' backward goes through K3), the CPU's float32 run is not
    # (threaded sums: 29.67752 to 29.67783 over six processes on an H100
    # host's CPU, where the card gave 29.677649 in each), so a 1e-4 bar
    # against the CPU failed at random. Held as the models' gradients are
    # held above: the card within twice the CPU float32 loss's own
    # distance from the same training in float64.
    l64 = _masked_eval_loss_f64(a, masked["cpu"]["data"])
    err_card = abs(masked["cuda"]["eval_loss"] - l64)
    err_cpu = abs(masked["cpu"]["eval_loss"] - l64)
    print(f"masked eval loss: card {err_card:.3g}, cpu {err_cpu:.3g} from float64 {l64:.8f}")
    assert err_card <= max(1e-4, 2.0 * err_cpu), (err_card, err_cpu)


# ---- slice 11: fne's tied K4, deconvolve's archetype K3, the new commands ----


def _sbm_plane(n, modules, seed):
    """fne's plane and marginal for a stochastic-block graph of `n` genes."""
    from legume_tpu_torch.senna.fne import fne_plane

    rng = np.random.default_rng(seed)
    module = np.arange(n) % modules
    src = np.repeat(np.arange(n), 16)
    dst = np.concatenate([rng.integers(0, n // modules, (n, 15)) * modules + module[:, None],
                          rng.integers(0, n, (n, 1))], 1).ravel()
    w = rng.integers(1, 4, len(src)).astype(float)
    edges = [(f"g{a}", f"g{b}", c) for a, b, c in zip(src, dst, w) if a != b]
    return edges, fne_plane(edges, 0.75)


def test_nce_epoch_kernel_with_tied_weights_at_the_fne_plane(dev):
    """fne's epoch at its CLI shape (10,000 genes, d = 32): K4's full form
    with `e_axis = e_feat` and `b_axis = b_feat` against the plain version,
    and the tied gradients against autograd of the fne loss."""
    _, (_, plane, q) = _sbm_plane(10_000, 50, 3)
    g = torch.Generator(device="cpu").manual_seed(1)
    c = torch.from_numpy(plane).to(dev)
    qt = torch.from_numpy(q).to(dev)
    e = (0.1 * torch.randn(len(plane), 32, generator=g)).to(dev)
    b = torch.zeros(len(plane), device=dev)
    m = c.sum(1)
    got = kernels.nce_epoch(c, qt, e, b, e, b, m, 5.0)
    want = kernels.nce_epoch_plain(c, qt, e, b, e, b, m, 5.0)
    torch.cuda.synchronize()
    _check_nce(got, want)
    ev, bv = e.clone().requires_grad_(True), b.clone().requires_grad_(True)
    s = ev @ ev.T + bv[None, :] + bv[:, None]
    ls = torch.nn.functional.logsigmoid
    loss_sum = (c * ls(s)).sum() + (5.0 * m[:, None] * qt[None, :] * ls(-s)).sum()
    loss_sum.backward()
    ge, gb = got[1] + got[3], got[2] + got[4]
    assert float((ge - ev.grad).abs().max()) <= 1e-4 * float(ev.grad.abs().max())
    assert float((gb - bv.grad).abs().max()) <= 1e-4 * float(bv.grad.abs().max())


@pytest.mark.parametrize("num_groups", [50, 200])
def test_collapse_kernel_at_an_archetype_plane(dev, num_groups):
    """deconvolve's per-community sums: a 2,048-cell block over 2,000 genes,
    cells of dropped communities (-1, mapped past the groups) left out."""
    blk, rng = _block(2000, 2048, 0.3, 5)
    memb = rng.integers(-1, num_groups, blk.ncols)
    seg = np.where(memb >= 0, memb, num_groups).astype(np.int32)
    _check_collapse(dev, blk.row_ids, blk.col_ptr, blk.vals, seg, 2000, num_groups)


def test_slice11_commands_on_the_card_match_the_cpu(dev, tmp_path):
    """The Q-matrix equal, fne's embedding within 1e-4 after 50 epochs,
    deconvolve's fractions within 0.03 (two generators' chains) and the
    archetype reference's sums within 1e-5, card against CPU."""
    from legume_tpu_torch.ops.enrichment import geneset_topic_qmatrix
    from legume_tpu_torch.senna.deconvolve import (
        DeconvConfig, build_archetype_reference, deconvolve)
    from legume_tpu_torch.senna.fne import fit_fne

    rng = np.random.default_rng(0)
    genes = [f"g{i}" for i in range(400)]
    log_beta = rng.normal(scale=0.3, size=(5, 400))
    log_beta[0, :30] += 2.0
    sets = {"A": genes[:30], "B": genes[100:140]}
    qs = [geneset_topic_qmatrix(log_beta, genes, sets, n_perm=100, seed=2, device=d)
          for d in (dev, "cpu")]
    for key in ("es", "z", "pvalue", "q"):
        np.testing.assert_array_equal(qs[0][key], qs[1][key])

    edges, _ = _sbm_plane(400, 4, 9)
    fs = [fit_fne(edges, epochs=50, seed=1, device=d) for d in (dev, "cpu")]
    np.testing.assert_allclose(fs[0].embedding, fs[1].embedding, rtol=0, atol=1e-4)

    mu = rng.gamma(0.3, 1.0, (300, 4)) * 5.0
    for k in range(4):
        mu[k * 60 : (k + 1) * 60, k] *= 10.0
    lam = rng.dirichlet(np.ones(4), 4) @ mu.T
    y = rng.poisson(lam / lam.sum(1, keepdims=True) * 50_000).astype(np.float32)
    ds = [deconvolve(y, mu / mu.sum(0), config=DeconvConfig(n_sweeps=400, burn_in=150, seed=1),
                     device=d) for d in (dev, "cpu")]
    np.testing.assert_allclose(ds[0].fractions, ds[1].fractions, rtol=0, atol=0.03)

    sim = simulate_topic(rows=200, cols=3000, factors=4, seed=4)
    emb = (sim.theta + rng.normal(0, 0.02, sim.theta.shape)).astype(np.float32)
    ann = np.asarray([f"t{k}" for k in sim.theta.argmax(1)], dtype=object)
    refs = [build_archetype_reference(MemoryBackend(sim.counts, sim.row_names, sim.col_names),
                                      emb, ann, n_archetypes=12, min_cells=5, device=d)
            for d in (dev, "cpu")]
    np.testing.assert_array_equal(refs[0].membership, refs[1].membership)
    np.testing.assert_allclose(refs[0].mu_gm, refs[1].mu_gm, rtol=1e-5, atol=1e-5)


# ---- slice 12: deterministic masked gradients, data-beans on the card ----------


def _masked_args(out, device, **kw):
    import types

    a = dict(cmd="masked-topic", data_files=[], out=out, n_latent_topics=6, window=32,
             embed_dim=16, gene_modules=2, epochs=3, minibatch_size=128, mask_frac=0.15,
             mask_schedule="fixed", mask_rate_lo=0.05, mask_rate_hi=0.5, masked_likelihood="nb",
             learning_rate=1e-3, weight_decay=0.01, grad_clip=0.0, feature_embedding_l2=0.0,
             kl_weight=1e-3, eval_mask_fraction=0.1, eval_seed=0, data_parallel=False,
             frozen_features=None, init_feature_embedding=None, batch_files=None,
             adj_method="residual", sort_dim=6, iter_opt=10, feature_network=None, seed=0,
             latent="simplex", device=str(device))
    a.update(kw)
    return types.SimpleNamespace(**a)


@pytest.mark.parametrize("latent", ["simplex", "gaussian"])
def test_masked_training_on_the_card_is_bit_equal_across_runs(dev, tmp_path, latent):
    """Two masked runs from one seed on the card: the loss trace, the eval
    loss, the latent and every parameter bit-equal. The gathers by gene id
    take their backward through K3 (launched on every step)."""
    from legume_tpu_torch.cli.senna_cmds.masked_cmds import run_masked

    sim = simulate_topic(rows=400, cols=3000, factors=6, seed=21)
    runs = []
    for i in range(2):
        before = dict(kernels.launch_counts)
        runs.append(run_masked(_masked_args(str(tmp_path / f"m{i}"), dev, latent=latent),
                               vec=_vec(sim.counts)))
        torch.cuda.synchronize()
        # two gathers a step (the encoder's rho, the likelihood's log phi)
        for key in ("collapse", "collapse_gather"):
            assert kernels.launch_counts[key] - before[key] == 2 * 3 * (3000 // 128)
    a, b = runs
    assert a["trace"] == b["trace"] and a["eval_loss"] == b["eval_loss"]
    np.testing.assert_array_equal(a["latent"], b["latent"])
    sa, sb = a["model"].state_dict(), b["model"].state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("width", [64, 0])
def test_masked_gather_backward_on_the_card_matches_indexing(dev, width):
    """`gather_rows` on card tensors, for a rho-like [rows, H] and a
    log-phi-like [rows] table at the masked trainer's minibatch (256 cells
    x a 128-gene window, ids with repeats): the forward equal to
    `table[ids]`, the backward (K3's group sum, one launch) within K3's
    tolerance of plain indexing's (atomic adds) and bit-equal across two
    runs."""
    from legume_tpu_torch.models import indexed as tidx

    g = torch.Generator().manual_seed(5)
    rows = 2001
    table = torch.randn(rows, *((width,) if width else ()), generator=g).to(dev)
    ids = torch.randint(0, rows, (256, 128), generator=g, dtype=torch.int32)
    ids[:, 0] = 7  # one id in every cell
    ids = ids.to(dev)
    w = torch.randn(*ids.shape, *((width,) if width else ()), generator=g).to(dev)
    grads = []
    for _ in range(2):
        a = table.clone().requires_grad_(True)
        before = dict(kernels.launch_counts)
        out = tidx.gather_rows(a, ids)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        assert torch.equal(out.detach(), table[ids.long()])
        for key in ("collapse", "collapse_gather"):
            assert kernels.launch_counts[key] - before[key] == 1
        grads.append(a.grad)
    b = table.clone().requires_grad_(True)
    (b[ids.long()] * w).sum().backward()
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], b.grad, rtol=1e-5, atol=1e-5)


def test_data_beans_qc_on_the_card_matches_the_cpu(dev, tmp_path):
    """`data-beans qc` and `histogram` through the port's CLI on the card
    and on the CPU: statistics within 1e-6, masks equal, the same
    histogram."""
    import contextlib
    import io

    import pandas as pd

    from legume_tpu_torch.cli.beans_cli import run_beans
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    sim = simulate_topic(rows=300, cols=2500, factors=5, seed=12)
    names = [f"MT-{g}" if i < 9 else g for i, g in enumerate(sim.row_names)]
    store = str(tmp_path / "x.zarr")
    create_sparse_from_csc(sim.counts, store, names, sim.col_names)
    tabs, hists = {}, {}
    for d in ("cuda", "cpu"):
        run_beans(["qc", store, "--output", str(tmp_path / d), "--device", d, "--mads", "2.5",
                   "--ribo-pattern", "^g1", "--feature-min-cells", "50", "--report"])
        tabs[d] = (pd.read_parquet(tmp_path / f"{d}.qc.parquet"),
                   pd.read_parquet(tmp_path / f"{d}.qc.features.parquet"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_beans(["histogram", store, "--device", d])
        hists[d] = buf.getvalue()
    (g, gf), (c, cf) = tabs["cuda"], tabs["cpu"]
    for col in ("total", "n_genes", "mito_frac", "ribo_frac"):
        np.testing.assert_allclose(g[col], c[col], rtol=1e-6, atol=0, err_msg=col)
    np.testing.assert_array_equal(g.keep, c.keep)
    assert 0 < g.keep.sum() < len(g)
    assert gf.equals(cf) and hists["cuda"] == hists["cpu"]


def test_streaming_writer_on_the_card_machine_equals_the_in_memory_writer(dev, tmp_path,
                                                                         monkeypatch):
    """The streaming writer's store byte-equal to `create_sparse_from_csc`'s
    on this machine's codec (many small chunks, several slabs)."""
    from legume_tpu_torch.data import sparse_io as S

    sim = simulate_topic(rows=150, cols=900, factors=4, seed=3)
    monkeypatch.setattr(S, "_CHUNK", 4096)
    monkeypatch.setattr(S.StreamingCscWriter, "MAX_CHUNK_NNZ", 5000)
    S.create_sparse_from_csc(sim.counts, str(tmp_path / "mem.zarr"), sim.row_names, sim.col_names)
    w = S.StreamingCscWriter(str(tmp_path / "st.zarr"), 150, row_names=sim.row_names,
                             gene_chunk=17)
    for lb in range(0, 900, 211):
        w.append(sim.counts[:, lb : lb + 211])
    w.finalize(column_names=sim.col_names)
    mem = sorted(p.relative_to(tmp_path / "mem.zarr") for p in (tmp_path / "mem.zarr").rglob("*")
                 if p.is_file())
    st = sorted(p.relative_to(tmp_path / "st.zarr") for p in (tmp_path / "st.zarr").rglob("*")
                if p.is_file())
    assert mem == st and len(mem) > 40
    for f in mem:
        assert (tmp_path / "mem.zarr" / f).read_bytes() == (tmp_path / "st.zarr" / f).read_bytes()


# ---- slice 13: faba's BAM path, faba gem --------------------------------------------


def _gem_pb(seed=0, p=256, d=1500, h=4):
    """Pseudobulk spliced / unspliced counts (the shape `faba gem --raw`
    sums a few thousand cells into), a low-rank state plus a velocity
    shift."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(p, h))
    beta = rng.normal(size=(d, h)) * 0.5
    delta = rng.normal(size=(d, h)) * 0.3 * (rng.random((d, 1)) < 0.4)
    s = rng.poisson(np.exp(z @ beta.T + 1.5)).astype(np.float32)
    u = rng.poisson(np.exp(z @ (beta + delta).T + 0.5)).astype(np.float32)
    return s, u


def test_fit_gem_on_the_card_matches_the_cpu_and_is_bit_equal(dev):
    """The initial parameters equal (host threefry); two card runs
    bit-equal; the card's end state within twice the CPU float32 fit's
    distance from the float64 fit, 1e-5 at the least (gem and the
    encoder)."""
    from legume_tpu_torch.embedding import gem

    s, u = _gem_pb()
    a0 = gem.fit_gem(s, u, epochs=0, device=dev)
    b0 = gem.fit_gem(s, u, epochs=0, device="cpu")
    np.testing.assert_array_equal(a0.e_feat, b0.e_feat)
    np.testing.assert_array_equal(a0.pb_e, b0.pb_e)
    for fit, fields in ((gem.fit_gem, ("e_feat", "delta", "pb_e", "b_feat_s", "b_feat_u", "pb_b")),
                        (gem.fit_gem_encoder, ("rho", "delta", "w1", "b1", "bias_s"))):
        card = fit(s, u, epochs=200, device=dev)
        again = fit(s, u, epochs=200, device=dev)
        cpu = fit(s, u, epochs=200, device="cpu")
        ref = fit(s, u, epochs=200, device="cpu", dtype=torch.float64)
        assert card.losses == again.losses
        for name in fields:
            a, b = getattr(card, name), getattr(again, name)
            np.testing.assert_array_equal(a, b, err_msg=name)
            gap_cpu = float(np.abs(getattr(cpu, name) - getattr(ref, name)).max())
            gap_card = float(np.abs(a - getattr(ref, name)).max())
            assert gap_card <= max(2 * gap_cpu, 1e-5), (fit.__name__, name, gap_card, gap_cpu)


def test_gem_gibbs_on_the_card_matches_the_cpu_over_the_first_sweep(dev):
    from legume_tpu_torch.embedding import gem
    from legume_tpu_torch.embedding.posterior import gem_gibbs

    s, u = _gem_pb(1, p=128, d=400, h=3)
    fit = gem.fit_gem(s, u, embedding_dim=4, epochs=100, device="cpu")
    args = (s, u, fit.e_feat, fit.delta, fit.b_feat_s, fit.b_feat_u, fit.pb_e, fit.pb_b)
    kw = dict(n_sweeps=1, burnin=0, seed=3)
    card, cpu = gem_gibbs(*args, **kw, device=dev), gem_gibbs(*args, **kw, device="cpu")
    np.testing.assert_array_equal(card.beta_pip, cpu.beta_pip)
    np.testing.assert_array_equal(card.delta_pip, cpu.delta_pip)
    for name in ("beta_mean", "delta_mean", "e_pb_mean", "b_pb_mean"):
        np.testing.assert_allclose(getattr(card, name), getattr(cpu, name), rtol=0, atol=1e-5,
                                   err_msg=name)
    many = gem_gibbs(*args, n_sweeps=4, burnin=2, seed=3, device=dev)
    assert np.isfinite(many.rhat).all() and (many.beta_pip <= 1).all()


def test_faba_genes_on_the_card_machine_equals_the_planted_counts(dev, tmp_path):
    """The native BAM reader builds there (g++ at first use) and `faba
    genes` / `--splice` give the planted counts exactly."""
    from legume_tpu_torch.cli.main import run_faba
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix
    from legume_tpu_torch.faba.bam_sim import simulate_10x_bam

    sim = simulate_10x_bam(str(tmp_path / "a.bam"), str(tmp_path / "a.gff"), n_cells=300,
                           n_genes=200, umis_per_cell=80, n_mito=5, seed=2)
    run_faba(["genes", "--bam", str(tmp_path / "a.bam"), "--gff", str(tmp_path / "a.gff"),
              "--output", str(tmp_path / "g"), "--splice"])
    for nm in ("spliced", "unspliced"):
        b = open_sparse_matrix(str(tmp_path / f"g.{nm}"))
        got = b.read_columns_csc(np.arange(b.num_columns))
        assert (got != sim[nm]).nnz == 0 and b.column_names() == sim["barcodes"]


def test_cocoa_diff_cn_score_bit_equal_between_card_runs(dev, tmp_path):
    """Two `cocoa diff` runs with permutations and the CNV side-channel give
    the same cn_score bits: the first builds the match cache, the second
    reuses it, as chip_smoke's phases 15 and 31 run them (the gene moments
    behind the housekeeping weights and the statistics' segment sums take a
    fixed order, `ops/sparse.py::segment_add`)."""
    from legume_tpu_torch.cli.main import run_cocoa
    from legume_tpu_torch.cocoa.sim import simulate_collider

    sim = simulate_collider(n_genes=300, n_types=3, n_indv=12, cells_per_indv=150, seed=15)
    counts = sp.csc_matrix(sim.counts)
    genes, n = [f"g{i}" for i in range(300)], counts.shape[1]
    stem = str(tmp_path / "c")
    write = lambda path, lines: (tmp_path / path).write_text("\n".join(lines) + "\n")  # noqa: E731
    write("c.indv.txt", [f"i{v:04d}" for v in sim.cell_indv])
    write("c.types.txt", [f"t{v}" for v in sim.cell_type])
    write("exposure.tsv", [f"i{i:04d}\t{int(x)}" for i, x in enumerate(sim.exposure)])
    write("truth.tsv", ["gene_idx\tchr\tpos"] + [f"{i}\t{'chr1' if i < 150 else 'chr2'}\t"
                                                 f"{i * 1000 + 500}" for i in range(300)])

    def diff(out):
        vec = SparseIoVec()
        vec.push(MemoryBackend(counts, genes, [f"cell{j}" for j in range(n)]))
        return run_cocoa(["diff", "--data-files", stem, "--out", out, "--indv", f"{stem}.indv.txt",
                          "--exposure", str(tmp_path / "exposure.tsv"), "--topic-assignment",
                          f"{stem}.types.txt", "--permutations", "12", "--cnv-ground-truth",
                          str(tmp_path / "truth.tsv"), "--device", "cuda"], vec=vec)

    a, b = diff(f"{stem}.a"), diff(f"{stem}.b")
    assert b["timings"].get("match_cache_reused")
    np.testing.assert_array_equal(a["cnv"].cn_score, b["cnv"].cn_score)
    np.testing.assert_array_equal(a["cnv"].states, b["cnv"].states)
    np.testing.assert_array_equal(a["effect"], b["effect"])


def test_faba_all_on_the_card_machine_equals_the_ports_run(dev, tmp_path):
    """`python -m legume_tpu_torch faba all` on a small planted pair there
    writes the stores the port's `run_all` writes in this process, and its
    gene and depth stores equal the planted counts (the stages run on the
    host, as in the JAX package)."""
    import subprocess
    import sys
    from pathlib import Path

    from legume_tpu_torch.data.sparse_io import open_sparse_matrix
    from legume_tpu_torch.faba.bam_sim import simulate_edit_pair
    from legume_tpu_torch.faba.pipeline import run_all

    t = simulate_edit_pair(str(tmp_path / "wt.bam"), str(tmp_path / "ct.bam"),
                           str(tmp_path / "g.gff3"), str(tmp_path / "g.fa"), n_cells=80,
                           n_genes=20, umis_per_cell=120, seed=4)
    io = ["--bam", str(tmp_path / "wt.bam"), "--control-bam", str(tmp_path / "ct.bam"), "--gff",
          str(tmp_path / "g.gff3"), "--genome", str(tmp_path / "g.fa")]
    subprocess.run([sys.executable, "-m", "legume_tpu_torch", "faba", "all", *io, "--output",
                    str(tmp_path / "cli"), "--depth-resolution-kb", "1"], check=True,
                   cwd=Path(__file__).resolve().parents[1])
    res = run_all(str(tmp_path / "wt.bam"), str(tmp_path / "g.gff3"), str(tmp_path / "api"),
                  control_bam=str(tmp_path / "ct.bam"), genome=str(tmp_path / "g.fa"),
                  depth_resolution_kb=1.0)
    assert {"genes", "genes.ct", "depth", "depth.ct", "atoi", "m6a", "apa", "snp"} <= set(res.outputs)
    for key, path in res.outputs.items():
        if path.endswith(".zarr"):
            a, b = open_sparse_matrix(path), open_sparse_matrix(path.replace("api", "cli"))
            assert a.row_names() == b.row_names() and a.column_names() == b.column_names(), key
            cols = np.arange(a.num_columns)
            assert (a.read_columns_csc(cols) != b.read_columns_csc(cols)).nnz == 0, key
    for arm, tag in (("wt", ""), ("control", ".ct")):
        g = open_sparse_matrix(str(tmp_path / f"cli{tag}.genes.zarr"))
        got = g.read_columns_csc(np.arange(g.num_columns))
        assert (got != t[arm]["genes"]).nnz == 0 and g.column_names() == t[arm]["barcodes"]


def _spatial_cells(n=3000, d=120, domains=4, seed=3):
    """Planted domains (vertical stripes) at tissue-scale coordinates (µm,
    millimetres from the origin), Poisson counts over domain programs."""
    rng = np.random.default_rng(seed)
    coords = np.array([4000.0, 6000.0]) + rng.uniform(0.0, 1500.0, (n, 2))
    domain = np.minimum(((coords[:, 0] - 4000.0) / 1500.0 * domains).astype(int), domains - 1)
    prog = np.tile(rng.gamma(2.0, 0.5, d), (domains, 1))
    for c in range(domains):
        prog[c, c * 10 : c * 10 + 10] *= 6.0
    prog /= prog.sum(1, keepdims=True)
    counts = rng.poisson(prog[domain] * rng.integers(100, 251, n)[:, None]).astype(np.float32)
    mem = MemoryBackend(sp.csc_matrix(counts.T), [f"g{i}" for i in range(d)],
                        [f"c{j}" for j in range(n)])
    return coords, domain, mem


def test_pinto_sweep_kernels_at_the_sweep_plane(dev):
    """K3 (the community sums and sizes) and K2 (the scores) at a sweep's
    plane, fractional (gene-weighted) profiles, against their plain
    versions; two launches bit-equal. Each K3 sum runs over tens of
    thousands of terms, where the plain float32 sum itself strays past
    1e-5 of float64: K3 is held elementwise to the plain version at 1e-5,
    or to the float64 sum, no farther from it than twice the plain
    version is (`chip_smoke.py`'s float64 arm)."""
    from legume_tpu_torch.pinto import lc as tlc

    coords, _, mem = _spatial_cells()
    edges = tlc.spatial_knn_edges(coords, 10, device=dev)
    w = np.random.default_rng(0).uniform(0.3, 1.7, mem.num_rows).astype(np.float32)
    plane = tlc.SweepPlane.from_csr(tlc.edge_profiles(mem, edges, gene_weights=w), dev)
    k = 10
    lab = torch.randint(0, k, (plane.n_edges,), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    for args, genes in (((plane.rows, plane.ptr, plane.vals), plane.n_genes),
                        ((plane.tot_rows, plane.tot_ptr, plane.edge_tot), 1)):
        got = kernels.collapse(*args, lab, num_genes=genes, num_groups=k)
        assert torch.equal(got, kernels.collapse(*args, lab, num_genes=genes, num_groups=k))
        want = kernels.collapse_plain(*args, lab, num_genes=genes, num_groups=k)
        rows, ptr, vals = (a.cpu() for a in args)
        cols = torch.repeat_interleave(torch.arange(ptr.numel() - 1), (ptr[1:] - ptr[:-1]).long())
        keys = rows.long() * k + lab.cpu().long()[cols]
        exact = torch.zeros(genes * k, dtype=torch.float64).index_add_(0, keys, vals.double())
        exact = exact.view(genes, k)
        if not bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()):
            err64, plain64 = (float((x.cpu().double() - exact).abs().max()) for x in (got, want))
            assert err64 <= 2.0 * plain64, (err64, plain64)
    basis = torch.randn(plane.n_genes, k, generator=torch.Generator().manual_seed(2)).to(dev)
    got = kernels.project(basis, plane.rows, plane.ptr, plane.vals, normed=False)
    assert torch.equal(got, kernels.project(basis, plane.rows, plane.ptr, plane.vals, normed=False))
    want = kernels.project_plain(basis, plane.rows, plane.ptr, plane.vals, normed=False)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_pinto_gumbel_noise_on_the_card_equals_the_cpu(dev):
    """The sweep's Gumbel noise drawn on the card has the CPU's bits (JAX's
    `jax.random.gumbel`, held in `tests/test_torch_pinto.py`)."""
    from legume_tpu_torch.utils import prng

    keys = prng.split(prng.key(7), 3)
    card = prng.gumbel_keys(keys, 200_003, dev).cpu()
    cpu = prng.gumbel_keys(keys, 200_003, "cpu")
    assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))


def test_pinto_lc_on_the_card_is_bit_equal_and_matches_the_cpu(dev):
    """Two card runs of `fit_link_community` give the same labels and
    trace bit for bit; the CPU run has the same edges and edge labels
    within the CPU tests' band (ARI 0.95)."""
    from legume_tpu_torch.pinto import lc as tlc

    coords, domain, mem = _spatial_cells()
    kw = dict(n_communities=4, knn=10, n_sweeps=15, n_greedy=5, em_sweeps=5, seed=3)
    a = tlc.fit_link_community(mem, coords, device=dev, **kw)
    b = tlc.fit_link_community(mem, coords, device=dev, **kw)
    np.testing.assert_array_equal(a.edge_labels, b.edge_labels)
    assert a.scores_trace == b.scores_trace
    c = tlc.fit_link_community(mem, coords, device="cpu", **kw)
    np.testing.assert_array_equal(a.edges, c.edges)
    _, ia = np.unique(a.edge_labels, return_inverse=True)
    _, ic = np.unique(c.edge_labels, return_inverse=True)
    table = np.zeros((ia.max() + 1, ic.max() + 1))
    np.add.at(table, (ia, ic), 1)
    pairs = lambda x: x * (x - 1) / 2.0  # noqa: E731
    s_a, s_c = pairs(table.sum(1)).sum(), pairs(table.sum(0)).sum()
    expected = s_a * s_c / pairs(len(ia))
    ari = (pairs(table).sum() - expected) / (0.5 * (s_a + s_c) - expected)
    assert ari >= 0.95, ari


def test_sgvb_fit_on_the_card_is_bit_equal_and_matches_the_cpu(dev):
    """The SGVB trainer's normal draws on the card have the CPU's bits (JAX's
    `jax.random.normal`); two card fits of the same locus give the same q
    bit for bit; the card's fit lies within 1e-3 of the CPU's in PIP (the
    card's matmuls round otherwise than the CPU's)."""
    from legume_tpu_torch.fagioli import sumstat as tss
    from legume_tpu_torch.models import sgvb
    from legume_tpu_torch.utils import prng

    keys = prng.split(prng.key(4), 3)
    assert torch.equal(prng.normal_exact_keys(keys, 100_003, dev).cpu().view(torch.int32),
                       prng.normal_exact_keys(keys, 100_003, "cpu").view(torch.int32))
    sim = tss.simulate_sumstat(n=300, p=120, n_causal=2, h2=0.4, seed=2)
    design = sgvb.RssDesign.from_genotypes(sim.genotypes, sim.z)
    cfg = sgvb.SgvbConfig(num_steps=600, learning_rate=0.02)
    a, b = (sgvb.fit_susie_rss(design, L=4, config=cfg, device=dev) for _ in range(2))
    for u, v in zip(a["q"], b["q"]):
        assert torch.equal(u, v)
    assert a["elbo"] == b["elbo"]
    c = sgvb.fit_susie_rss(design, L=4, config=cfg, device="cpu")
    assert np.abs(a["pip"] - c["pip"]).max() <= 1e-3
    assert abs(a["elbo"] - c["elbo"]) <= 1e-4 * abs(c["elbo"])


def test_fagioli_pseudobulk_sums_through_k3_match_the_plain_version(dev):
    """fagioli's pseudobulk sums (hard and soft cell-type membership) take
    one K3 launch per cell type and equal the plain version's sums within
    K3's bar (1e-5), run twice bit-equal."""
    from legume_tpu_torch.fagioli import qtl as tqtl

    rng = np.random.default_rng(3)
    counts = sp.random(300, 5000, density=0.2, format="csc", random_state=4,
                       data_rvs=lambda n: rng.integers(1, 20, n)).astype(np.float32)
    indv = rng.integers(0, 40, 5000)
    memb = rng.dirichlet(np.ones(3), 5000).astype(np.float32)
    for m in (np.ones((5000, 1), np.float32), memb):
        kernels.reset_launch_counts()
        got = tqtl.pseudobulk_sums(counts, indv, 40, m, device=dev)
        assert kernels.launch_counts["collapse"] == m.shape[1]
        assert torch.equal(got, tqtl.pseudobulk_sums(counts, indv, 40, m, device=dev))
        want = tqtl.pseudobulk_sums(counts, indv, 40, m, device="cpu")
        assert bool(((got.cpu() - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def test_chickpea_pseudobulk_partitions_on_the_card_match_the_cpu(dev, tmp_path):
    """`chickpea p2g --pseudobulk`'s cell partition (the RNA projection K1,
    the sort) on the card equals the CPU's as a set partition, and both
    pseudobulk planes (RNA through `load_and_collapse`, ATAC through
    `collect_basic_stats` and `optimize`, K3) lie within 1e-4 of the CPU's
    (normwise). The links' PIPs are not compared: on ~160 pseudobulks the
    peaks' LD leaves SuSiE's single effects near-ties, which the card's
    and the CPU's rounding resolve apart (up to 0.19 in PIP on an H100)."""
    from legume_tpu_torch.cli.main import run_chickpea, run_sim
    from legume_tpu_torch.data import open_sparse_matrix
    from legume_tpu_torch.ops import collapse as tclp

    out = str(tmp_path / "mo")
    run_sim(["multiome", "--genes", "20", "--peaks", "80", "--cols", "3000", "--factors", "4",
             "--output", out])
    rna, atac = SparseIoVec(), SparseIoVec()
    rna.push(open_sparse_matrix(f"{out}.rna.zarr"))
    atac.push(open_sparse_matrix(f"{out}.atac.zarr"))
    args = ttopic.TopicArgs(proj_dim=50, sort_dim=8, num_levels=1, iter_opt=30, seed=0)
    planes = {}
    for d in (dev, "cpu"):
        lv = ttopic.load_and_collapse(rna, args, device=d)
        groups, n_pb = lv.groups_per_level[0], lv.num_groups_per_level[0]
        astat = tclp.collect_basic_stats(atac, groups, n_pb, device=d)
        planes[str(d)] = (groups, lv.collapsed[0].mu_observed.mean().cpu(),
                          tclp.optimize(astat, num_iter=30, device=d).mu_observed.mean().cpu())
    (gc, rc, ac), (gh, rh, ah) = planes[str(dev)], planes["cpu"]
    pairs = set(zip(gc.tolist(), gh.tolist()))
    assert len(pairs) == len(set(gc.tolist())) == len(set(gh.tolist()))
    cpu_label = np.empty(len(pairs), np.int64)  # the two runs number the same groups apart
    for a, b in pairs:
        cpu_label[a] = b
    for a, b in ((rc, rh), (ac, ah)):
        b = b[:, torch.from_numpy(cpu_label)]
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    kernels.reset_launch_counts()
    run_chickpea(["p2g", "--rna", f"{out}.rna.zarr", "--atac", f"{out}.atac.zarr", "--gff",
                  f"{out}.genes.gff", "--out", str(tmp_path / "p"), "--pseudobulk",
                  "--cis-window", "20000", "--rank", "200", "--steps", "300", "--device", "cuda"])
    assert kernels.launch_counts["project_normed"] > 0 and kernels.launch_counts["collapse"] > 0


def _y_trajectory(rng, n_trunk=300, n_arm=200):
    """The planted Y of `tests/test_lineage_forest.py`: a trunk along x and
    two arms, velocity along the flow plus noise."""
    def seg(a, b, n):
        t = rng.uniform(0, 1, n)[:, None]
        return np.array(a) + t * (np.array(b) - np.array(a)) + rng.normal(0, 0.05, (n, 2))

    theta = np.vstack([seg([0, 0], [1, 0], n_trunk), seg([1, 0], [2, 1], n_arm),
                       seg([1, 0], [2, -1], n_arm)]).astype(np.float32)
    vel = (np.vstack([np.tile([1, 0], (n_trunk, 1)), np.tile([0.7, 0.7], (n_arm, 1)),
                      np.tile([0.7, -0.7], (n_arm, 1))])
           + rng.normal(0, 0.3, theta.shape)).astype(np.float32)
    return theta, vel


def test_faba_lineage_on_the_card_matches_the_cpu(dev, tmp_path):
    """`faba lineage` on the Y (k-means, PHATE on 80 landmarks, the
    velocity grid's kNN on the card): labels, edges, calls, trees and
    pseudotime equal the CPU run's; the layout within 1e-4."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_faba

    theta, vel = _y_trajectory(np.random.default_rng(0))
    cells = [f"c{i}" for i in range(len(theta))]
    for mat, name in ((theta, "latent"), (vel, "velocity")):
        pd.DataFrame(mat, columns=["a", "b"]).assign(cell=cells).set_index("cell") \
            .reset_index().to_parquet(tmp_path / f"fit.{name}.parquet")
    argv = ["lineage", "--from", str(tmp_path / "fit"), "--n-centroids", "15", "--seed", "1",
            "--latent-geometry", "euclidean", "--phate-landmarks", "80",
            "--edge-direction-n-boot", "80", "--edge-direction-n-perm", "150"]
    for d in ("cuda", "cpu"):
        run_faba(argv + ["--out", str(tmp_path / d), "--device", d])
    for table in ("nodes", "edges", "trees", "lineages", "pseudotime", "curves",
                  "cell_lineage_weights"):
        a = pd.read_parquet(tmp_path / f"cuda.{table}.parquet")
        b = pd.read_parquet(tmp_path / f"cpu.{table}.parquet")
        num = [c for c in a.columns if a[c].dtype.kind == "f"]
        pd.testing.assert_frame_equal(a.drop(columns=num), b.drop(columns=num))
        np.testing.assert_allclose(a[num].to_numpy(), b[num].to_numpy(), rtol=0, atol=1e-5,
                                   equal_nan=True, err_msg=table)
    for table in ("cells_2d", "nodes_2d", "curves_2d"):
        a = pd.read_parquet(tmp_path / f"cuda.{table}.parquet")
        b = pd.read_parquet(tmp_path / f"cpu.{table}.parquet")
        np.testing.assert_allclose(a[["x", "y"]].to_numpy(), b[["x", "y"]].to_numpy(), rtol=0,
                                   atol=1e-4, err_msg=table)
    pt = pd.read_parquet(tmp_path / "cuda.pseudotime.parquet")
    assert np.corrcoef(theta[:, 0], np.nan_to_num(pt.pseudotime))[0, 1] > 0.95


def test_fit_archetypes_on_the_card_matches_the_cpu(dev):
    """The same Dirichlet starts, 100 projected-gradient steps on the card
    and the CPU: archetypes within 1e-3 of their span, both factors on
    the simplex."""
    from legume_tpu_torch.ops.archetypal import fit_archetypes

    rng = np.random.default_rng(3)
    corners = rng.normal(0, 3, (5, 20)).astype(np.float32)
    x = rng.dirichlet(np.ones(5) * 0.4, 2000).astype(np.float32) @ corners
    got = fit_archetypes(x, 5, n_iter=100, seed=0, device=dev)
    want = fit_archetypes(x, 5, n_iter=100, seed=0, device="cpu")
    scale = float(np.ptp(want[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3 * scale)
    for m in got[1:]:
        np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-4)


def test_faba_annotate_projection_on_the_card_is_bit_equal(dev, tmp_path):
    """Two card runs of `faba annotate` (projection, both tracks; the cell
    kNN graph on the card) write the same tables, bit for bit, and call
    the planted types."""
    import json

    import pandas as pd

    from legume_tpu_torch.cli.main import run_faba

    rng = np.random.default_rng(0)
    h, nh = 4, 300
    a, b, c = np.eye(h, dtype=np.float32)[:3]
    cells = np.vstack([a + rng.normal(0, 0.15, (nh, h)), b + rng.normal(0, 0.15, (nh, h))])
    vel = np.vstack([c + rng.normal(0, 0.1, (nh, h)), b + rng.normal(0, 0.1, (nh, h))])
    spl = np.vstack([a + rng.normal(0, 0.1, (20, h)), b + rng.normal(0, 0.1, (20, h)),
                     c + rng.normal(0, 0.1, (20, h))])
    genes, names = [f"g{i}" for i in range(60)], [f"c{i}" for i in range(2 * nh)]
    pre = str(tmp_path / "fit")
    cols = [f"h{j}" for j in range(h)]
    pd.DataFrame(cells.astype(np.float32), columns=cols).assign(cell=names).set_index("cell") \
        .reset_index().to_parquet(f"{pre}.cell_embedding.parquet")
    pd.DataFrame(vel.astype(np.float32), columns=cols).assign(cell=names).set_index("cell") \
        .reset_index().to_parquet(f"{pre}.velocity.parquet")
    rows = [f"{g}/count/spliced" for g in genes] + [f"{g}/count/unspliced" for g in genes]
    pd.DataFrame(np.vstack([spl, spl]).astype(np.float32), columns=cols).assign(feature=rows) \
        .set_index("feature").reset_index().to_parquet(f"{pre}.feature_embedding.parquet")
    json.dump({"model_type": "embedding"}, open(f"{pre}.gem.json", "w"))
    (tmp_path / "m.tsv").write_text("".join(
        [f"g{i}\t{t}\n" for t, lo in (("Alpha", 0), ("Beta", 20), ("Gamma", 40))
         for i in range(lo, lo + 20)]))
    for run in ("r1", "r2"):
        run_faba(["annotate", "--from", pre, "--markers", str(tmp_path / "m.tsv"),
                  "--out", str(tmp_path / run), "--n-boot", "20", "--device", "cuda"])
    for table in ("spliced.annotation", "spliced.clusters", "spliced.qmatrix",
                  "velocity.annotation", "velocity.clusters"):
        pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / f"r1.{table}.parquet"),
                                      pd.read_parquet(tmp_path / f"r2.{table}.parquet"),
                                      check_exact=True)
    ann = pd.read_parquet(tmp_path / "r1.spliced.annotation.parquet")["annotation"].to_numpy()
    assert (ann == np.array(["Alpha"] * nh + ["Beta"] * nh)).mean() > 0.95


def _dp_run(argv, cwd, env_extra, timeout=600):
    """`python -m legume_tpu_torch` in `cwd` under the process-group
    switches `env_extra`; returns the process (started)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]), **env_extra}
    return subprocess.Popen([sys.executable, "-m", "legume_tpu_torch", *argv], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _dp_wait(procs, timeout=600):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def test_topic_data_parallel_on_the_card(dev, tmp_path):
    """`senna topic --data-parallel` on the JAX package's two-process test
    data and flags (`tests/torch_dp.py`): (a) a world of one over NCCL
    writes the plain run's latent, dictionary, llik trace, QC table and
    partition bit for bit; (b) two ranks sharing the card over gloo give
    the same QC keep mask and partition, proportions within 0.05 (the
    dominant topic agreeing for more than 95% of cells) and the llik trace
    within rtol 2e-2, atol 1e-2, and only rank 0 writes (chip_smoke.py's
    phase 43 at a small size)."""
    import socket
    import sys
    from pathlib import Path

    from legume_tpu_torch.utils.output import read_table

    sys.path.insert(0, str(Path(__file__).parent))
    from torch_dp import TOPIC_ARGV, two_batch_store

    argv = ["senna", "topic", "--data-files", *two_batch_store(tmp_path), "--out", "t",
            *TOPIC_ARGV]

    def world(size, rank, port):
        return {"LEGUME_COORDINATOR": f"127.0.0.1:{port}", "LEGUME_NUM_PROCESSES": str(size),
                "LEGUME_PROCESS_ID": str(rank)}

    def port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    for d in ("plain", "a", "b0", "b1"):
        (tmp_path / d).mkdir()
    p2 = port()
    _dp_wait([_dp_run(argv, tmp_path / "plain", {}),
              _dp_run(argv + ["--data-parallel"], tmp_path / "a", world(1, 0, port())),
              *[_dp_run(argv + ["--data-parallel"], tmp_path / f"b{r}", world(2, r, p2))
                for r in range(2)]])
    plain, a, b = (str(tmp_path / d / "t") for d in ("plain", "a", "b0"))
    for name in ("latent", "dictionary", "log_likelihood", "qc"):
        x, y = read_table(f"{plain}.{name}.parquet"), read_table(f"{a}.{name}.parquet")
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])
    np.testing.assert_array_equal(read_table(f"{b}.qc.parquet")["keep"],
                                  read_table(f"{plain}.qc.parquet")["keep"])
    for other in (a, b):
        with np.load(f"{plain}.partition.npz") as x, np.load(f"{other}.partition.npz") as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(y[k], x[k])
    assert list((tmp_path / "b1").iterdir()) == []

    def props(prefix):
        t = read_table(f"{prefix}.latent.parquet")
        return np.exp(np.column_stack([v for k, v in t.items() if k != "cell"]))

    z1, z2 = props(plain), props(b)
    np.testing.assert_allclose(z2, z1, atol=0.05)
    assert (z1.argmax(1) == z2.argmax(1)).mean() > 0.95
    np.testing.assert_allclose(read_table(f"{b}.log_likelihood.parquet")["llik"],
                               read_table(f"{plain}.log_likelihood.parquet")["llik"],
                               rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("cmd", ["cocoa", "bge", "gem", "gem_encoder", "masked", "lc"])
def test_slice19_data_parallel_on_the_card(dev, tmp_path, cmd):
    """`cocoa diff`, `senna bge`, `faba gem` / `gem-encoder`, `senna
    masked-topic` and `pinto lc` with `--data-parallel` on the two-rank
    CPU test's inputs (`tests/torch_dp.py`): (d) a world of one over NCCL
    writes the plain run's tables bit for bit; (e) for bge and lc, two
    ranks sharing the card over gloo hold bge's cell and feature
    embeddings within rtol 5e-3, atol 5e-5 and lc's planted stripes above
    0.85, and only rank 0 writes (chip_smoke.py's phase 43 at a small
    size)."""
    import socket
    import sys
    from pathlib import Path

    from legume_tpu_torch.utils.output import read_table

    sys.path.insert(0, str(Path(__file__).parent))
    from torch_dp import slice19_commands, slice19_stores

    def world(size, rank, port):
        return {"LEGUME_COORDINATOR": f"127.0.0.1:{port}", "LEGUME_NUM_PROCESSES": str(size),
                "LEGUME_PROCESS_ID": str(rank)}

    def port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    two = cmd in ("bge", "lc")
    runs = {"plain": ({}, False), "a": (world(1, 0, port()), True)}
    if two:
        p2 = port()
        runs.update({f"b{r}": (world(2, r, p2), True) for r in range(2)})
    procs, stores = [], {}
    for d, (env, dp) in runs.items():
        (tmp_path / d).mkdir()
        stores[d] = slice19_stores(tmp_path, f"_{d}")
        argv = slice19_commands(stores[d], ".", "cuda", dp)[cmd]
        procs.append(_dp_run(argv, tmp_path / d, env))
    _dp_wait(procs)
    names = {"cocoa": ("effect", "pvalue", "shared", "residual"),
             "bge": ("latent", "feature_embedding", "feature_posterior"),
             "gem": ("gene_embedding", "velocity", "latent", "delta_posterior"),
             "gem_encoder": ("gene_embedding", "velocity", "latent"),
             "masked": ("latent", "loss"),
             "lc": ("propensity", "edges", "score_trace", "gene_community", "consensus")}[cmd]
    plain, a = (str(tmp_path / d / cmd) for d in ("plain", "a"))
    for name in names:
        x, y = read_table(f"{plain}.{name}.parquet"), read_table(f"{a}.{name}.parquet")
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])
    if not two:
        return
    assert list((tmp_path / "b1").iterdir()) == []
    b = str(tmp_path / "b0" / cmd)
    if cmd == "bge":
        for name in ("latent", "feature_embedding"):
            x, y = (np.column_stack(list(read_table(f"{p}.{name}.parquet").values())[1:])
                    for p in (plain, b))
            np.testing.assert_allclose(y, x, rtol=5e-3, atol=5e-5)
    else:
        domain = stores["b0"]["domain"]
        prop = np.column_stack([v for k, v in read_table(f"{b}.propensity.parquet").items()
                                if k.startswith("c") and k != "cell"])
        lab = prop.argmax(1)
        acc = sum(np.bincount(domain[lab == k], minlength=3).max()
                  for k in range(3) if (lab == k).any()) / len(domain)
        assert acc > 0.85, acc


def test_bge_etm_layout_bit_equal_between_card_runs(dev, tmp_path):
    """Two card runs of `senna bge` with the ETM layout on write the same
    dictionary and topic latent, bit for bit: the layout's cluster sums
    take a fixed order (`segment_add`; with `index_add_`'s float atomics
    the two tables moved between runs, as chip_smoke.py's phase 43 found)."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, run_bge
    from legume_tpu_torch.utils.output import read_table

    sim = simulate_topic(rows=200, cols=3000, factors=5, batches=1, seed=3)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    for run in ("r1", "r2"):
        run_bge(BgeArgs(epochs=200, sort_dim=5, proj_dim=16, out=str(tmp_path / run)), vec=vec,
                device=dev)
    for name in ("latent", "feature_embedding", "dictionary", "topic_latent"):
        x, y = (read_table(str(tmp_path / f"{r}.{name}.parquet")) for r in ("r1", "r2"))
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(y[k], x[k], err_msg=f"{name}.{k}")
