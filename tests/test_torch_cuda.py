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


def test_vae_svd_and_masked_runs_on_the_card_match_the_cpu(dev, tmp_path):
    """vae at 0 epochs (the same CPU-drawn init on both) within 1e-4;
    svd's partition equal, its pseudobulk plane within 1e-5, the rSVD of
    one plane and the per-cell projection with one basis within 1e-4; a
    masked run (JAX's key schedule, drawn alike on both) with its trace
    and eval loss within 1e-4."""
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
    assert abs(masked["cuda"]["eval_loss"] - masked["cpu"]["eval_loss"]) <= 1e-4
