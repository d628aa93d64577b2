"""The port's `fit_bge` on the CPU against the JAX package's `fit_bge`,
with the fused kernel in interpret mode (`use_pallas=True`) and on its
XLA path (`use_pallas=False`). The initial weights are the same threefry
draws and the optimiser is optax's update in torch ops, so trajectories
are compared, at the bar of `tests/test_nce_pallas.py`: embeddings atol
2e-4, phase-1 losses rtol 1e-4 / atol 1e-5."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from legume_tpu.data import SparseIoVec as JVec
from legume_tpu.data.sparse_io import MemoryBackend as JMem
from legume_tpu.embedding.nce import NceConfig as JConfig
from legume_tpu.embedding.nce import fit_bge as j_fit_bge
from legume_tpu.ops.gene_stats import hvg_feature_qc as j_hvg_feature_qc
from legume_tpu_torch.data import MemoryBackend, SparseIoVec
from legume_tpu_torch.embedding.nce import NceConfig, fit_bge
from legume_tpu_torch.ops.gene_stats import hvg_feature_qc
from legume_tpu_torch.utils import prng

KW = dict(embedding_dim=6, epochs=40, learning_rate=0.05, seed=3)
P2_KW = dict(cell_batch=128, phase2_epochs=30)  # 300 cells: three blocks
ATOL, LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-4, 1e-5
# bf16: the port computes scores in f32 from bf16 counts (as the fused
# kernel does), the JAX XLA path in bf16
BF16_ATOL, BF16_LOSS_RTOL = 5e-2, 1e-2


def _counts(seed=2, p=21, d=150, lam=1.5):
    return np.random.default_rng(seed).poisson(lam, (p, d)).astype(np.float32)


def _assert_phase1(port, ref, atol=ATOL, rtol=LOSS_RTOL, loss_atol=LOSS_ATOL):
    assert port.e_feat.shape == ref.e_feat.shape
    np.testing.assert_allclose(port.e_feat, ref.e_feat, atol=atol)
    np.testing.assert_allclose(port.b_feat, ref.b_feat, atol=atol)
    assert len(port.pb_embeddings) == len(ref.pb_embeddings)
    for t, j in zip(port.pb_embeddings, ref.pb_embeddings):
        np.testing.assert_allclose(t, j, atol=atol)
    assert len(port.phase1_losses) == len(ref.phase1_losses)
    np.testing.assert_allclose(port.phase1_losses, ref.phase1_losses, rtol=rtol, atol=loss_atol)


@pytest.fixture(scope="module")
def backends():
    d, n = 150, 300
    x = sp.random(d, n, density=0.2, random_state=1, format="csc", dtype=np.float32)
    x.data = np.ceil(x.data * 5).astype(np.float32)
    genes, cells = [f"g{i}" for i in range(d)], [f"c{i}" for i in range(n)]
    jv, tv = JVec(), SparseIoVec()
    jv.push(JMem(x, genes, cells))
    tv.push(MemoryBackend(x, genes, cells))
    pb = np.stack([np.asarray(x[:, i::10].sum(1)).ravel() for i in range(10)]).astype(np.float32)
    return jv, tv, pb


@pytest.mark.parametrize("use_pallas", [True, False])
def test_phase1_matches_jax(use_pallas):
    counts = _counts()
    ref = j_fit_bge([counts], config=JConfig(**KW, use_pallas=use_pallas))
    port = fit_bge([counts], config=NceConfig(**KW), device="cpu")
    _assert_phase1(port, ref)


def test_bf16_phase1_matches_the_fused_kernel():
    counts = _counts()
    ref = j_fit_bge([counts], config=JConfig(**KW, compute_dtype="bfloat16", use_pallas=True))
    port = fit_bge([counts], config=NceConfig(**KW, compute_dtype="bfloat16"), device="cpu")
    _assert_phase1(port, ref)


def test_multilevel_axes_match_jax():
    rng = np.random.default_rng(4)
    levels = [_counts(), rng.poisson(3.0, (7, 150)).astype(np.float32)]
    ref = j_fit_bge(levels, config=JConfig(**KW, use_pallas=False))
    port = fit_bge(levels, config=NceConfig(**KW), device="cpu")
    assert [e.shape for e in port.pb_embeddings] == [(21, 6), (7, 6)]
    assert [b.shape for b in port.pb_biases] == [(21,), (7,)]
    _assert_phase1(port, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase2_matches_jax(backends, dtype):
    """Phase 2 with the same keys: f32 within the phase-1 bar; bf16
    within the bf16 band (JAX computes its phase-2 scores in bf16, the
    port in f32 from bf16 counts)."""
    jv, tv, pb = backends
    cfg = dict(**KW, **P2_KW, compute_dtype=dtype)
    ref = j_fit_bge([pb], data=jv, config=JConfig(**cfg))
    port = fit_bge([pb], data=tv, config=NceConfig(**cfg), device="cpu")
    assert port.e_cell.shape == (300, 6) and len(port.phase2_losses) == 3
    atol, rtol = (ATOL, LOSS_RTOL) if dtype == "float32" else (BF16_ATOL, BF16_LOSS_RTOL)
    np.testing.assert_allclose(port.e_cell, ref.e_cell, atol=atol)
    np.testing.assert_allclose(port.b_cell, ref.b_cell, atol=atol)
    np.testing.assert_allclose(port.phase2_losses, ref.phase2_losses, rtol=rtol)
    np.testing.assert_allclose(port.phase1_losses, ref.phase1_losses, rtol=rtol)


def test_stratified_negatives_match_the_xla_path(backends):
    jv, tv, pb = backends
    pb_batches = [np.arange(10) % 2]
    cell_batches = np.random.default_rng(0).integers(0, 2, 300).astype(np.int32)
    kw = dict(pb_batches=pb_batches, cell_batches=cell_batches)
    ref = j_fit_bge([pb], data=jv, config=JConfig(**KW, **P2_KW), **kw)
    port = fit_bge([pb], data=tv, config=NceConfig(**KW, **P2_KW), device="cpu", **kw)
    _assert_phase1(port, ref)
    np.testing.assert_allclose(port.e_cell, ref.e_cell, atol=ATOL)
    np.testing.assert_allclose(port.phase2_losses, ref.phase2_losses, rtol=LOSS_RTOL)


def test_feature_qc_keeps_the_same_genes():
    rng = np.random.default_rng(7)
    base = rng.gamma(2.0, 1.0, 150)
    disp = np.where(np.arange(150) < 40, 5.0, 0.05)  # 40 overdispersed genes
    counts = rng.negative_binomial(1.0 / disp, 1.0 / (1.0 + base * disp), (60, 150)).astype(np.float32)
    keep = hvg_feature_qc(counts)
    np.testing.assert_array_equal(keep, j_hvg_feature_qc(counts))
    assert 0 < keep.sum() < 150
    cfg = dict(**KW, feature_qc=True)
    ref = j_fit_bge([counts], config=JConfig(**cfg, use_pallas=False))
    port = fit_bge([counts], config=NceConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(np.abs(port.e_feat).sum(1) == 0, ~keep)
    _assert_phase1(port, ref)


def test_initial_draws_are_the_first_dh_of_the_kernel_paths():
    """The JAX kernel path draws e_feat at (D rounded up to 128, H), its
    XLA path at (D, H); in partitionable threefry the first D*H draws
    agree bit for bit, and the port's draws equal them within one f32
    rounding of XLA's erfinv (`tests/test_torch_prng.py`)."""
    assert jax.config.jax_threefry_partitionable
    d, h = 150, 6
    k_f = jax.random.split(jax.random.key(3), 2)[0]
    padded = np.asarray(jax.random.normal(k_f, (256, h)))
    exact = np.asarray(jax.random.normal(k_f, (d, h)))
    np.testing.assert_array_equal(padded[:d], exact)
    port = prng.normal(prng.split(prng.key(3), 2)[0], (d, h))
    np.testing.assert_allclose(port, exact, rtol=0, atol=1e-6)


def test_unported_config_raises():
    # gene_chunk is ported (tests/test_torch_bge.py holds it to JAX); a
    # compute dtype the port has no path for still raises
    res = fit_bge([_counts()], config=NceConfig(**KW, gene_chunk=64), device="cpu")
    assert res.e_feat.shape == (150, KW["embedding_dim"])
    with pytest.raises(ValueError, match="compute_dtype"):
        fit_bge([_counts()], config=NceConfig(**KW, compute_dtype="float16"), device="cpu")
