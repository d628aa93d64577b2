"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build the hand-written kernels of `legume_tpu_torch/csrc/` with nvcc
   for sm_90a and print the card's name and power limit;
2. run `senna topic` through the port's entry point with its default
   `TopicArgs` (only `epochs` cut to 5) on a simulated 100,000-cell x
   2,000-gene, 2-batch, 8-factor data set held in a `MemoryBackend`,
   with every kernel's launch count zeroed just before and read just
   after; check that the projection (K1) and collapse (K3) kernels ran,
   that the per-cell latent is a finite simplex and that the llik trace
   is finite;
3. hold every kernel against its plain torch version on the card, at
   the main path's own calls (the projections at its first 8,192-cell
   block with its basis; the collapse at that block's fine-group plane
   and batch plane, and at the first 1,024-query block of the weighted
   matched plane) and at the largest production shape (34,008 genes,
   8,192 cells, ~8.4M nonzeros, K = 64, 607 groups); time kernel, plain
   version, one library call of the same function where there is one,
   and the least time the card could take;
4. split the trainer's construction into its parts in a fresh process;
5. run `senna bge` through the port's entry point with the JAX package's
   CLI defaults (`-d 16`, 1,000 epochs, sort-dim 8, proj-dim 50, ETM on)
   on the same simulated data without its batches (so the marginal is
   unstratified and both NCE phases take K4), counts zeroed just before
   and read just after; check that K1, K3 and K4 ran, K4 exactly
   1,000 x levels + ceil(N / 2,048) x 100 times and every phase-2 launch
   (ceil(N / 2,048) x 100) in its axis form, that the latent and the
   feature embedding are finite, that the phase-1 loss fell and that the
   topic latent is a log-simplex;
6. phase 1 of `fit_bge` alone at the NCE anchor (2,627 pseudobulks x
   34,008 genes, H = 16, 1,000 epochs, counts made as `bench.py` makes
   them) in f32 and in bf16; the two final losses agree within 1e-2;
7. hold K4 against its plain version at the e2e phase-1 plane, one e2e
   phase-2 block in both forms (full, and the axis form phase 2 runs) and
   the anchor in f32 and bf16, each with its byte and operation bounds
   (the CUDA cores' f32 work and the tensor cores' split-TF32 products),
   and K3 at the bge run's
   own group plane (its first 8,192-cell block over its sort-dim groups),
   and time both;
8. run `senna predict` (`eval-topic` options: per-batch null, 2 delta
   sweeps, 10 refinement steps) through the port's entry point with the
   phase-2 model on 100,000 held-out cells (another seed, 2 batches, the
   genes permuted, 5% renamed `ENSG..._<name>`, 5% not in the model);
   check the mapped genes, the delta's range and the latent's simplex;
   hold the first 4,096-cell block against the port's CPU run (1e-3,
   with and without refinement; each float32 run's distance from the
   block in float64 is printed beside it); run `--decoder-only` on 10,000 of
   the cells; form the residual matrix on the card (the writers need
   tensorstore or h5py, which the card's machine may lack: their
   availability is printed);
9. run `senna clustering` on that latent: kmeans (K = 10) with the BHC
   merge tree over the counts, its per-cluster sums through K3 (counts
   zeroed just before, one launch per 4,096-cell block required), held
   at one BHC plane against the plain version; hsblock (depth 4) at
   100,000 cells, and on a 5,000-cell subset against the port's CPU run
   (equal partitions up to relabelling); Leiden at 20,000 cells;
10. report whether phase 2's fine partition on the card equals the
   port's CPU projection and sort at 100,000 cells as a set partition
   (and as codes);
11. on predict's latent, through the port's CLI: `senna clustering --from`
   (kmeans, recorded into predict's manifest), `senna layout` by umap
   (CLI defaults: 15 neighbours, 200 epochs, so 2,000 SGD steps of 4,096
   edges; `--from`, recorded into the manifest) and tumap `--pcs 5` at
   all 100,000 cells, tsne on the first 10,000 and phate on the first
   2,000 cells (both dense [N, N]), `senna pseudotime` (50 nodes) at
   100,000 cells, `senna layout --method tree --from` that run, `senna
   pseudotime --velocity` with a velocity toward each cell's kNN
   neighbours of higher topic-0 share, and, where matplotlib imports,
   `senna plot --from` and `senna plot-topic` (1,000 cells: matplotlib
   draws a rectangle per cell and topic) with the topic run's
   dictionary; each command's stage seconds, peak device bytes and
   kernel launches (none of the four kernels is on these paths); every
   layout finite; umap's neighbour preservation (the share of 15 latent
   neighbours among 15 layout neighbours, 5,000 sampled cells); and on
   3,000 of the cells the card against the port's CPU run: umap after 50
   steps (and a second card run, bit-equal) and tsne after 50 iterations
   within 1e-3, phate's squared distances bit-equal and its 200-step
   refinement within 1e-3, pseudotime's nodes within 1e-4 with its tree,
   assignments, branches and root equal;
12. the `senna topic` options through the port's CLI entry point
   (`run_senna` with the cells in memory), each run at the default
   `TopicArgs` with 5 epochs and its kernel counts zeroed just before and
   read just after (K1 and K3 required): `--decoder nb-mixture,multinomial
   --decoder-weights 1 0.5 --rho-prior-weight 10 --max-coarse-features
   1000 --qc --qc-max-mito-frac 0.2` on a view of phase 2's cells with 13
   genes named `MT-` (the kept cells, each level's coarse features, every
   artifact, alpha summing to 1, the dispersion positive, the full-D
   dictionaries' columns on the simplex); `--decoder poisson --from`
   phase 2's run (its partition exactly, no sort); `--init-from` phase
   2's model (and a mismatched `-k` raising `ValueError`); `senna
   predict` with the multi-decoder model on 10,000 held-out cells; and
   on the first 4,096 cells the card against the CPU: each new decoder
   family's llik and gradients (normwise, relative 1e-5) and QC's
   statistics (exact);
13. the `senna bge` options (each run's counts zeroed just before and
   read just after): (a) `--multiome --skip-etm` on `simulate_multiome`
   (50,000 cells, 2,000 genes + 4,000 peaks, seed 13; K1, K3 and K4
   required, D = 6,000 checked; K4 held against its plain version at the
   run's phase-1 plane and first phase-2 block); (b) `--posterior 45 --skip-etm` on
   phase 5's cells (pip in [0, 1], pip and rhat finite); (c) `pb_gibbs`
   at the NCE anchor from phase 6's f32 fit, 45 sweeps after 11 of
   burn-in, with seconds a sweep and the ESS shrink iterations; (d)
   `fit_bge` with `gene_chunk=512` on phase 5's plane, its ten phase-1
   losses within a relative 1e-4 of the dense run and no K4 launch;
14. `senna rest --from` phase 2's topic run (100,000 x 2,000, 400
   epochs; finite, loss falling) and `--runs` phase 5's and 13b's bge runs;
15. `cocoa`: `simulate_collider` at 40 individuals x 2,500 cells, 2,000
   genes, 3 types, a 2.2x amplified block of 100 genes in 6 individuals;
   `cocoa diff` through `run_cocoa` at the CLI defaults with the types as
   topics, 12 permutations and the CNV side-channel (K1 required; the
   causal genes' effects above the others', the carriers' block above
   the rest in cn_score, every timing key); `cocoa collapse` (one K3
   launch a block); K1 (K = 30) and K3 (40 groups) held against their
   plain versions at the first block each run gives them; on 100 cells
   of each individual the card against the CPU: the projections within
   K1's bar, caches from one projection equal up to distance ties of 1e-5,
   stats within 1e-5, z within 1e-4, CNV states equal, and the match
   cache reused by a second run;
16. `senna topic --cnv --from` phase 2's run (its cnv table: 80 bins,
   states in {0, 1, 2});
17. `senna vae` at the CLI defaults (`-k 16`, encoder (128, 64), 2
   levels, minibatch 100; 5 epochs) on phase 2's cells (K1 and K3
   required; llik rising), `senna predict` with that model on phase 8's
   held-out cells, `senna topic --decoder gaussian-nb --from` phase 2's
   run; the trained encoder on 4,000 cells on the card against the CPU
   (1e-3, as phase 8's; each one's distance from float64 printed);
18. `senna svd` at its defaults on phase 2's cells (K2 takes the per-cell
   Nystrom projection: one launch per 8,192-cell block, 13, required; K2
   held against its plain version and `torch.sparse.mm` at svd's first
   block), its batch-adjusted counts (written with `--save-adjusted`
   where tensorstore imports, else formed on the card), `senna joint-svd`
   on phase 13a's RNA and ATAC; `fit_svd` on 4,000 cells (without
   batches) on the card against the CPU, stage by stage: the same
   partition, the pseudobulk plane within 1e-5, the rSVD of one plane and
   the per-cell projection with one basis within 1e-4 (groups of singular
   values within 5% compared up to rotation); with batches the same,
   reported only (one matched neighbour may part at a near tie);
19. `senna joint-topic` at the CLI defaults (`-k 10`, encoder (128, 128),
   nb; 5 epochs) on phase 13a's RNA and ATAC, and `--decoder delta` on
   the RNA plane and a second `simulate_topic` draw of its shape (K1 and
   K3 required; llik rising); each trained joint encoder on the card
   against the CPU (1e-5 normwise);
20. `senna masked-topic` at its defaults (`-k 10`, `--window 128`,
   `--embed-dim 64`, minibatch 256; 5 epochs) on phase 2's cells with
   `--batch-files` (its null stream's collapse: K1 and K3 required) and
   `--eval-mask-fraction 0.1`; `masked-vae` and `masked-sbp
   --gene-modules 8` on 20,000 of them (loss falling); `senna predict`
   with the masked-vae model on phase 8's held-out cells, and the
   batch-null model refused (the JAX package's predict fails on it); on
   4,000 cells the card against the CPU: top-K windows and the union
   equal, the encoder (normwise) and `masked_eval_loss` within 1e-5;
21. print the script's total seconds, one JSON line of all kernels, then
   the device line last.

Every kernel check launches the kernel twice on the same inputs and
fails unless the two results are bit-equal (`deterministic`). Times are
the guide's method: CUDA events around REPS back-to-back calls, divided
by REPS, after warm-up; kernel, plain version and library call are timed
in turns (ROUNDS rounds of each, in that order) and each reports the
median of its rounds.

TF32 is off for matmuls and cuDNN: every float32 product runs in full
float32, as the reference package computes it.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
WARMUP, REPS, ROUNDS = 3, 20, 3

# tolerances: normwise max|kernel - plain| / max|plain| for the
# projections (sums with cancellation), elementwise for the collapse
# (sums of non-negative values)
RTOL_K1, RTOL_K2 = 2e-4, 1e-4
ATOL_K3 = RTOL_K3 = 1e-5
# K4 (tests/test_nce_pallas.py): the loss sum within a relative 2e-5 and
# each gradient normwise, max|kernel - plain| <= 1e-4 * max|plain|. Where
# the plain float32 gradient itself lies farther than that from the same
# function in float64 (a trained gradient whose terms cancel), the
# kernel's gradient is held to float64 instead: no farther from it than
# F64_FACTOR_K4 times the plain float32 gradient is.
RTOL_K4_LOSS, RTOL_K4_GRAD = 2e-5, 1e-4
F64_FACTOR_K4 = 2.0
# bf16 against f32 final loss at the anchor (tests/test_nce_pallas.py)
RTOL_BF16_LOSS = 1e-2

# Run in a fresh process: splits `MixedTrainer`'s construction at the e2e
# shapes into CUDA start-up, moving the modules to the card, the
# `torch._dynamo` import that `torch.optim`'s first optimizer triggers,
# and the AdamW constructor itself (first and second call).
SETUP_PROBE = r"""
import json, sys, time
t = time.time(); import torch; s = {"import_torch_s": time.time() - t}
t = time.time(); torch.zeros(1, device="cuda"); torch.cuda.synchronize()
s["cuda_init_s"] = time.time() - t
from legume_tpu_torch.models.decoders import NbTopicDecoder
from legume_tpu_torch.models.encoders import LogSoftmaxEncoder
g = torch.Generator().manual_seed(0)
enc = LogSoftmaxEncoder(2000, 10, (128, 1024, 128), generator=g)
decs = torch.nn.ModuleList(NbTopicDecoder(2000, 10, generator=g) for _ in range(3))
t = time.time(); enc.to("cuda"); decs.to("cuda"); torch.cuda.synchronize()
s["modules_to_card_s"] = time.time() - t
params = list(enc.parameters()) + list(decs.parameters())
t = time.time(); import torch._dynamo; s["import_dynamo_s"] = time.time() - t
s["triton_imported"] = "triton" in sys.modules
for i in (1, 2):
    t = time.time(); torch.optim.AdamW(params, lr=0.01, weight_decay=0.01)
    s[f"adamw_{i}_s"] = time.time() - t
print(json.dumps({"phase": "train_setup_split", **s}))
"""


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Milliseconds per call: CUDA events around REPS back-to-back calls,
    divided by REPS, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def time_turns(**fns) -> dict:
    """`time_ms` of each function in turns, ROUNDS rounds; the median of
    each one's rounds (None for a missing function)."""
    rounds = {name: [] for name, fn in fns.items() if fn is not None}
    for _ in range(ROUNDS):
        for name in rounds:
            rounds[name].append(time_ms(fns[name]))
    return {name: (float(np.median(rounds[name])) if name in rounds else None) for name in fns}


def bit_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_projection(K, basis, rows, ptr, vals, *, normed: bool, shape: str) -> dict:
    nnz, ncols, (d, k) = rows.shape[0], ptr.shape[0] - 1, basis.shape
    got = K.project(basis, rows, ptr, vals, normed=normed)
    again = K.project(basis, rows, ptr, vals, normed=normed)
    want = K.project_plain(basis, rows, ptr, vals, normed=normed)
    torch.cuda.synchronize()
    deterministic = bit_equal(got, again)
    if not deterministic:
        raise AssertionError(f"project(normed={normed}) at {shape}: two launches differ")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rtol = RTOL_K1 if normed else RTOL_K2
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        raise AssertionError(f"project(normed={normed}) at {shape}: err {err} vs scale {scale}")
    library = None
    if not normed:  # the same function as one CSR x dense product
        csr = torch.sparse_csr_tensor(
            ptr.long(), rows.long(), vals, size=(ncols, d), check_invariants=True
        )
        lib = torch.sparse.mm(csr, basis)
        if float((lib - want).abs().max()) > rtol * scale:
            raise AssertionError("torch.sparse.mm disagrees with the plain projection")
        library = lambda: torch.sparse.mm(csr, basis)  # noqa: E731
    times = time_turns(
        ms=lambda: K.project(basis, rows, ptr, vals, normed=normed),
        plain_ms=lambda: K.project_plain(basis, rows, ptr, vals, normed=normed),
        library_ms=library,
    )
    nbytes = nnz * 8 + (ncols + 1) * 4 + d * k * 4 + ncols * k * 4
    flops = nnz * k * 2 + (nnz * 3 if normed else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": shape, "nnz": nnz, "ncols": ncols, "genes": d, "k": k,
        "max_abs_err": err, "max_abs_plain": scale, "rtol": rtol,
        "deterministic": deterministic, **times, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_collapse(K, rows, ptr, vals, seg, *, num_genes: int, num_groups: int, shape: str) -> dict:
    nnz, ncols = rows.shape[0], ptr.shape[0] - 1
    kw = dict(num_genes=num_genes, num_groups=num_groups)
    got = K.collapse(rows, ptr, vals, seg, **kw)
    want = K.collapse_plain(rows, ptr, vals, seg, **kw)
    # counts are whole numbers, whose float sums come out the same in any
    # order; the same entries scaled off the integers make the bit-equal
    # check see the order of the sums
    frac = vals * torch.linspace(0.3, 1.7, vals.shape[0], device=vals.device)
    deterministic = bit_equal(K.collapse(rows, ptr, frac, seg, **kw),
                              K.collapse(rows, ptr, frac, seg, **kw))
    torch.cuda.synchronize()
    if not deterministic:
        raise AssertionError(f"collapse at {shape}: two launches differ")
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= ATOL_K3 + RTOL_K3 * want.abs()).all()):
        raise AssertionError(f"collapse at {shape}: max err {err}")
    # the library yardstick: index_add_ on precomputed flat (gene, group) keys
    cols = torch.repeat_interleave(torch.arange(ncols, device=rows.device), (ptr[1:] - ptr[:-1]).long())
    sg = seg.long()[cols]
    keep = sg < num_groups
    keys = rows.long()[keep] * num_groups + sg[keep]
    kv = vals[keep]
    flat = torch.zeros(num_genes * num_groups, device=rows.device)
    lib = flat.clone().index_add_(0, keys, kv).view(num_genes, num_groups)
    if not bool(((lib - want).abs() <= ATOL_K3 + RTOL_K3 * want.abs()).all()):
        raise AssertionError("index_add_ disagrees with the plain collapse")
    nbytes = nnz * 8 + (ncols + 1) * 4 + ncols * 4 + num_genes * num_groups * 4
    bound_ms, bound_by = bound(nbytes, nnz)
    return {
        "shape": shape, "nnz": nnz, "ncols": ncols, "genes": num_genes, "groups": num_groups,
        "max_abs_err": err, "atol": ATOL_K3, "rtol": RTOL_K3, "deterministic": deterministic,
        "plan": K.collapse_plan(ncols, num_genes, num_groups).__dict__,
        **time_turns(
            ms=lambda: K.collapse(rows, ptr, vals, seg, **kw),
            plain_ms=lambda: K.collapse_plain(rows, ptr, vals, seg, **kw),
            library_ms=lambda: flat.zero_().index_add_(0, keys, kv),
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_nce(K, c, q, e_f, b_f, e_a, b_a, m, *, shape: str, need_feat: bool = True) -> dict:
    """K4 against its plain version on one plane, in its full form or
    (`need_feat=False`) its axis form; `max_abs_err` is the largest over
    the gradients, the loss is held by its relative error. Each gradient
    is also measured against the plain version in float64 (`*_f64`)."""
    (p, d), h = c.shape, e_f.shape[1]
    kw = dict(need_feat=need_feat)
    got = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    again = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    want = K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    # the same function in float64 from the same inputs: how far each
    # float32 loss sum lies from it, in units of the float32 spacing there
    want64 = K.nce_epoch_plain(*(t.double() for t in (c, q, e_f, b_f, e_a, b_a, m)), 5.0, **kw)
    exact = float(want64[0])
    torch.cuda.synchronize()
    got_t = tuple(x for x in got if x is not None)
    deterministic = bit_equal(got_t, tuple(x for x in again if x is not None))
    if not deterministic:
        raise AssertionError(f"nce_epoch at {shape}: two launches differ")
    if not need_feat and (got[1] is not None or got[2] is not None):
        raise AssertionError(f"nce_epoch at {shape}: the axis form returned feature gradients")
    loss_k, loss_p = float(got[0]), float(want[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ulp = float(np.spacing(np.float32(abs(exact))))
    trios = [(g, w, x) for g, w, x in zip(got[1:], want[1:], want64[1:]) if w is not None]
    errs = [float((g - w).abs().max()) for g, w, _ in trios]
    scales = [float(w.abs().max()) for _, w, _ in trios]
    errs_f64 = [float((g.double() - x).abs().max()) for g, _, x in trios]
    plain_f64 = [float((w.double() - x).abs().max()) for _, w, x in trios]
    arms = ["plain" if e <= RTOL_K4_GRAD * sc else
            "float64" if pf > RTOL_K4_GRAD * sc and ef <= F64_FACTOR_K4 * pf else "failed"
            for e, sc, ef, pf in zip(errs, scales, errs_f64, plain_f64)]
    ok = all(bool(torch.isfinite(g).all()) for g in got_t)
    if not (ok and loss_rel <= RTOL_K4_LOSS and "failed" not in arms):
        raise AssertionError(f"nce_epoch at {shape}: loss rel {loss_rel}, grads {errs} vs "
                             f"{scales}; from float64 {errs_f64}, plain {plain_f64}")
    # each input read once, each output written once. The operations run
    # on two kinds of unit at once: the score product (2PDH) and ~20
    # operations an element on the CUDA cores in float32; the backward
    # products (g_ea, and g_ef in the full form, 2PDH each) on the tensor
    # cores in split TF32, three passes each. The bound takes the slower.
    feat_out = 4 * (d * h + d) if need_feat else 0
    nbytes = p * d * c.element_size() + 4 * (d * h + 2 * d + p * h + 2 * p) + 4 * (p * h + p + 1) + feat_out
    core_flops = 2 * p * d * h + 20 * p * d
    tensor_flops = 3 * (2 if need_feat else 1) * 2 * p * d * h
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_core_ms = core_flops / FP32_FLOPS * 1e3
    bound_tensor_ms = tensor_flops / TF32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_core_ms, bound_tensor_ms)
    bound_by = "bytes" if bound_ms == bound_bytes_ms else "operations"
    return {
        "shape": shape, "form": "full" if need_feat else "axis", "rows": p, "genes": d, "h": h,
        "count_dtype": str(c.dtype), "plan": {k: v for k, v in K.nce_plan(p, d, h).__dict__.items()
                                              if k in ("band_chunks", "range_tiles")},
        "max_abs_err": max(errs), "max_abs_plain": max(scales), "loss_rel_err": loss_rel,
        "grad_errs": errs, "grad_scales": scales, "grad_errs_f64": errs_f64,
        "plain_grad_errs_f64": plain_f64, "grad_bar_arms": arms,
        "loss_sum": loss_k, "loss_sum_plain": loss_p, "loss_sum_f64": exact, "f32_ulp": ulp,
        "loss_ulps_from_f64": (loss_k - exact) / ulp, "plain_ulps_from_f64": (loss_p - exact) / ulp,
        "rtol_loss": RTOL_K4_LOSS, "rtol_grad": RTOL_K4_GRAD, "deterministic": deterministic,
        # no single torch call computes the loss and the gradients
        **time_turns(
            ms=lambda: K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw),
            plain_ms=lambda: K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw),
            library_ms=None,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "core_flops": core_flops, "tensor_flops": tensor_flops, "bound_bytes_ms": bound_bytes_ms,
        "bound_ops_ms": max(bound_core_ms, bound_tensor_ms),
        "bound_core_ms": bound_core_ms, "bound_tensor_ms": bound_tensor_ms,
    }


def anchor_counts() -> np.ndarray:
    """The NCE anchor plane of `bench.py`: 2,627 x 34,008, ~3% occupied,
    Poisson(2) + 1 at random positions (numpy seed 11)."""
    rng = np.random.default_rng(11)
    counts = np.zeros(2_627 * 34_008, np.float32)
    nnz = int(0.03 * counts.size)
    counts[rng.integers(0, counts.size, nnz)] = rng.poisson(2.0, nnz) + 1.0
    return counts.reshape(2_627, 34_008)


def production_block(dev):
    """Synthetic block at the largest production shape: 8,192 cells with
    ~1,025 nonzeros each over 34,008 genes (~8.4M nonzeros)."""
    g = torch.Generator(device=dev).manual_seed(20240607)
    ncols, d = 8192, 34008
    counts = torch.randint(900, 1151, (ncols,), generator=g, device=dev)
    cells = torch.repeat_interleave(torch.arange(ncols, device=dev), counts)
    genes = torch.randint(0, d, (cells.shape[0],), generator=g, device=dev)
    # CSC order: genes sorted and distinct within each cell
    keys = torch.unique(cells * d + genes)
    rows = (keys % d).to(torch.int32)
    ptr = torch.zeros(ncols + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(keys // d, minlength=ncols), 0)
    nnz = rows.shape[0]
    vals = torch.floor(-torch.log(torch.rand(nnz, generator=g, device=dev)) * 3.0) + 1.0
    basis = torch.randn(d, 64, generator=g, device=dev)
    seg = torch.randint(0, 607, (ncols,), generator=g, device=dev, dtype=torch.int32)
    return d, basis, rows, ptr, vals, seg


def same_partition(a, b) -> bool:
    """Equal as set partitions: the pairs of labels form a bijection."""
    pairs = np.unique(np.stack([np.asarray(a), np.asarray(b)], 1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def held_out_vec(sim_rows, seed: int):
    """100,000 cells of another simulation over 2,100 genes: the first
    2,000 take the training names (5% renamed `ENSG..._<NAME>`), 100 are
    not in the model, and the gene order is permuted."""
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.sim import simulate_topic

    held = simulate_topic(rows=2100, cols=100_000, factors=8, batches=2, seed=seed)
    rng = np.random.default_rng(seed)
    names = list(sim_rows) + [f"NEW{i}" for i in range(100)]
    for i in rng.choice(2000, 100, replace=False):
        names[i] = f"ENSG{i:011d}_{names[i].upper()}"
    perm = rng.permutation(2100)
    vec = SparseIoVec()
    vec.push(MemoryBackend(held.counts.tocsr()[perm].tocsc(), [names[i] for i in perm],
                           held.col_names))
    return vec, held.batch


def layout_phase(work: str, zp: np.ndarray, topic_out: str, K, dev, card: str) -> dict:
    """Phase 11: `senna layout` (umap, tumap, tsne, phate, tree), `senna
    pseudotime` (both modes), `senna plot` and `senna plot-topic` through
    the port's CLI on the card, the card against the port's CPU run on
    3,000 of the cells, and umap's neighbour preservation. Returns the
    launches of the four kernels per command (none is on these paths)."""
    from legume_tpu_torch.cli.main import main as cli
    from legume_tpu_torch.ops import layouts as LY
    from legume_tpu_torch.ops import principal_graph as PG
    from legume_tpu_torch.ops import rounding
    from legume_tpu_torch.ops import umap as U
    from legume_tpu_torch.ops.knn import knn_search, knn_within
    from legume_tpu_torch.utils.manifest import RunManifest
    from legume_tpu_torch.utils.output import read_table, table_path, write_table

    pred = f"{work}/predict"
    latent = table_path(f"{pred}.latent")
    cols = read_table(latent)
    names = list(cols)
    zl = np.exp(zp.astype(np.float32))  # the linear simplex the handlers lay out
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    print(json.dumps({"phase": "layout_setup", "matplotlib_importable": has_mpl}), flush=True)

    def subset(stem, n):
        return write_table(f"{work}/{stem}", {k: v[:n] for k, v in cols.items()})

    lat10k, lat2k, lat1k = subset("lat10k", 10_000), subset("lat2k", 2_000), subset("lat1k", 1_000)
    # velocity: toward each cell's kNN neighbours of higher topic-0 share
    _, nbr = knn_within(zl, 15, device=dev)
    up = (zl[nbr, 0] > zl[:, None, 0])[..., None]
    vel = ((zl[nbr] - zl[:, None, :]) * up).sum(1) / np.maximum(up.sum(1), 1)
    vel_path = write_table(f"{work}/velocity", {"cell": cols[names[0]],
                                                **{f"v{j}": vel[:, j] for j in range(vel.shape[1])}})

    runs = {}
    launches = {}

    def run(name, *argv, out=None):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        cli(["senna", *argv, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[name] = sum(K.launch_counts.values())
        timings = RunManifest.load(f"{out}.senna.json").timings if out else {}
        runs[name] = {"wall_s": wall, **timings,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps({"phase": "layout_command", "command": name, **runs[name],
                          "kernel_launches": launches[name], "card": card}), flush=True)

    run("clustering_kmeans_from", "clustering", "--from", pred, "--out", f"{work}/km2",
        "--method", "kmeans", "--n-clusters", "10", out=f"{work}/km2")
    run("layout_tumap_pcs5", "layout", "--latent", latent, "--out", f"{work}/tumap",
        "--method", "tumap", "--pcs", "5", out=f"{work}/tumap")
    run("layout_umap", "layout", "--from", pred, "--out", f"{work}/umap", out=f"{work}/umap")
    run("layout_tsne_10k", "layout", "--latent", lat10k, "--out", f"{work}/tsne",
        "--method", "tsne", out=f"{work}/tsne")
    run("layout_phate_2k", "layout", "--latent", lat2k, "--out", f"{work}/phate",
        "--method", "phate", out=f"{work}/phate")
    run("pseudotime", "pseudotime", "--latent", latent, "--out", f"{work}/pt", "--root-cell", "0",
        out=f"{work}/pt")
    run("layout_tree", "layout", "--method", "tree", "--from", f"{work}/pt", "--out",
        f"{work}/tree")
    runs["layout_tree"].update({k: v for k, v in RunManifest.load(f"{work}/pt.senna.json")
                                .timings.items() if k.startswith("tree_")})
    run("pseudotime_velocity", "pseudotime", "--latent", latent, "--velocity", vel_path,
        "--out", f"{work}/ptv", out=f"{work}/ptv")
    if has_mpl:
        run("plot_from", "plot", "--from", pred, "--out", f"{work}/plot.png")
        dictionary = RunManifest.load(f"{topic_out}.senna.json").outputs["dictionary"]
        run("plot_topic_1k", "plot-topic", "--latent", lat1k, "--dictionary", dictionary,
            "--clusters", table_path(f"{work}/km2.clusters"), "--out", f"{work}/topics.png")
        for f in ("plot.png", "topics.png", "topics.png.top_genes.tsv",
                  "topics.png.dict_hinton.png"):
            if not Path(f"{work}/{f}").stat().st_size:
                raise AssertionError(f"plot output {f} is empty")

    layouts = {}
    for name in ("umap", "tumap", "tsne", "phate", "tree"):
        stem = f"{work}/{name}.tree_layout.cell_coords" if name == "tree" else f"{work}/{name}.layout"
        t = read_table(table_path(stem))
        layouts[name] = np.stack([t["x"], t["y"]], 1)
    want = {"umap": len(zl), "tumap": len(zl), "tsne": min(len(zl), 10_000),
            "phate": min(len(zl), 2_000), "tree": len(zl)}
    finite = {k: float(np.isfinite(v).all(1).mean()) for k, v in layouts.items()}
    pman = RunManifest.load(f"{pred}.senna.json")
    ptab = read_table(table_path(f"{work}/pt.pseudotime"))
    vtab = read_table(table_path(f"{work}/ptv.pseudotime"))

    # umap's neighbour preservation over 5,000 sampled cells
    rng = np.random.default_rng(0)
    sample = rng.choice(len(zl), min(len(zl), 5000), replace=False)

    def neighbours(points):
        _, idx = knn_search(points[sample], points, 16, device=dev)
        return [row[row != c][:15] for row, c in zip(idx, sample)]

    lat_nb, lay_nb = neighbours(zl), neighbours(layouts["umap"].astype(np.float32))
    preserved = float(np.mean([len(np.intersect1d(a, b)) / 15 for a, b in zip(lat_nb, lay_nb)]))

    # the card against the port's CPU run on the same 3,000 cells
    x3 = np.ascontiguousarray(zl[:3000])
    src, dst, w = U.fuzzy_edges(x3, 15, device="cpu")
    a, b = U._fit_ab(0.1, 1.0)
    xc = x3 - x3.mean(0)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    emb0 = U.init_2d_from_scores(u[:, :2] * s[:2], 0)
    sgd = dict(n_steps=50, batch=4096, n_points=3000, a=a, b=b)
    probs = w / w.sum()
    u_card = U._umap_sgd(0, emb0, src, dst, probs, device=dev, **sgd)
    u_again = U._umap_sgd(0, emb0, src, dst, probs, device=dev, **sgd)
    u_cpu = U._umap_sgd(0, emb0, src, dst, probs, device="cpu", **sgd)
    t_card = LY.tsne(x3, n_iter=50, device=dev)
    t_cpu = LY.tsne(x3, n_iter=50, device="cpu")
    pd_card, y0 = LY.phate_init(x3, knn=15, device=dev)
    d2_card = rounding.sq_dists(torch.as_tensor(x3).to(dev), fused=False).cpu()
    d2_cpu = rounding.sq_dists(torch.as_tensor(x3), fused=False)
    p_card = LY.phate_refine(pd_card, y0, n_iter=200, device=dev)
    p_cpu = LY.phate_refine(pd_card, y0, n_iter=200, device="cpu")
    g_card = PG.pseudotime(x3, root_cell=0, device=dev)
    g_cpu = PG.pseudotime(x3, root_cell=0, device="cpu")
    vs_cpu = {
        "umap_50_steps": float(np.abs(u_card - u_cpu).max()),
        "umap_scale": float(np.abs(u_cpu).max()),
        "umap_rerun_bit_equal": bool(np.array_equal(u_card, u_again)),
        "umap_bit_equal_to_cpu": bool(np.array_equal(u_card, u_cpu)),
        "tsne_50_iterations": float(np.abs(t_card - t_cpu).max()),
        "tsne_scale": float(np.abs(t_cpu).max()),
        "phate_sq_dists_bit_equal": bool(torch.equal(d2_card, d2_cpu)),
        "phate_refine_200": float(np.abs(p_card - p_cpu).max()),
        "pseudotime_nodes": float(np.abs(g_card.nodes - g_cpu.nodes).max()),
        "pseudotime_tree_equal": bool(np.array_equal(g_card.edges, g_cpu.edges)),
        "pseudotime_cell_to_node_differ": int((g_card.cell_to_node != g_cpu.cell_to_node).sum()),
        "pseudotime_branch_differ": int((g_card.branch != g_cpu.branch).sum()),
        "pseudotime_root_equal": g_card.root == g_cpu.root,
        "pseudotime_values": float(np.abs(g_card.pseudotime - g_cpu.pseudotime).max()),
    }
    print(json.dumps({
        "phase": "layout_pseudotime_plot", "cells": len(zl), "runs": runs,
        "finite_share": finite, "umap_neighbour_preservation_15": preserved,
        "manifest_layout": pman.outputs.get("layout"), "manifest_clusters": pman.outputs.get("clusters"),
        "pseudotime_range": [float(ptab["pseudotime"].min()), float(ptab["pseudotime"].max())],
        "branches": int(len(np.unique(ptab["branch"]))),
        "velocity_consistency_positive": float((vtab["consistency"] > 0).mean()),
        "card_vs_cpu_3000": vs_cpu, "card": card,
    }), flush=True)
    for k, v in layouts.items():
        if v.shape != (want[k], 2) or finite[k] < (0.9 if k == "tree" else 1.0):
            raise AssertionError(f"layout {k}: shape {v.shape}, finite share {finite[k]}")
    if not (pman.outputs.get("layout", "").endswith(("umap.layout.parquet", "umap.layout.npz"))
            and pman.outputs.get("clusters")):
        raise AssertionError(f"predict manifest lacks the layout or clusters: {pman.outputs}")
    if not np.isfinite(ptab["pseudotime"]).all() or not np.isfinite(vtab["pseudotime"]).all():
        raise AssertionError("pseudotime is not finite")
    if any(launches.values()):
        raise AssertionError(f"a layout command launched a kernel: {launches}")
    if not vs_cpu["umap_rerun_bit_equal"]:
        raise AssertionError("two card runs of umap differ")
    if not vs_cpu["umap_50_steps"] <= 1e-3:
        raise AssertionError(f"umap card vs CPU {vs_cpu['umap_50_steps']} > 1e-3")
    if not vs_cpu["tsne_50_iterations"] <= 1e-3:
        raise AssertionError(f"tsne card vs CPU {vs_cpu['tsne_50_iterations']} > 1e-3")
    if not (vs_cpu["phate_sq_dists_bit_equal"] and vs_cpu["phate_refine_200"] <= 1e-3):
        raise AssertionError(f"phate card vs CPU: {vs_cpu}")
    if not (vs_cpu["pseudotime_nodes"] <= 1e-4 and vs_cpu["pseudotime_tree_equal"]
            and vs_cpu["pseudotime_root_equal"] and vs_cpu["pseudotime_cell_to_node_differ"] == 0
            and vs_cpu["pseudotime_branch_differ"] == 0):
        raise AssertionError(f"pseudotime card vs CPU: {vs_cpu}")
    return launches


def decoder_forward_and_grads(name, x, log_z, fw, device) -> tuple[torch.Tensor, dict]:
    """llik [N] and the gradients of sum(llik) (every parameter and log z)
    of a seeded decoder of family `name` on `device`."""
    from legume_tpu_torch.models.decoders import DECODERS

    kw = dict(rho_prior_weight=10.0) if name == "nb-mixture" else {}
    dec = DECODERS[name](x.shape[1], log_z.shape[1], generator=torch.Generator().manual_seed(4), **kw)
    with torch.no_grad():  # the nuisance parameters off their constant inits
        g = torch.Generator().manual_seed(5)
        for pname, p in dec.named_parameters():
            if pname != "dictionary":
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    dec = dec.to(device)
    lz = torch.from_numpy(log_z).to(device).requires_grad_(True)
    _, llik = dec(lz, torch.from_numpy(x).to(device), torch.from_numpy(fw).to(device)[None, :])
    llik.sum().backward()
    grads = {n: p.grad.cpu() for n, p in dec.named_parameters()}
    grads["log_z"] = lz.grad.cpu()
    return llik.detach().cpu(), grads


def topic_options_phase(work: str, sim, vec, topic_out: str, base_levels, held_sub, K, dev,
                        card: str) -> dict:
    """Phase 12: the `senna topic` options through the port's CLI entry
    point on phase 2's cells (the JAX package's default `TopicArgs`, 5
    epochs), each run's kernel counts zeroed just before and read just
    after. Returns each kernel's launches summed over the phase's runs."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.qc import compute_cell_qc
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.utils.output import read_table, table_path

    # the same cells, with 13 genes named MT- so that QC's mito fraction is not all zero
    names = [f"MT-{g}" if i < 13 else g for i, g in enumerate(sim.row_names)]
    mt = SparseIoVec()
    mt.push(MemoryBackend(sim.counts, names, sim.col_names))
    mt.register_batches(sim.batch.astype(str))
    runs, launches = {}, {}

    def topic(name, data, *argv):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(["topic", "--out", f"{work}/{name}", "--epochs", "5", *argv,
                         "--device", "cuda"], vec=data)
        torch.cuda.synchronize()
        launches[name] = dict(K.launch_counts)
        runs[name] = {"argv": list(argv), "wall_s": time.time() - t0, **res["timings"],
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "launches": launches[name], "cells": len(res["latent"]),
                      "groups_per_level": res["levels"].num_groups_per_level,
                      "llik": [float(v) for v in res["scores"].llik]}
        print(json.dumps({"phase": "topic_options_run", "run": name, **runs[name], "card": card}),
              flush=True)
        if launches[name]["project_normed"] == 0 or launches[name]["collapse"] == 0:
            raise AssertionError(f"{name}: the topic run skipped K1 or K3: {launches[name]}")
        z = res["latent"]
        err = float(np.abs(np.exp(z.astype(np.float64)).sum(1) - 1.0).max())
        if not (np.isfinite(z).all() and err <= 1e-3 and np.isfinite(res["scores"].llik).all()):
            raise AssertionError(f"{name}: the latent is not a finite simplex ({err}) or the "
                                 "llik is not finite")
        return res

    # 1. the reference's default decoder and QC
    md = topic("opt_multi", mt, "--decoder", "nb-mixture,multinomial", "--decoder-weights", "1",
               "0.5", "--rho-prior-weight", "10", "--max-coarse-features", "1000", "--qc",
               "--qc-max-mito-frac", "0.2")
    stem = f"{work}/opt_multi"
    tables = {s: table_path(f"{stem}.{s}") for s in (
        "dictionary", "nb-mixture.dictionary", "multinomial.dictionary", "nb-mixture.dispersion",
        "nb-mixture.alpha", "nb-mixture.rho", "qc")}
    missing = [s for s, path in tables.items() if path is None]
    if missing:
        raise AssertionError(f"the multi-decoder run lacks {missing}")
    qc = read_table(tables["qc"])
    alpha = read_table(tables["nb-mixture.alpha"])["alpha"]
    phi = read_table(tables["nb-mixture.dispersion"])["dispersion"]
    col_sums = {}
    for s in ("dictionary", "nb-mixture.dictionary", "multinomial.dictionary"):
        t = read_table(tables[s])
        beta = np.exp(np.stack([t[f"topic{k}"] for k in range(10)], 1).astype(np.float64))
        col_sums[s] = float(np.abs(beta.sum(0) - 1.0).max())
    multi = {
        "cells": int(len(qc["keep"])), "cells_kept": int(qc["keep"].sum()),
        "mito_frac_max": float(qc["mito_frac"].max()),
        "coarse_features_per_level": [fc.num_coarse for fc in md["coarsenings"]],
        "alpha_sum": float(alpha.sum()), "dispersion_min": float(phi.min()),
        "dictionary_col_sum_max_err": col_sums,
        "rho": dict(zip(read_table(tables["nb-mixture.rho"])["coef"].tolist(),
                        read_table(tables["nb-mixture.rho"])["value"].tolist())),
    }
    if not (abs(multi["alpha_sum"] - 1.0) <= 1e-4 and (phi > 0).all() and len(phi) == len(names)
            and max(col_sums.values()) <= 1e-3 and multi["cells_kept"] == len(md["latent"])):
        raise AssertionError(f"the multi-decoder run's artifacts: {multi}")

    # 2. poisson on phase 2's partition
    fr = topic("opt_from", vec, "--decoder", "poisson", "--from", topic_out)
    same = bool(np.array_equal(fr["levels"].groups_per_level[0], base_levels.groups_per_level[0])
                and len(fr["levels"].level_maps) == len(base_levels.level_maps)
                and all(np.array_equal(a, b) for a, b in zip(fr["levels"].level_maps,
                                                             base_levels.level_maps)))
    if not same or "sort_refine_s" in fr["timings"]:
        raise AssertionError("--from did not reuse phase 2's partition exactly, or sorted again")

    # 3. warm start from phase 2's model; a mismatched K raises
    topic("opt_init", vec, "--init-from", topic_out)
    try:
        run_senna(["topic", "--out", f"{work}/opt_init_k5", "--init-from", topic_out, "-k", "5",
                   "--device", "cuda"], vec=vec)
    except ValueError as e:
        mismatch = str(e)[:80]
    else:
        raise AssertionError("--init-from with a mismatched -k ran")

    # 4. predict with run 1's model on 10,000 held-out cells
    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=stem, out=f"{work}/opt_predict"), vec=held_sub,
                         device=dev)
    torch.cuda.synchronize()
    launches["opt_predict"] = dict(K.launch_counts)
    p_err = float(np.abs(np.exp(zp.astype(np.float64)).sum(1) - 1.0).max())
    predict = {"cells": len(zp), "run_s": time.time() - t0, "simplex_max_err": p_err,
               "launches": launches["opt_predict"]}
    if not (np.isfinite(zp).all() and p_err <= 1e-3):
        raise AssertionError(f"predict with the multi-decoder model: {predict}")

    # 5. card against CPU on the first 4,096 cells: each new family's
    # llik and gradients (normwise, relative 1e-5), QC's statistics exact
    first = SparseIoVec()
    first.push(MemoryBackend(mt.read_columns_csc(np.arange(4096)), names))
    x = np.ascontiguousarray(first.read_columns_csc(np.arange(4096)).T.toarray(), np.float32)
    rng = np.random.default_rng(12)
    log_z = np.log(rng.dirichlet(np.ones(10), 4096)).astype(np.float32)
    fw = rng.uniform(0.2, 1.0, x.shape[1]).astype(np.float32)
    vs_cpu = {}
    for fam in ("multinomial", "poisson", "nb-mixture"):
        gl, gg = decoder_forward_and_grads(fam, x, log_z, fw, dev)
        cl, cg = decoder_forward_and_grads(fam, x, log_z, fw, "cpu")
        vs_cpu[fam] = {"llik": float((gl - cl).abs().max()) / float(cl.abs().max()),
                       **{k: float((gg[k] - cg[k]).abs().max()) / float(cg[k].abs().max())
                          for k in cg}}
    qg = compute_cell_qc(first, device=dev)
    qcpu = compute_cell_qc(first, device="cpu")
    qc_equal = {f: bool(np.array_equal(getattr(qg, f), getattr(qcpu, f)))
                for f in ("total", "n_genes", "mito_frac")}
    print(json.dumps({
        "phase": "topic_options", "multi_decoder": multi, "from_same_partition": same,
        "init_from_mismatch": mismatch, "predict": predict,
        "card_vs_cpu_4096": {"decoders_normwise_rel": vs_cpu, "qc_equal": qc_equal},
        "card": card,
    }), flush=True)
    bad = {f: v for f, d in vs_cpu.items() for k, v in d.items() if not v <= 1e-5}
    if bad or not all(qc_equal.values()):
        raise AssertionError(f"card against CPU: decoders {bad}, qc {qc_equal}")
    names_k = sorted({k for counts in launches.values() for k in counts})
    return {k: sum(counts.get(k, 0) for counts in launches.values()) for k in names_k}


def _launched(K, need: tuple, what: str) -> dict:
    got = dict(K.launch_counts)
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"{what} launched none of {missing}: {got}")
    return got


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def dev32(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def bge_options_phase(work: str, bvec, bres, acounts, a32, K, dev, card: str, checks: dict,
                      keep: dict) -> dict:
    """Phases 13a-13d: `senna bge --multiome`, `--posterior`, `pb_gibbs`
    at the NCE anchor and `gene_chunk`. K4 is held against its plain
    version at the multiome run's own planes (rows added to `checks`).
    The multiome backends stay in `keep["multiome"]` for phases 18-19.
    Returns each run's launches."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, multiome_vec, run_bge
    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.data.sim import simulate_multiome
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.embedding.nce import NceConfig, _neg_marginal, fit_bge
    from legume_tpu_torch.embedding.posterior import pb_gibbs
    from legume_tpu_torch.ops.random_projection import block_to_device
    from legume_tpu_torch.ops.sparse import col_ids_from_ptr, densify_block

    out = {}
    # ---- 13a: --multiome on 50,000 cells x (2,000 genes + 4,000 peaks)
    t0 = time.time()
    ms = simulate_multiome(genes=2000, peaks=4000, cols=50_000, seed=13)
    (n_genes, n_cells), n_peaks = ms.rna.shape, ms.atac.shape[0]
    cells = [f"cell{j}" for j in range(n_cells)]
    rna = MemoryBackend(ms.rna, [f"g{i}" for i in range(n_genes)], cells)
    atac = MemoryBackend(ms.atac, [f"p{i}" for i in range(n_peaks)], cells)
    sim_s = time.time() - t0
    margs = BgeArgs(multiome=True, skip_etm=True, out=f"{work}/multiome")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    mres = run_bge(margs, backends=[rna, atac], device=dev)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    out["multiome"] = _launched(K, ("project_normed", "collapse", "nce_epoch"), "bge --multiome")
    fe, lat = mres["feature_embedding"], mres["latent"]
    print(json.dumps({
        "phase": "bge_multiome", "cells": n_cells, "genes": n_genes, "peaks": n_peaks,
        "d": int(fe.shape[0]), "nnz": int(ms.rna.nnz + ms.atac.nnz), "simulate_s": sim_s,
        "run_s": run_s, **mres["timings"], "launches": out["multiome"],
        "groups": mres["num_groups"], "phase1_losses": mres["phase1_losses"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)
    if fe.shape != (n_genes + n_peaks, margs.embed_dim) or not np.isfinite(fe).all():
        raise AssertionError(f"multiome feature embedding {fe.shape} or not finite")
    if lat.shape != (n_cells, margs.embed_dim) or not np.isfinite(lat).all():
        raise AssertionError("multiome latent is not finite or has the wrong shape")
    if not mres["phase1_losses"][-1] < mres["phase1_losses"][0]:
        raise AssertionError(f"multiome phase-1 loss did not fall: {mres['phase1_losses']}")
    # K4 at the multiome planes: phase 1's [groups, 6,000] plane in the full
    # form, and the first phase-2 block (2,048 cells of the stacked axes)
    # in the axis form that phase 2 runs, each with the run's trained sides
    fit, pb = mres["result"], mres["pb"]
    pb_t, q_pb = dev32(pb, dev), dev32(_neg_marginal(pb, NceConfig.neg_alpha), dev)
    e_f, b_f = dev32(fit.e_feat, dev), dev32(fit.b_feat, dev)
    mvec = multiome_vec([rna, atac], margs.bridge_weight)
    blk = next(iter(visit_columns_by_block(mvec, block_size=NceConfig.cell_batch)))
    r, pt, v = block_to_device(blk, dev)
    x = densify_block(r, col_ids_from_ptr(pt), v, ncols=blk.ncols, num_genes=mvec.num_rows)
    nb = blk.ncols
    rows = [
        check_nce(K, pb_t, q_pb, e_f, b_f, dev32(fit.pb_embeddings[0], dev),
                  dev32(fit.pb_biases[0], dev), pb_t.sum(1), shape="multiome_phase1_plane"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="multiome_phase2_block_axis", need_feat=False),
    ]
    n_axis = out["multiome"]["nce_epoch_axis"]
    rows[0]["launches_in_e2e"] = out["multiome"]["nce_epoch"] - n_axis
    rows[1]["launches_in_e2e"] = n_axis
    for row in rows:
        row["path"] = "bge_multiome"
        print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    checks["nce_epoch"].extend(rows)
    keep["multiome"] = (rna, atac)
    del ms, mres, mvec, x, pb_t

    # ---- 13b: --posterior 45 on phase 5's cells
    pargs = BgeArgs(posterior=45, skip_etm=True, out=f"{work}/bge_post")
    K.reset_launch_counts()
    t0 = time.time()
    pres = run_bge(pargs, vec=bvec, device=dev)
    torch.cuda.synchronize()
    out["posterior"] = _launched(K, ("project_normed", "collapse", "nce_epoch"), "bge --posterior")
    post = pres["posterior"]
    print(json.dumps({
        "phase": "bge_posterior", "cells": bvec.num_columns, "pb": list(pres["pb"].shape),
        "sweeps": 45, "burnin": 11, "run_s": time.time() - t0,
        "posterior_s": pres["timings"]["posterior_s"], "launches": out["posterior"],
        "pip_mean": float(post.pip.mean()), "rhat_max": float(post.rhat.max()), "card": card,
    }), flush=True)
    if not (np.isfinite(post.pip).all() and np.isfinite(post.rhat).all()
            and ((post.pip >= 0) & (post.pip <= 1)).all()):
        raise AssertionError("posterior pip or rhat not finite, or pip outside [0, 1]")

    # ---- 13c: pb_gibbs at the NCE anchor from phase 6's f32 fit
    stats: dict = {}
    t0 = time.time()
    apost = pb_gibbs(acounts, a32.e_feat, a32.b_feat, a32.pb_embeddings[0],
                     np.zeros(acounts.shape[0]), n_sweeps=45, burnin=11, device=dev, stats=stats)
    torch.cuda.synchronize()
    gibbs_s = time.time() - t0
    print(json.dumps({
        "phase": "pb_gibbs_anchor", "rows": acounts.shape[0], "genes": acounts.shape[1], "h": 16,
        "sweeps": 45, "burnin": 11, "seconds": gibbs_s, "seconds_per_sweep": gibbs_s / 56,
        "ess_steps": stats["ess_steps"], "ess_shrink_iters": stats["ess_iters"],
        "ess_iters_per_step": stats["ess_iters"] / stats["ess_steps"],
        "pip_mean": float(apost.pip.mean()), "rhat_median": float(np.median(apost.rhat)),
        "card": card,
    }), flush=True)
    if not (np.isfinite(apost.pip).all() and np.isfinite(apost.e_feat_mean).all()
            and np.isfinite(apost.sigma2_trace).all()):
        raise AssertionError("anchor posterior not finite")

    # ---- 13d: gene_chunk = 512 against the dense run on phase 5's plane
    pb = bres["pb"]
    runs = {}
    for chunk in (512, 0):
        K.reset_launch_counts()
        t0 = time.time()
        r = fit_bge([pb], config=NceConfig(epochs=500, gene_chunk=chunk), device=dev)
        torch.cuda.synchronize()
        runs[chunk] = (r, time.time() - t0, K.launch_counts["nce_epoch"])
    l_c, l_d = runs[512][0].phase1_losses, runs[0][0].phase1_losses
    rel = float(np.max(np.abs(np.asarray(l_c) - l_d) / np.abs(l_d)))
    print(json.dumps({
        "phase": "gene_chunk", "pb": list(pb.shape), "epochs": 500, "gene_chunk": 512,
        "chunked_s": runs[512][1], "dense_s": runs[0][1], "k4_launches_chunked": runs[512][2],
        "k4_launches_dense": runs[0][2], "losses_rel_err_max": rel, "losses": l_c, "card": card,
    }), flush=True)
    if len(l_c) != 10 or rel > 1e-4:
        raise AssertionError(f"gene_chunk losses {l_c} against dense {l_d}: {rel}")
    if runs[512][2] != 0:
        raise AssertionError("gene_chunk > 0 launched K4; it takes the chunked loss")
    return out


def rest_phase(work: str, vec, K, dev, card: str) -> dict:
    """Phase 14: `senna rest --from` phase 2's topic run and `--runs`
    phase 5's and 13b's bge runs."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import RestArgs, run_rest

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    res = run_rest(RestArgs(from_run=f"{work}/topic", out=f"{work}/rest"), vec=vec, device=dev)
    torch.cuda.synchronize()
    from_s = time.time() - t0
    launches = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    aligned = run_rest(RestArgs(runs=[f"{work}/bge", f"{work}/bge_post"], out=f"{work}/rest_runs"),
                       device=dev)["aligned"]
    runs_s = time.time() - t0
    before = np.linalg.norm(np.asarray(aligned[1]["e_cell"]) - aligned[0]["e_cell"])
    z, losses = res["cell_embedding"], res["losses"]
    print(json.dumps({
        "phase": "senna_rest", "cells": vec.num_columns, "genes": vec.num_rows,
        "h": int(z.shape[1]), "epochs": 400, "from_s": from_s, "fit_s": res["fit_s"],
        "runs_s": runs_s, "losses": losses, "launches": launches, "peak_device_bytes": peak,
        "runs_cell_gap_after": float(before), "card": card,
    }), flush=True)
    if z.shape != (vec.num_columns, 10) or not np.isfinite(z).all():
        raise AssertionError("rest cell embedding not finite or of the wrong shape")
    if not (np.isfinite(res["feature_embedding"]).all() and losses[-1] < losses[0]):
        raise AssertionError(f"rest feature embedding not finite or loss did not fall: {losses}")
    if not all(np.isfinite(r["e_feat"]).all() for r in aligned):
        raise AssertionError("rest --runs gave a non-finite embedding")
    return launches


def _write_lines(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(str(x) for x in lines) + "\n")
    return path


def cocoa_phase(work: str, K, dev, card: str, checks: dict) -> dict:
    """Phase 15: `cocoa simulate-collider` data at 40 individuals x 2,500
    cells, 2,000 genes, 3 types, with a 2.2x amplified block of 100 genes
    in 6 of the 40 individuals; `cocoa diff` at the CLI defaults with the
    types as topics, 12 permutations and the CNV side-channel; `cocoa
    collapse`; K1 and K3 held against their plain versions at the first
    block each run gives them (rows added to `checks`); and on a
    4,000-cell subset the card against the CPU."""
    from legume_tpu_torch.cli.main import run_cocoa
    from legume_tpu_torch.cocoa.diff import CocoaDiffArgs
    from legume_tpu_torch.cocoa.sim import simulate_collider
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis
    import scipy.sparse as sp

    t0 = time.time()
    sim = simulate_collider(n_genes=2000, n_types=3, n_indv=40, cells_per_indv=2500, seed=15)
    y = sim.counts.toarray()
    carriers = np.isin(sim.cell_indv, np.arange(6))
    blk = y[600:700][:, carriers]
    y[600:700, carriers] = blk + np.random.default_rng(15).poisson(1.2 * blk)
    counts = sp.csc_matrix(y)
    del y, blk
    n = counts.shape[1]
    genes = [f"g{i}" for i in range(2000)]
    sim_s = time.time() - t0

    def files(stem, idx):
        _write_lines(f"{stem}.indv.txt", [f"i{v:04d}" for v in sim.cell_indv[idx]])
        _write_lines(f"{stem}.types.txt", [f"t{v}" for v in sim.cell_type[idx]])
        return [f"{stem}.indv.txt", f"{stem}.types.txt"]

    def vec_of(idx):
        v = SparseIoVec()
        v.push(MemoryBackend(counts[:, idx], genes, [f"cell{j}" for j in idx]))
        return v

    _write_lines(f"{work}/exposure.tsv", [f"i{i:04d}\t{int(x)}" for i, x in enumerate(sim.exposure)])
    _write_lines(f"{work}/truth.tsv", ["gene_idx\tchr\tpos"] + [
        f"{i}\t{'chr1' if i < 1000 else 'chr2'}\t{i * 1000 + 500}" for i in range(2000)])

    def diff(stem, idx, device, *extra):
        indv, types = files(stem, idx)
        return run_cocoa(["diff", "--data-files", stem, "--out", f"{stem}.de", "--indv", indv,
                          "--exposure", f"{work}/exposure.tsv", "--topic-assignment", types,
                          "--permutations", "12", "--cnv-ground-truth", f"{work}/truth.tsv",
                          "--device", device, *extra], vec=vec_of(idx))

    full = np.arange(n)
    cvec = vec_of(full)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = diff(f"{work}/collider", full, str(dev))
    torch.cuda.synchronize()
    diff_s = time.time() - t0
    out = {"diff": _launched(K, ("project_normed",), "cocoa diff")}
    cn = res["cnv"]
    car_cols = [i for i, nm in enumerate(cn.sample_names) if int(nm[1:5]) < 6]
    oth_cols = [i for i in range(len(cn.sample_names)) if i not in car_cols]
    in_blk = np.isin(cn.order.ordered, np.arange(600, 700))
    gap = float(cn.cn_score[in_blk][:, car_cols].mean() - cn.cn_score[in_blk][:, oth_cols].mean())
    eff = res["effect"]
    causal = sim.causal_genes
    print(json.dumps({
        "phase": "cocoa_diff", "cells": n, "genes": 2000, "individuals": 40, "topics": 3,
        "permutations": 12, "knn": 10, "pb_samples": 10, "proj_dim": 30, "simulate_s": sim_s,
        "run_s": diff_s, "timings": res["timings"], "launches": out["diff"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "causal_abs_effect": float(np.abs(eff[causal]).mean()),
        "null_abs_effect": float(np.abs(eff[~causal]).mean()),
        "cnv_carrier_block_gap": gap, "card": card,
    }), flush=True)
    if not (np.isfinite(eff).all() and np.isfinite(res["pvalue"]).all()):
        raise AssertionError("cocoa diff effect or p-value not finite")
    if not np.abs(eff[causal]).mean() > np.abs(eff[~causal]).mean():
        raise AssertionError("cocoa diff: causal genes do not stand out")
    if not gap > 0:
        raise AssertionError(f"CNV: the carriers' amplified block does not stand out ({gap})")
    for key in ("projection_s", "match_cache_s", "stat_collect_all_exposures_s",
                "gamma_fit_all_s", "cnv_s"):
        if key not in res["timings"]:
            raise AssertionError(f"cocoa diff timings lack {key}")

    K.reset_launch_counts()
    t0 = time.time()
    col = run_cocoa(["collapse", "--data-files", f"{work}/collider", "--indv",
                     f"{work}/collider.indv.txt", "--out", f"{work}/collapse", "--device",
                     str(dev)], vec=cvec)
    torch.cuda.synchronize()
    out["collapse"] = _launched(K, ("collapse",), "cocoa collapse")
    print(json.dumps({"phase": "cocoa_collapse", "cells": n, "run_s": time.time() - t0,
                      "launches": out["collapse"], "mu_shape": list(col["mu"].shape),
                      "card": card}), flush=True)
    if out["collapse"]["collapse"] != -(-n // 8192):
        raise AssertionError(f"collapse K3 launches {out['collapse']['collapse']}: one a block")
    if col["mu"].shape != (2000, 40) or not np.isfinite(col["mu"]).all():
        raise AssertionError("collapse means not finite or of the wrong shape")

    # K1 at diff's first 8,192-cell block with its basis (K = 30, diff's
    # seed), and K3 at collapse's first block with the 40 individuals as
    # groups (the names `i0000`.. sort as the individuals do)
    blk = next(iter(visit_columns_by_block(cvec, block_size=8192)))
    r, pt, v = block_to_device(blk, dev)
    cargs = CocoaDiffArgs()
    basis = torch.from_numpy(projection_basis(2000, cargs.proj_dim, cargs.seed)).to(dev)
    seg = torch.from_numpy(sim.cell_indv[: blk.ncols].astype(np.int32)).to(dev)
    rows = {
        "project_normed": check_projection(K, basis, r, pt, v, normed=True,
                                           shape="cocoa_diff_block"),
        "collapse": check_collapse(K, r, pt, v, seg, num_genes=2000, num_groups=40,
                                   shape="cocoa_collapse_block"),
    }
    rows["project_normed"].update(launches_in_e2e=out["diff"]["project_normed"], path="cocoa_diff")
    rows["collapse"].update(launches_in_e2e=out["collapse"]["collapse"], path="cocoa_collapse")
    for name, row in rows.items():
        print(json.dumps({"kernel_check": name, "card": card, **row}), flush=True)
        checks[name].append(row)

    # ---- the card against the CPU on 100 cells of each individual. The
    # two runs project through K1 and its plain version (within K1's 2e-4
    # bar), so their caches may part at near-tied neighbours; the caches
    # built from one projection on the card and on the CPU are compared.
    from legume_tpu_torch.cocoa.collapse import build_match_cache

    sub = np.concatenate([np.flatnonzero(sim.cell_indv == i)[:100] for i in range(40)])
    t0 = time.time()
    g = diff(f"{work}/sub", sub, str(dev))
    again = diff(f"{work}/sub", sub, str(dev))
    c = diff(f"{work}/subcpu", sub, "cpu", "--no-match-cache")
    cmp_s = time.time() - t0
    proj = again["proj_nk"]
    proj_err = float(np.abs(g["proj_nk"] - c["proj_nk"]).max())
    proj_bar = RTOL_K1 * float(np.abs(c["proj_nk"]).max())
    caches = [build_match_cache(proj, sim.cell_indv[sub], 40, 10, device=d) for d in (dev, "cpu")]
    x = proj.astype(np.float64)
    rows, cols = np.nonzero(caches[0].idx != caches[1].idx)
    gap = np.abs(np.linalg.norm(x[rows] - x[caches[0].idx[rows, cols]], axis=1)
                 - np.linalg.norm(x[rows] - x[caches[1].idx[rows, cols]], axis=1))
    stat_err = max(_rel_err(getattr(g["stat"], f), getattr(c["stat"], f))
                   for f in ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip"))
    z_err = float(np.abs(g["z"] - c["z"]).max())
    states_equal = bool(np.array_equal(g["cnv"].states, c["cnv"].states))
    print(json.dumps({
        "phase": "cocoa_card_vs_cpu", "cells": len(sub), "seconds": cmp_s,
        "cache_entries_differ_same_projection": int(len(rows)),
        "cache_tie_gap_max": float(gap.max()) if len(gap) else 0.0,
        "cache_entries_differ_e2e": int((g["cache"].idx != c["cache"].idx).sum()),
        "projection_max_abs_diff": proj_err, "projection_bar": proj_bar,
        "stat_rel_err": stat_err, "z_abs_err": z_err, "cnv_states_equal": states_equal,
        "cache_reused": bool(again["timings"].get("match_cache_reused", False)), "card": card,
    }), flush=True)
    if (gap > 1e-5).any() or stat_err > 1e-5 or z_err > 1e-4 or not states_equal \
            or proj_err > proj_bar:
        raise AssertionError("cocoa on the card differs from the CPU")
    if not again["timings"].get("match_cache_reused"):
        raise AssertionError("the second cocoa diff did not reuse the match cache")
    return out


def topic_cnv_phase(work: str, vec, K, dev, card: str) -> dict:
    """Phase 16: `senna topic --cnv --from` phase 2's run."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.utils.output import read_table, table_path

    K.reset_launch_counts()
    t0 = time.time()
    res = run_senna(["topic", "--from", f"{work}/topic", "--out", f"{work}/topic_cnv", "--cnv",
                     "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    launches = _launched(K, ("collapse",), "senna topic --cnv --from")
    cnv = read_table(table_path(f"{work}/topic_cnv.cnv"))
    print(json.dumps({
        "phase": "topic_cnv", "cells": vec.num_columns, "run_s": time.time() - t0,
        "cnv_s": res["timings"]["cnv_s"], "rows": int(len(cnv["state"])),
        "pseudobulks": int(len(np.unique(cnv["pseudobulk"]))),
        "bins": int(len(np.unique(cnv["bin"]))), "launches": launches, "card": card,
    }), flush=True)
    if list(cnv) != ["pseudobulk", "bin", "state", "log_ratio"] or len(np.unique(cnv["bin"])) != 80:
        raise AssertionError(f"topic --cnv table: {list(cnv)}")
    if not (np.isin(cnv["state"], [0, 1, 2]).all() and np.isfinite(cnv["log_ratio"]).all()):
        raise AssertionError("topic --cnv states or log-ratios out of range")
    return launches


# ---- phases 17-20: vae, svd / joint-svd, joint-topic, the masked models ------


def _run_line(name: str, res_timings: dict, t0: float, launches: dict, card: str, **extra) -> dict:
    line = {"phase": name, "run_s": time.time() - t0, "timings": res_timings,
            "launches": launches, "peak_device_bytes": torch.cuda.max_memory_allocated(),
            **extra, "card": card}
    print(json.dumps(line), flush=True)
    return line


def _subset(vec, n: int, with_batches: bool = True):
    """The first `n` cells of `vec` as a vec of their own."""
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec

    sub = SparseIoVec()
    sub.push(MemoryBackend(vec.read_columns_csc(np.arange(n)), vec.row_names(),
                           vec.column_names()[:n]))
    if with_batches and vec.num_batches > 1:
        sub.register_batches(np.asarray(vec.batch_names())[vec.batch_membership()[:n]])
    return sub


def vae_phase(work: str, vec, hvec, held_batch_file: str, K, dev, card: str) -> dict:
    """Phase 17: `senna vae` at the CLI defaults (5 epochs) on phase 2's
    cells, `senna predict` with that model on phase 8's held-out cells,
    `senna topic --decoder gaussian-nb --from` phase 2; on 4,000 cells
    the trained encoder on the card against the CPU (1e-4)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.senna.topic import build_encoder, load_model

    out = {}
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_senna(["vae", "--out", f"{work}/vae", "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    out["vae"] = _launched(K, ("project_normed", "collapse"), "senna vae")
    z, llik = res["latent"], np.asarray(res["scores"].llik)
    _run_line("senna_vae", res["timings"], t0, out["vae"], card, cells=vec.num_columns,
              genes=vec.num_rows, groups_per_level=res["levels"].num_groups_per_level,
              llik=llik.tolist(), latent_shape=list(z.shape))
    if z.shape != (vec.num_columns, 16) or not np.isfinite(z).all():
        raise AssertionError("vae latent not finite or of the wrong shape")
    if not (np.isfinite(llik).all() and llik[-1] > llik[0]):
        raise AssertionError(f"vae llik not finite or not rising: {llik}")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=f"{work}/vae", out=f"{work}/vae_predict",
                                       batch_files=[held_batch_file]), vec=hvec, device=dev)
    torch.cuda.synchronize()
    out["vae_predict"] = dict(K.launch_counts)
    _run_line("senna_predict_vae", {}, t0, out["vae_predict"], card, cells=hvec.num_columns,
              latent_shape=list(zp.shape))
    if zp.shape != (hvec.num_columns, 16) or not np.isfinite(zp).all():
        raise AssertionError("vae predict latent not finite or of the wrong shape")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g = run_senna(["topic", "--from", f"{work}/topic", "--out", f"{work}/topic_gnb", "--decoder",
                   "gaussian-nb", "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    out["topic_gaussian_nb"] = _launched(K, ("project_normed", "collapse"),
                                         "senna topic --decoder gaussian-nb")
    gl = np.asarray(g["scores"].llik)
    _run_line("topic_gaussian_nb", g["timings"], t0, out["topic_gaussian_nb"], card,
              llik=gl.tolist())
    if not (np.isfinite(gl).all() and np.isfinite(g["latent"]).all()):
        raise AssertionError("topic --decoder gaussian-nb: llik or latent not finite")

    # the trained encoder on the first 4,000 cells, card against CPU within
    # 1e-3, phase 8's bar for the topic encoder: the card's float32 latent
    # lies ~2e-4 from the same encoder in float64 (the CPU's ~1e-4; both
    # printed), so a bar of 1e-4 would sit below the card's own rounding
    meta, flat, genes = load_model(f"{work}/vae")
    first = _subset(vec, 4000)
    remap = P.build_gene_remap(genes, first.row_names())
    zs = {d: P.score_dense_backend(first, build_encoder(meta, flat, device=d), remap, device=d)
          for d in (dev, "cpu")}
    x64 = P._dense_block(next(iter(visit_columns_by_block(first, block_size=4096))), remap,
                         "cpu").double()
    with torch.no_grad():
        z64 = build_encoder(meta, flat, device="cpu").double()(x64, train=False)[0].numpy()
    err = float(np.abs(zs[dev] - zs["cpu"]).max())
    card_f64, cpu_f64 = (float(np.abs(zs[d] - z64).max()) for d in (dev, "cpu"))
    print(json.dumps({"phase": "vae_card_vs_cpu", "cells": 4000, "latent_max_abs_err": err,
                      "card_vs_f64": card_f64, "cpu_vs_f64": cpu_f64, "card": card}), flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"vae latent on the card vs the CPU: {err} > 1e-3 (from float64: "
                             f"card {card_f64}, CPU {cpu_f64})")
    return out


def svd_phase(work: str, vec, multiome, K, dev, card: str, checks: dict) -> dict:
    """Phase 18: `senna svd` at its defaults on phase 2's cells (13 K2
    launches, K2 held against its plain version at svd's first block),
    the batch-adjusted counts (written where tensorstore imports, else
    formed on the card), `senna joint-svd` on phase 13a's multiome
    modalities; on 4,000 cells the card against the CPU (factors within
    1e-4 up to sign)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device
    from legume_tpu_torch.senna import svd as S

    out = {}
    can_write = importlib.util.find_spec("tensorstore") is not None
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_senna(["svd", "--data-files", "phase2", "--out", f"{work}/svd", "--device", str(dev),
                     *(["--save-adjusted"] if can_write else [])], vec=vec)
    torch.cuda.synchronize()
    out["svd"] = _launched(K, ("project_normed", "collapse", "project_raw"), "senna svd")
    f = res["factors"]
    adjusted = {"written": can_write}
    if not can_write:  # the writer needs tensorstore: form the matrix on the card instead
        fin = res["levels"].collapsed[0]
        t1 = time.time()
        adj = S.adjusted_csc(vec, fin.mu_residual.mean().cpu().numpy(),
                             res["levels"].groups_per_level[0], device=dev)
        adjusted.update(seconds=time.time() - t1, shape=list(adj.shape), nnz=int(adj.nnz),
                        finite=bool(np.isfinite(adj.data).all()))
        if adj.shape != vec.shape or not np.isfinite(adj.data).all():
            raise AssertionError("svd adjusted matrix not finite or of the wrong shape")
    _run_line("senna_svd", res["timings"], t0, out["svd"], card, cells=vec.num_columns,
              factors_shape=list(f.shape), singular_values=res["singular_values"].tolist(),
              adjusted=adjusted)
    n_blocks = -(-vec.num_columns // 8192)
    if out["svd"]["project_raw"] != n_blocks:
        raise AssertionError(f"svd K2 launches {out['svd']['project_raw']}, one a block ({n_blocks})")
    if f.shape != (vec.num_columns, 20) or not np.isfinite(f).all():
        raise AssertionError("svd factors not finite or of the wrong shape")

    # K2 at svd's first block: log1p values, svd's basis
    blk = next(iter(visit_columns_by_block(vec, block_size=8192)))
    r, pt, v = block_to_device(blk, dev)
    basis = torch.from_numpy(np.ascontiguousarray(res["basis"], np.float32)).to(dev)
    row = check_projection(K, basis, r, pt, torch.log1p(v), normed=False, shape="svd_block")
    row.update(launches_in_e2e=out["svd"]["project_raw"], path="senna_svd")
    print(json.dumps({"kernel_check": "project_raw", "card": card, **row}), flush=True)
    checks["project_raw"].append(row)

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    j = run_senna(["joint-svd", "--data-files", "rna", "--data-files", "atac", "--out",
                   f"{work}/joint_svd", "--device", str(dev)], vecs=list(multiome))
    torch.cuda.synchronize()
    out["joint_svd"] = _launched(K, ("project_normed", "collapse", "project_raw"), "joint-svd")
    _run_line("senna_joint_svd", j["timings"], t0, out["joint_svd"], card,
              cells=multiome[0].num_columns, features=[m.num_rows for m in multiome],
              factors_shape=list(j["factors"].shape))
    d_joint = sum(m.num_rows for m in multiome)
    if not np.isfinite(j["factors"]).all() or j["basis"].shape != (d_joint, 20):
        raise AssertionError(f"joint-svd factors not finite, or the basis is not [{d_joint}, 20]")

    # the batch-matched plane takes each cell's nearest neighbours across
    # batches from the projection, which the card and the CPU give 1e-6
    # apart: at near ties they part (phase 15 saw it in cocoa's cache),
    # so the stages are held without batches and the batched run reported
    vs_cpu = svd_card_vs_cpu(_subset(vec, 4000, with_batches=False), f"{work}/svd4k", dev)
    batched = svd_card_vs_cpu(_subset(vec, 4000), f"{work}/svd4kb", dev)
    print(json.dumps({"phase": "svd_card_vs_cpu", "cells": 4000, **vs_cpu,
                      "with_batches_reported": batched, "card": card}), flush=True)
    if not (vs_cpu["same_partition"] and vs_cpu["plane_max_rel_err"] <= 1e-5
            and vs_cpu["rsvd_held_columns"] and vs_cpu["rsvd_basis_max_abs_err"] <= 1e-4
            and vs_cpu["rsvd_factors_max_rel_err"] <= 1e-4
            and vs_cpu["projection_max_rel_err"] <= 1e-4):
        raise AssertionError(f"svd on the card vs the CPU: {vs_cpu}")
    return out


def svd_card_vs_cpu(first, out: str, dev) -> dict:
    """`fit_svd` on the card and on the CPU, held stage by stage: the
    partition equal and the pseudobulk plane the basis is fitted on
    within 1e-5 (the collapse's bar); the rSVD of the CPU's plane on both
    devices, within 1e-4 by `svd_held_errors`; the per-cell projection of
    the cells through K2 and its plain version with the CPU's basis
    within 1e-4 of each column's largest value. The end-to-end factors'
    distance is reported beside them: the plane's 1e-5 turns components
    whose singular values lie a few percent apart by about its size over
    their gap."""
    from legume_tpu_torch.ops.rsvd import rsvd
    from legume_tpu_torch.senna import svd as S
    from legume_tpu_torch.utils.prng import key_from_seed

    fits = {d: S.fit_svd(S.SvdArgs(out=f"{out}_{d}"), vec=first, device=d) for d in (str(dev), "cpu")}
    g, c = fits[str(dev)], fits["cpu"]
    plane_err = float(np.abs(g["pb_dp"] - c["pb_dp"]).max() / np.abs(c["pb_dp"]).max())
    x = np.log1p(c["pb_dp"])
    k = len(c["singular_values"])
    key = key_from_seed(S.SvdArgs.seed, 23)
    rs = {}
    for d in (str(dev), "cpu"):
        u, sv, _ = rsvd(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(d), k, key=key)
        rs[d] = {"basis": u, "singular_values": sv, "factors": S.project_cells(
            first, u, block_size=8192, device="cpu")}
    held, basis_err, f_err = svd_held_errors(rs[str(dev)], rs["cpu"])
    proj = {d: S.project_cells(first, c["basis"], block_size=8192, device=d)
            for d in (str(dev), "cpu")}
    proj_err = float((np.abs(proj[str(dev)] - proj["cpu"]) / np.abs(proj["cpu"]).max(0)).max())
    e2e_held, e2e_basis, e2e_f = svd_held_errors(g, c)
    knn = {}
    if first.num_batches > 1:  # the matched neighbours, each from its own projection
        from legume_tpu_torch.ops.knn import matched_neighbors_across_batches

        memb = first.batch_membership()
        idx = {d: matched_neighbors_across_batches(fits[d]["levels"].proj_kn.T.copy(), memb,
                                                   first.num_batches, 10, device=d)[0]
               for d in (str(dev), "cpu")}
        same_proj = matched_neighbors_across_batches(c["levels"].proj_kn.T.copy(), memb,
                                                     first.num_batches, 10, device=str(dev))[0]
        knn = {"matched_entries_differ": int((idx[str(dev)] != idx["cpu"]).sum()),
               "matched_entries_differ_same_projection": int((same_proj != idx["cpu"]).sum()),
               "projection_max_abs_diff": float(np.abs(g["levels"].proj_kn
                                                       - c["levels"].proj_kn).max())}
    return {
        "same_partition": bool(np.array_equal(g["levels"].groups_per_level[0],
                                              c["levels"].groups_per_level[0])),
        "plane_max_rel_err": plane_err, "singular_values_cpu": c["singular_values"].tolist(),
        "rsvd_held_columns": held, "rsvd_basis_max_abs_err": basis_err,
        "rsvd_factors_max_rel_err": f_err, "projection_max_rel_err": proj_err,
        "e2e_held_columns": e2e_held, "e2e_basis_max_abs_err": e2e_basis,
        "e2e_factors_max_rel_err": e2e_f, **knn,
    }


def svd_held_errors(got: dict, want: dict, gap: float = 0.05):
    """(held columns, basis error, factor error) of two svd fits. The
    columns group where neighbouring singular values lie within `gap`
    of each other; each group is compared up to its rotation (a sign for
    one column): the basis as U_got A against U_want with A = U_got^T
    U_want over the group, the factors as F_got A against F_want
    relative to each column's largest value. The last group is not held:
    its gap to the components the truncation drops is unknown, and the
    rSVD's trailing vectors follow the QR's rounding."""
    s = want["singular_values"]
    bounds, j = [], 0
    while j < len(s):
        e = j + 1
        while e < len(s) and s[e - 1] - s[e] <= gap * s[e - 1]:
            e += 1
        bounds.append((j, e))
        j = e
    basis_err = f_err = 0.0
    held = []
    for a, b in bounds[:-1]:
        rot = got["basis"][:, a:b].T @ want["basis"][:, a:b]
        basis_err = max(basis_err, float(np.abs(got["basis"][:, a:b] @ rot
                                                - want["basis"][:, a:b]).max()))
        scale = np.abs(want["factors"][:, a:b]).max(0)
        f_err = max(f_err, float((np.abs(got["factors"][:, a:b] @ rot - want["factors"][:, a:b])
                                  / scale).max()))
        held.extend(range(a, b))
    return held, basis_err, f_err


def joint_topic_phase(work: str, multiome, K, dev, card: str) -> dict:
    """Phase 19: `senna joint-topic` at the CLI defaults (5 epochs) on
    phase 13a's RNA and ATAC; `--decoder delta` on the RNA plane and a
    second `simulate_topic` draw of its shape; the trained joint encoder
    on the card against the CPU (1e-5, normwise)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.data.sim import simulate_topic

    out, runs = {}, {}
    rna, _ = multiome
    t0 = time.time()
    second = simulate_topic(rows=rna.num_rows, cols=rna.num_columns, factors=8, batches=1, seed=19)
    sim_s = time.time() - t0
    pairs = {"joint_topic": list(multiome),
             "joint_topic_delta": [rna, MemoryBackend(second.counts)]}
    for name, mods in pairs.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(["joint-topic", *[a for _ in mods for a in ("--data-files", "m")],
                         "--out", f"{work}/{name}", "--epochs", "5", "--device", str(dev),
                         *(["--decoder", "delta"] if name.endswith("delta") else [])], vecs=mods)
        torch.cuda.synchronize()
        out[name] = _launched(K, ("project_normed", "collapse"), name)
        llik = np.asarray(res["scores"].llik)
        _run_line(name, res["timings"], t0, out[name], card, cells=mods[0].num_columns,
                  features=[m.num_rows for m in mods], pseudobulks=int(res["pb_latent"].shape[0]),
                  llik=llik.tolist(), **({"simulate_s": sim_s} if name.endswith("delta") else {}))
        if not (np.isfinite(llik).all() and llik[-1] > llik[0]
                and np.isfinite(res["pb_latent"]).all()):
            raise AssertionError(f"{name}: llik not finite or not rising, or latent not finite")
        runs[name] = res
    errs = {}
    for name, res in runs.items():
        enc = res["trainer"].encoder
        x = res["input"][:4000]
        with torch.no_grad():
            got = enc(torch.from_numpy(x).to(dev), train=False)[0].cpu()
            want = copy.deepcopy(enc).cpu()(torch.from_numpy(x), train=False)[0]
        errs[name] = float((got - want).abs().max() / want.abs().max())
    print(json.dumps({"phase": "joint_topic_card_vs_cpu", "rows": int(min(4000, len(x))),
                      "encoder_normwise_rel_err": errs, "card": card}), flush=True)
    if not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"joint encoder on the card vs the CPU: {errs}")
    return out


def _masked_argv(name: str, out: str, dev, *extra) -> list:
    return [name, "--data-files", "phase2", "--out", out, "--epochs", "5", "--device", str(dev),
            *extra]


def masked_phase(work: str, vec, hvec, K, dev, card: str) -> dict:
    """Phase 20: `masked-topic` at its defaults (5 epochs) on phase 2's
    cells with `--batch-files` (its null stream's collapse takes K1 and
    K3) and `--eval-mask-fraction 0.1`; `masked-vae` and `masked-sbp
    --gene-modules 8` on 20,000 of them; `senna predict` with the
    masked-vae model on phase 8's held-out cells (and the batch-null
    model refused, as the JAX package's predict fails on it); on 4,000
    cells the card against the CPU: windows and unions equal, the encoder
    and `masked_eval_loss` within 1e-5."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.models import indexed as I
    from legume_tpu_torch.senna import predict as P

    out = {}
    bfile = _write_lines(f"{work}/train.batch.txt", np.asarray(vec.batch_names())[
        vec.batch_membership()])
    runs = {}
    sub20 = _subset(vec, 20_000, with_batches=False)
    plan = {
        "masked_topic": (vec, ["--batch-files", bfile, "--eval-mask-fraction", "0.1"],
                         ("project_normed", "collapse")),
        "masked_vae": (sub20, [], ()),
        "masked_sbp": (sub20, ["--gene-modules", "8"], ()),
    }
    for name, (data, extra, need) in plan.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(_masked_argv(name.replace("_", "-"), f"{work}/{name}", dev, *extra), vec=data)
        torch.cuda.synchronize()
        out[name] = _launched(K, need, name)
        trace = np.asarray(res["trace"])
        _run_line(name, res["timings"], t0, out[name], card, cells=data.num_columns,
                  window=128, trace=trace.tolist(), eval_loss=res["eval_loss"])
        if not (np.isfinite(trace).all() and trace[-1] < trace[0]
                and np.isfinite(res["latent"]).all()):
            raise AssertionError(f"{name}: loss not finite or not falling, or latent not finite")
        runs[name] = res
    if runs["masked_topic"]["eval_loss"] is None or not np.isfinite(runs["masked_topic"]["eval_loss"]):
        raise AssertionError("masked-topic: no finite held-out eval loss")

    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=f"{work}/masked_vae", out=f"{work}/masked_predict"),
                         vec=hvec, device=dev)
    torch.cuda.synchronize()
    out["masked_predict"] = dict(K.launch_counts)
    try:
        P.predict_model(P.PredictArgs(model=f"{work}/masked_topic", out=f"{work}/mp_null"),
                        vec=hvec, device=dev)
    except ValueError as e:
        refused = str(e)[:100]
    else:
        raise AssertionError("predict ran a masked model trained with a batch-null stream")
    _run_line("senna_predict_masked", {}, t0, out["masked_predict"], card, cells=hvec.num_columns,
              latent_shape=list(zp.shape), batch_null_model_refused=refused)
    if zp.shape != (hvec.num_columns, 10) or not np.isfinite(zp).all():
        raise AssertionError("masked predict latent not finite or of the wrong shape")

    # card against CPU on the first 4,000 cells with masked-topic's model
    res = runs["masked_topic"]
    first = _subset(vec, 4000)
    card_dev = str(dev)
    win = {d: I.build_topk_windows(first, 128, device=d) for d in (card_dev, "cpu")}
    same_windows = bool(np.array_equal(win[card_dev].ids, win["cpu"].ids)
                        and np.array_equal(win[card_dev].vals, win["cpu"].vals))
    ids = torch.from_numpy(win["cpu"].ids[:256])
    same_union = bool(torch.equal(I.union_ids(ids.to(dev), 4096, vec.num_rows).cpu(),
                                  I.union_ids(ids, 4096, vec.num_rows)))
    data = I.IndexedData(ids=res["data"].ids[:4000], vals=res["data"].vals[:4000],
                         log_q=res["data"].log_q, n_genes=vec.num_rows)
    memb = res["null_membership"][:4000]
    cfg = I.MaskedTrainConfig(minibatch=256, eval_mask_frac=0.1, null_plane=res["null_plane"],
                              null_membership=memb)
    cpu_model = copy.deepcopy(res["model"]).cpu()
    models = ((card_dev, res["model"]), ("cpu", cpu_model))
    z = {d: I.encode_all(m, data, null_plane=res["null_plane"], null_membership=memb, device=d)
         for d, m in models}
    ev = {d: I.masked_eval_loss(m, data, cfg, device=d) for d, m in models}
    # the encoder's log theta held normwise, as the joint encoder's
    # (values reach about -16: a float32 rounding there is 1e-6)
    enc_err = float(np.abs(z[card_dev] - z["cpu"]).max())
    enc_rel = enc_err / float(np.abs(z["cpu"]).max())
    ev_err = abs(ev[card_dev] - ev["cpu"])
    print(json.dumps({"phase": "masked_card_vs_cpu", "cells": 4000, "windows_equal": same_windows,
                      "union_equal": same_union, "encoder_max_abs_err": enc_err,
                      "encoder_normwise_rel_err": enc_rel, "eval_loss": ev,
                      "eval_loss_abs_err": ev_err, "card": card}), flush=True)
    if not (same_windows and same_union and enc_rel <= 1e-5 and ev_err <= 1e-5):
        raise AssertionError(f"masked on the card vs the CPU: windows {same_windows}, union "
                             f"{same_union}, encoder {enc_rel}, eval loss {ev_err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    t_script = time.time()
    work = tempfile.TemporaryDirectory()
    try:
        return run(work.name, t_script)
    finally:
        work.cleanup()


def run(work: str, t_script: float) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")

    from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, run_bge
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.sim import simulate_topic
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.embedding.nce import NceConfig, _neg_marginal, fit_bge
    from legume_tpu_torch.ops import kernels as K
    from legume_tpu_torch.ops.sparse import col_ids_from_ptr, densify_block
    from legume_tpu_torch.ops.collapse import MATCHED_CELL_BLOCK, matched_block
    from legume_tpu_torch.ops.knn import matched_neighbors_across_batches
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis
    from legume_tpu_torch.senna.topic import TopicArgs, fit_topic_model

    dev = torch.device("cuda")

    # ---- phase 1: build --------------------------------------------------
    t0 = time.time()
    reports = K.build_kernels()
    print(json.dumps({"phase": "build", "seconds": time.time() - t0}), flush=True)
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"ptxas": name, "lines": regs}), flush=True)
    card = device_line()
    print(card, flush=True)

    # ---- phase 2: senna topic end to end ---------------------------------
    t0 = time.time()
    sim = simulate_topic(rows=2000, cols=100_000, factors=8, batches=2, seed=42)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    vec.register_batches(sim.batch.astype(str))
    sim_s = time.time() - t0
    args = TopicArgs(epochs=5)
    args.out = f"{work}/topic"  # the model phase 8 predicts with
    K.reset_launch_counts()
    t0 = time.time()
    res = fit_topic_model(args, vec=vec, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches = dict(K.launch_counts)
    z, llik = res["latent"], np.asarray(res["scores"].llik)
    simplex_err = float(np.abs(np.exp(z.astype(np.float64)).sum(1) - 1.0).max())
    e2e = {
        "phase": "senna_topic", "cells": vec.num_columns, "genes": vec.num_rows,
        "nnz": int(sim.counts.nnz), "simulate_s": sim_s, "fit_s": e2e_s,
        **{k: v for k, v in res["timings"].items()},
        "launches": launches, "groups_per_level": res["levels"].num_groups_per_level,
        "llik": llik.tolist(), "latent_shape": list(z.shape), "simplex_max_err": simplex_err,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print(json.dumps(e2e), flush=True)
    if launches["project_normed"] == 0 or launches["collapse"] == 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if z.shape != (vec.num_columns, args.n_latent_topics) or not np.isfinite(z).all():
        raise AssertionError("per-cell latent is not finite or has the wrong shape")
    if simplex_err > 1e-3:
        raise AssertionError(f"per-cell latent is not a simplex: {simplex_err}")
    if not (len(llik) == args.epochs and np.isfinite(llik).all()):
        raise AssertionError("llik trace is not finite")

    # ---- phase 3: kernels against their plain versions -------------------
    # The main path's own calls: its first block of 8,192 cells (K1, and
    # K3's group and batch planes of `collect_basic_stats`) and its first
    # block of matched cells (K3's weighted plane of `collect_matched_stats`).
    levels = res["levels"]
    d_e2e, n_cells = vec.num_rows, vec.num_columns
    blk = next(iter(visit_columns_by_block(vec, block_size=args.block_size)))
    rows, ptr, vals = block_to_device(blk, dev)
    basis = torch.from_numpy(levels.basis_dk).to(dev)
    fine = levels.groups_per_level[0].astype(np.int32)
    n_fine = levels.num_groups_per_level[0]
    batches = vec.batch_membership().astype(np.int32)
    n_batches = vec.num_batches
    seg = torch.from_numpy(fine[: blk.ncols]).to(dev)
    bseg = torch.from_numpy(batches[: blk.ncols]).to(dev)
    m_idx, m_dist, m_valid = matched_neighbors_across_batches(
        levels.proj_kn.T.copy(), batches, n_batches, args.knn_cells, device=dev
    )
    mrows, mptr, mvals, _, mseg = matched_block(
        vec, fine, m_idx, m_dist, m_valid, 0, MATCHED_CELL_BLOCK, device=dev
    )
    # K3 launches of the e2e run by plane: one group and one batch launch
    # per block of 8,192 cells, one matched launch per 1,024 queries
    n_blocks = -(-n_cells // args.block_size)
    plane_launches = {
        "group_plane": n_blocks, "batch_plane": n_blocks,
        "matched_plane": -(-n_cells // MATCHED_CELL_BLOCK),
    }
    if sum(plane_launches.values()) != launches["collapse"]:
        raise AssertionError(f"K3 launches {launches['collapse']} are not {plane_launches}")
    # K = 200 (past the first design's cap of 128): the same block with
    # the port's seeded basis at that width
    wide = torch.from_numpy(projection_basis(d_e2e, 200, 7)).to(dev)
    checks = {
        "project_normed": [
            check_projection(K, basis, rows, ptr, vals, normed=True, shape="e2e_block"),
            check_projection(K, wide, rows, ptr, vals, normed=True, shape="e2e_block_k200"),
        ],
        "project_raw": [
            check_projection(K, basis, rows, ptr, vals, normed=False, shape="e2e_block"),
            check_projection(K, wide, rows, ptr, vals, normed=False, shape="e2e_block_k200"),
        ],
        "collapse": [
            check_collapse(K, rows, ptr, vals, seg, num_genes=d_e2e, num_groups=n_fine,
                           shape="group_plane"),
            check_collapse(K, rows, ptr, vals, bseg, num_genes=d_e2e, num_groups=n_batches,
                           shape="batch_plane"),
            check_collapse(K, mrows, mptr, mvals, mseg, num_genes=d_e2e, num_groups=n_fine,
                           shape="matched_plane"),
        ],
    }
    for row in checks["collapse"]:
        row["launches_in_e2e"] = plane_launches[row["shape"]]
        row["path"] = "senna_topic"
    for name in ("project_normed", "project_raw"):
        for row in checks[name]:
            row["launches_in_e2e"] = launches[name] if row["shape"] == "e2e_block" else 0
            row["path"] = "senna_topic"
    d, pbasis, prows, pptr, pvals, pseg = production_block(dev)
    production = {
        "project_normed": check_projection(K, pbasis, prows, pptr, pvals, normed=True, shape="production"),
        "project_raw": check_projection(K, pbasis, prows, pptr, pvals, normed=False, shape="production"),
        "collapse": check_collapse(K, prows, pptr, pvals, pseg, num_genes=d, num_groups=607,
                                   shape="production"),
    }
    for name, rows_ in checks.items():
        production[name]["launches_in_e2e"] = 0
        production[name]["path"] = "production_shape"
        for row in rows_ + [production[name]]:
            print(json.dumps({"kernel_check": name, "card": card, **row}), flush=True)
        rows_.append(production[name])

    # ---- phase 4: where the trainer's construction spends its time ---------
    probe = subprocess.run(
        [sys.executable, "-c", SETUP_PROBE], capture_output=True, text=True, check=True,
        cwd=Path(__file__).resolve().parent,
    )
    print(probe.stdout.strip().splitlines()[-1], flush=True)

    # ---- phase 5: senna bge end to end -----------------------------------
    # The same simulated cells without their batches: with batches bge
    # takes the stratified marginal, which has no kernel.
    bvec = SparseIoVec()
    bvec.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    bargs = BgeArgs()
    ncfg = NceConfig()
    bargs.out = f"{work}/bge"  # phase 14 aligns these outputs
    before_bytes = torch.cuda.memory_allocated()  # what the topic phase still holds
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    bres = run_bge(bargs, vec=bvec, device=dev)
    torch.cuda.synchronize()
    bge_s = time.time() - t0
    blaunches = dict(K.launch_counts)
    n_blocks2 = -(-bvec.num_columns // ncfg.cell_batch)
    k4_expected = bargs.epochs * 1 + n_blocks2 * ncfg.phase2_epochs
    lat, fe, tl = bres["latent"], bres["feature_embedding"], bres["topic_latent"]
    p1 = bres["phase1_losses"]
    tl_err = float(np.abs(np.exp(tl.astype(np.float64)).sum(1) - 1.0).max())
    print(json.dumps({
        "phase": "senna_bge", "cells": bvec.num_columns, "genes": bvec.num_rows,
        "groups": bres["num_groups"], "topics": int(tl.shape[1]), "run_s": bge_s,
        **bres["timings"], "launches": blaunches, "nce_epoch_expected": k4_expected,
        "phase1_losses": p1, "phase2_losses_first_last": [bres["phase2_losses"][0],
                                                          bres["phase2_losses"][-1]],
        "latent_shape": list(lat.shape), "feature_embedding_shape": list(fe.shape),
        "topic_latent_simplex_max_err": tl_err,
        "device_bytes_before": before_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)
    if min(blaunches["project_normed"], blaunches["collapse"], blaunches["nce_epoch"]) == 0:
        raise AssertionError(f"bge skipped a kernel: {blaunches}")
    if blaunches["collapse"] != -(-bvec.num_columns // 8192):
        raise AssertionError(f"bge K3 launches {blaunches['collapse']}: one per 8,192-cell block")
    if blaunches["nce_epoch"] != k4_expected:
        raise AssertionError(f"K4 launched {blaunches['nce_epoch']} times, expected {k4_expected}")
    if blaunches["nce_epoch_axis"] != n_blocks2 * ncfg.phase2_epochs:
        raise AssertionError(f"K4's axis form launched {blaunches['nce_epoch_axis']} times, "
                             f"expected every phase-2 step ({n_blocks2 * ncfg.phase2_epochs})")
    if lat.shape != (bvec.num_columns, bargs.embed_dim) or not np.isfinite(lat).all():
        raise AssertionError("bge cell latent is not finite or has the wrong shape")
    if fe.shape != (bvec.num_rows, bargs.embed_dim) or not np.isfinite(fe).all():
        raise AssertionError("bge feature embedding is not finite or has the wrong shape")
    if not p1[-1] < p1[0]:
        raise AssertionError(f"bge phase-1 loss did not fall: {p1}")
    if tl_err > 1e-3:
        raise AssertionError(f"bge topic latent is not a log-simplex: {tl_err}")

    # ---- phase 6: phase 1 at the NCE anchor, f32 and bf16 ------------------
    acounts = anchor_counts()
    anchor = {}
    for dt in ("float32", "bfloat16"):
        K.reset_launch_counts()
        t0 = time.time()
        ares = fit_bge([acounts], config=NceConfig(embedding_dim=16, epochs=1000, compute_dtype=dt),
                       device=dev)
        torch.cuda.synchronize()
        anchor[dt] = ares
        print(json.dumps({
            "phase": "nce_anchor", "compute_dtype": dt, "rows": acounts.shape[0],
            "genes": acounts.shape[1], "h": 16, "epochs": 1000, "fit_s": time.time() - t0,
            "phase1_s": ares.timings["phase1_s"], "final_loss": ares.phase1_losses[-1],
            "phase1_losses": ares.phase1_losses, "nce_epoch_launches": K.launch_counts["nce_epoch"],
            "card": card,
        }), flush=True)
        if K.launch_counts["nce_epoch"] != 1000:
            raise AssertionError(f"anchor {dt}: {K.launch_counts['nce_epoch']} K4 launches")
    l32, l16 = anchor["float32"].phase1_losses[-1], anchor["bfloat16"].phase1_losses[-1]
    if not abs(l16 - l32) <= RTOL_BF16_LOSS * abs(l32):
        raise AssertionError(f"anchor bf16 final loss {l16} vs f32 {l32}")

    # ---- phase 7: K4 against its plain version -----------------------------
    # The e2e run's phase-1 plane (its groups x 2,000 genes) with its
    # trained feature side, one of its phase-2 blocks (2,048 cells), and
    # the anchor plane in f32 and bf16 with that run's trained sides; and
    # K3 at the bge run's own group plane.
    fit = bres["result"]
    pb = bres["pb"]
    pb_t = dev32(pb, dev)
    q_pb = dev32(_neg_marginal(pb, ncfg.neg_alpha), dev)
    e_f, b_f = dev32(fit.e_feat, dev), dev32(fit.b_feat, dev)
    n_pb = pb.shape[0]
    blk = next(iter(visit_columns_by_block(bvec, block_size=ncfg.cell_batch)))
    r, pt, v = block_to_device(blk, dev)
    x = densify_block(r, col_ids_from_ptr(pt), v, ncols=blk.ncols, num_genes=bvec.num_rows)
    nb = blk.ncols
    k4 = [
        check_nce(K, pb_t, q_pb, e_f, b_f, dev32(fit.pb_embeddings[0], dev),
                  dev32(fit.pb_biases[0], dev), pb_t.sum(1), shape="e2e_phase1_plane"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="e2e_phase2_block"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="e2e_phase2_block_axis", need_feat=False),
    ]
    # phase 1 takes the full form; phase 2, the feature side frozen, the axis form
    k4[0]["launches_in_e2e"] = bargs.epochs
    k4[1]["launches_in_e2e"] = 0
    k4[2]["launches_in_e2e"] = n_blocks2 * ncfg.phase2_epochs
    for row in k4:
        row["path"] = "senna_bge"
    ac = dev32(acounts, dev)
    anchor_checks = []
    for dt, cdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ares = anchor[dt]
        row = check_nce(
            K, ac.to(cdt), dev32(_neg_marginal(acounts, ncfg.neg_alpha), dev),
            dev32(ares.e_feat, dev), dev32(ares.b_feat, dev),
            dev32(ares.pb_embeddings[0], dev), dev32(ares.pb_biases[0], dev),
            ac.sum(1), shape=f"anchor_{dt}",
        )
        row["launches_in_e2e"] = 0
        row["launches_in_anchor_run"] = 1000
        row["path"] = "nce_anchor"
        anchor_checks.append(row)
    for row in k4 + anchor_checks:
        print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    checks["nce_epoch"] = k4 + anchor_checks
    # K3 in bge: one launch per 8,192-cell block over the sort-dim groups
    cblk = next(iter(visit_columns_by_block(bvec, block_size=8192)))
    cr, cp, cv = block_to_device(cblk, dev)
    cseg = torch.from_numpy(np.asarray(bres["groups"][: cblk.ncols], np.int32)).to(dev)
    row = check_collapse(K, cr, cp, cv, cseg, num_genes=bvec.num_rows,
                         num_groups=bres["num_groups"], shape="bge_group_plane")
    row["launches_in_e2e"] = blaunches["collapse"]
    row["path"] = "senna_bge"
    print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    checks["collapse"].append(row)

    # ---- phase 8: senna predict at full width -----------------------------
    from legume_tpu_torch.data import MemoryBackend as Mem
    from legume_tpu_torch.data import blosc_codec
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.senna.topic import build_model, load_model
    from legume_tpu_torch.utils.manifest import RunManifest
    from legume_tpu_torch.utils.output import have_parquet, read_table, table_path

    t0 = time.time()
    hvec, hbatch = held_out_vec(sim.row_names, seed=43)
    held_sim_s = time.time() - t0
    n_held = hvec.num_columns
    bfile = f"{work}/held.batch.txt"
    Path(bfile).write_text("\n".join(f"donor{'AB'[b]}" for b in hbatch) + "\n")
    pargs = P.PredictArgs(model=args.out, out=f"{work}/predict", batch_files=[bfile],
                          delta_iters=2, refine_steps=10)
    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(pargs, vec=hvec, device=dev)
    torch.cuda.synchronize()
    predict_s = time.time() - t0
    plaunches = dict(K.launch_counts)
    pman = RunManifest.load(f"{work}/predict.senna.json")
    dtab = read_table(table_path(f"{work}/predict.delta"))
    delta = np.stack([dtab[f"batch{b}"] for b in range(2)], 1)
    p_err = float(np.abs(np.exp(zp.astype(np.float64)).sum(1) - 1.0).max())

    # the first 4,096-cell block on the card and on the CPU, same inputs
    meta, flat, genes = load_model(args.out)
    remap = P.build_gene_remap(genes, hvec.row_names())
    cb = P.read_batch_labels([bfile], n_held)
    prof = P._batch_mean_profiles(hvec, remap, cb, block_size=4096)
    log_dict = P._load_log_dictionary(args.out, genes)
    first = SparseIoVec()
    first.push(Mem(hvec.read_columns_csc(np.arange(4096)), hvec.row_names()))
    enc_cpu = build_model(meta, flat, device="cpu")[0]
    enc_dev = build_model(meta, flat, device=dev)[0]
    # Card against CPU within 1e-3, with and without refinement. The
    # encoder's float32 rounding alone moves log z by 1e-4 to 4e-4 at these
    # weights (each float32 run against the same block in float64 on the
    # CPU, printed beside it), so a bar of 1e-4 without refinement would
    # sit below the reference's own error.
    block_err = {}
    for steps in (0, 10):
        kw = dict(block_size=4096, cell_batch=cb[:4096], batch_profiles=prof, log_dict=log_dict,
                  refine_steps=steps)
        z_c = P.score_dense_backend(first, enc_cpu, remap, device="cpu", **kw)
        z_g = P.score_dense_backend(first, enc_dev, remap, device=dev, **kw)
        block_err[steps] = float(np.abs(z_g - z_c).max())
        if steps == 0:
            x64 = P._dense_block(next(iter(visit_columns_by_block(first, block_size=4096))),
                                 remap, "cpu").double()
            with torch.no_grad():
                z64 = enc_cpu.double()(x64, torch.from_numpy(prof[cb[:4096]]).double(),
                                       train=False)[0].numpy()
            enc_cpu.float()
            card_f64, cpu_f64 = float(np.abs(z_g - z64).max()), float(np.abs(z_c - z64).max())
        if not block_err[steps] <= 1e-3:
            raise AssertionError(f"predict block, {steps} refinement steps: card vs CPU "
                                 f"{block_err[steps]} > 1e-3")
    e2e_vs_block = float(np.abs(zp[:4096] - z_g).max())

    sub = SparseIoVec()
    sub.push(Mem(hvec.read_columns_csc(np.arange(10_000)), hvec.row_names()))
    t0 = time.time()
    zd = P.predict_model(P.PredictArgs(model=args.out, out=f"{work}/predict_dec",
                                       decoder_only=True), vec=sub, device=dev)
    torch.cuda.synchronize()
    decoder_only_s = time.time() - t0
    d_err = float(np.abs(np.exp(zd.astype(np.float64)).sum(1) - 1.0).max())

    t0 = time.time()
    resid = P.residual_csc(hvec, zp, log_dict, remap, delta_db=delta, cell_batch=cb, device=dev)
    torch.cuda.synchronize()
    residual_s = time.time() - t0
    writers = {"zarr (tensorstore)": importlib.util.find_spec("tensorstore") is not None,
               "h5 (h5py)": importlib.util.find_spec("h5py") is not None,
               "h5 blosc (libblosc)": blosc_codec.available(),
               "parquet (pandas, pyarrow)": have_parquet()}
    print(json.dumps({
        "phase": "senna_predict", "cells": n_held, "genes": hvec.num_rows,
        "mapped_genes": pman.params["n_mapped"], "simulate_s": held_sim_s, "run_s": predict_s,
        **pman.timings, "launches": plaunches, "delta_min": float(delta.min()),
        "delta_max": float(delta.max()), "latent_shape": list(zp.shape),
        "latent_finite": bool(np.isfinite(zp).all()), "simplex_max_err": p_err,
        "first_block_card_vs_cpu": {"refine_0": block_err[0], "refine_10": block_err[10]},
        "first_block_vs_f64": {"card": card_f64, "cpu": cpu_f64},
        "first_block_e2e_vs_alone": e2e_vs_block,
        "decoder_only": {"cells": sub.num_columns, "run_s": decoder_only_s,
                         "simplex_max_err": d_err, "finite": bool(np.isfinite(zd).all())},
        "residual": {"shape": list(resid.shape), "nnz": int(resid.nnz), "seconds": residual_s,
                     "finite": bool(np.isfinite(resid.data).all())},
        "writers_importable": writers, "card": card,
    }), flush=True)
    if pman.params["n_mapped"] != 2000:
        raise AssertionError(f"predict mapped {pman.params['n_mapped']} of 2,000 genes")
    if not (0.01 <= delta.min() and delta.max() <= 100.0):
        raise AssertionError(f"delta outside [0.01, 100]: {delta.min()}, {delta.max()}")
    if zp.shape != (n_held, args.n_latent_topics) or not np.isfinite(zp).all() or p_err > 1e-3:
        raise AssertionError(f"predict latent is not a finite simplex ({p_err})")
    if not np.isfinite(zd).all() or d_err > 1e-3:
        raise AssertionError(f"decoder-only latent is not a finite simplex ({d_err})")
    if resid.shape != hvec.shape or not np.isfinite(resid.data).all():
        raise AssertionError("residual matrix is not finite or has the wrong shape")

    # ---- phase 9: senna clustering on that latent ---------------------------
    from legume_tpu_torch.ops.hsblock import hsblock_clustering
    from legume_tpu_torch.ops.leiden import knn_adjacency
    from legume_tpu_torch.senna.clustering import ClusteringArgs, cluster_latent, run_clustering

    latent_path = table_path(f"{work}/predict.latent")
    K.reset_launch_counts()
    t0 = time.time()
    km = run_clustering(ClusteringArgs(latent=latent_path, out=f"{work}/km", method="kmeans",
                                       n_clusters=10), vec=hvec, device=dev)
    torch.cuda.synchronize()
    kmeans_bhc_s = time.time() - t0
    claunches = dict(K.launch_counts)
    bhc_blocks = -(-n_held // ClusteringArgs.bhc_block_size)
    cut = read_table(table_path(f"{work}/km.bhc.cut"))
    t0 = time.time()
    hs = run_clustering(ClusteringArgs(latent=latent_path, out=f"{work}/hs", method="hsblock",
                                       hsblock_depth=4), device=dev)
    torch.cuda.synchronize()
    hsblock_s = time.time() - t0
    adj5 = knn_adjacency(np.exp(zp[:5000]), k=15, device=dev)
    hs_card = hsblock_clustering(adj5, max_depth=4, seed=0, device=dev).membership
    hs_cpu = hsblock_clustering(adj5, max_depth=4, seed=0, device="cpu").membership
    t0 = time.time()
    ld = cluster_latent(zp[:20_000], ClusteringArgs(method="leiden"), device=dev)
    leiden_s = time.time() - t0
    print(json.dumps({
        "phase": "senna_clustering", "cells": n_held, "kmeans_bhc_s": kmeans_bhc_s,
        "kmeans_clusters": int(km.max()) + 1, "bhc_consensus_clusters": int(cut["consensus"].max()) + 1,
        "launches": claunches, "collapse_expected": bhc_blocks, "hsblock_s": hsblock_s,
        "hsblock_clusters": int(hs.max()) + 1,
        "hsblock_5000_card_vs_cpu_same_partition": same_partition(hs_card, hs_cpu),
        "hsblock_5000_clusters": [int(hs_card.max()) + 1, int(hs_cpu.max()) + 1],
        "leiden_cells": 20_000, "leiden_s": leiden_s, "leiden_clusters": int(ld.max()) + 1,
        "card": card,
    }), flush=True)
    if claunches["collapse"] != bhc_blocks:
        raise AssertionError(f"BHC K3 launches {claunches['collapse']}, expected {bhc_blocks}")
    if not same_partition(hs_card, hs_cpu):
        raise AssertionError("hsblock on the card and on the CPU gave different partitions")
    # K3 at one BHC plane: the first 4,096-cell block over the k-means labels
    hblk = next(iter(visit_columns_by_block(hvec, block_size=ClusteringArgs.bhc_block_size)))
    hr, hp, hv = block_to_device(hblk, dev)
    hseg = torch.from_numpy(km[: hblk.ncols].astype(np.int32)).to(dev)
    row = check_collapse(K, hr, hp, hv, hseg, num_genes=hvec.num_rows, num_groups=int(km.max()) + 1,
                         shape="bhc_plane")
    row["launches_in_e2e"] = claunches["collapse"]
    row["path"] = "senna_clustering"
    print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    checks["collapse"].append(row)

    # ---- phase 10: the fault-1 report ----------------------------------------
    # phase 2's fine partition on the card against the port's CPU projection
    # and sort of the same cells with the same arguments
    from legume_tpu_torch.ops import random_projection as rp
    from legume_tpu_torch.senna.topic import compute_level_sort_dims

    t0 = time.time()
    _, proj_cpu = rp.project_columns(
        vec, max(args.proj_dim, args.n_latent_topics), block_size=args.block_size,
        batch_membership=batches if n_batches > 1 else None, seed=args.seed, device="cpu",
    )
    codes_cpu = rp.binary_sort_columns(
        proj_cpu, compute_level_sort_dims(args.sort_dim, args.num_levels)[0], seed=args.seed,
        device="cpu",
    )
    print(json.dumps({
        "phase": "fault1_fine_partition", "cells": n_cells, "cpu_s": time.time() - t0,
        "same_set_partition": same_partition(levels.fine_codes, codes_cpu),
        "same_codes": bool(np.array_equal(levels.fine_codes, codes_cpu)),
        "groups_card": int(len(np.unique(levels.fine_codes))),
        "groups_cpu": int(len(np.unique(codes_cpu))),
        "proj_max_abs_diff": float(np.abs(levels.proj_kn - proj_cpu).max()), "card": card,
    }), flush=True)

    # ---- phase 11: senna layout, pseudotime and plot on that latent ---------
    layout_launches = layout_phase(work, zp, args.out, K, dev, card)

    # ---- phase 12: the senna topic options ------------------------------------
    option_launches = topic_options_phase(work, sim, vec, args.out, levels, sub, K, dev, card)

    # ---- phases 13-16: bge options, rest, cocoa, topic --cnv -----------------
    kept: dict = {}
    slice9 = bge_options_phase(work, bvec, bres, acounts, anchor["float32"], K, dev, card, checks,
                               kept)
    slice9["rest"] = rest_phase(work, vec, K, dev, card)
    slice9.update(cocoa_phase(work, K, dev, card, checks))
    slice9["topic_cnv"] = topic_cnv_phase(work, vec, K, dev, card)

    # ---- phases 17-20: vae, svd / joint-svd, joint-topic, masked models ----
    slice10 = vae_phase(work, vec, hvec, bfile, K, dev, card)
    slice10.update(svd_phase(work, vec, kept["multiome"], K, dev, card, checks))
    slice10.update(joint_topic_phase(work, kept["multiome"], K, dev, card))
    slice10.update(masked_phase(work, vec, hvec, K, dev, card))

    # ---- phase 21: the kernels line, then the device line -----------------
    # Each kernel's numbers are those of its main-path shape with the most
    # e2e launches; `max_abs_err` is the largest over its checked shapes,
    # and `shapes` holds every checked shape, each with the run (`path`)
    # whose launches `launches_in_e2e` counts. `launches` is the count of
    # the kernel's own main paths: `senna topic` for K1, `senna svd` for
    # K2, `senna topic` and `senna clustering`'s BHC sums for K3, `senna
    # bge` for K4; `launches_bge` is each kernel's count in bge,
    # `launches_clustering` K3's in clustering, `launches_topic_options`
    # each kernel's count summed over phase 12's runs, and
    # `launches_<path>` its count in each run of phases 13-20 (multiome,
    # posterior, rest, diff, collapse, topic_cnv; vae, vae_predict,
    # topic_gaussian_nb, svd, joint_svd, joint_topic, joint_topic_delta,
    # masked_topic, masked_vae, masked_sbp, masked_predict).
    meta = {
        "project_normed": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:352"),
        "project_raw": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:93"),
        "collapse": ("legume_tpu_torch/csrc/collapse.cu", "legume_tpu/ops/pallas_kernels.py:480"),
        "nce_epoch": ("legume_tpu_torch/csrc/nce_epoch.cu", "legume_tpu/embedding/nce_pallas.py:101"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main = max(checks[name], key=lambda r: r.get("launches_in_e2e", 0))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (blaunches[name] if name == "nce_epoch" else launches[name]
                         + claunches[name] + (slice10["svd"][name] if name == "project_raw" else 0)),
            "launches_bge": blaunches[name],
            "launches_layout_pseudotime_plot": sum(layout_launches.values()),
            "launches_topic_options": option_launches.get(name, 0),
            **{f"launches_{path}": counts[name]
               for path, counts in {**slice9, **slice10}.items()},
            **({"launches_clustering": claunches[name]} if name == "collapse" else {}),
            **({"launches_axis": blaunches["nce_epoch_axis"]} if name == "nce_epoch" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "deterministic": all(r["deterministic"] for r in checks[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        }
        if len(checks[name]) > 1:
            keep = ("shape", "form", "launches_in_e2e", "max_abs_err", "deterministic", "ms",
                    "plain_ms", "bound_ms", "bound_by", "bound_bytes_ms", "bound_ops_ms",
                    "bound_core_ms", "bound_tensor_ms", "library_ms")
            entry["shapes"] = [{"path": r.get("path"), **{k: r[k] for k in keep if k in r}}
                               for r in checks[name]]
        kernels.append(entry)
    print(json.dumps({"phase": "total", "seconds": time.time() - t_script, "card": card}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
