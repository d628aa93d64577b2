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
   1,000 x levels + ceil(N / 2,048) x 100 times, that the latent and the
   feature embedding are finite, that the phase-1 loss fell and that the
   topic latent is a log-simplex;
6. phase 1 of `fit_bge` alone at the NCE anchor (2,627 pseudobulks x
   34,008 genes, H = 16, 1,000 epochs, counts made as `bench.py` makes
   them) in f32 and in bf16; the two final losses agree within 1e-2;
7. hold K4 against its plain version at the e2e phase-1 plane, one e2e
   phase-2 block and the anchor in f32 and bf16, and K3 at the bge run's
   own group plane (its first 8,192-cell block over its sort-dim groups),
   and time both;
8. print one JSON line of all kernels, then the device line last.

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
WARMUP, REPS, ROUNDS = 3, 20, 3

# tolerances: normwise max|kernel - plain| / max|plain| for the
# projections (sums with cancellation), elementwise for the collapse
# (sums of non-negative values)
RTOL_K1, RTOL_K2 = 2e-4, 1e-4
ATOL_K3 = RTOL_K3 = 1e-5
# K4 (tests/test_nce_pallas.py): the loss sum within a relative 2e-5 and
# each gradient normwise, max|kernel - plain| <= 1e-4 * max|plain|
RTOL_K4_LOSS, RTOL_K4_GRAD = 2e-5, 1e-4
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


def check_nce(K, c, q, e_f, b_f, e_a, b_a, m, *, shape: str) -> dict:
    """K4 against its plain version on one plane; `max_abs_err` is the
    largest over the four gradients, the loss is held by its relative
    error."""
    (p, d), h = c.shape, e_f.shape[1]
    got = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0)
    again = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0)
    want = K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0)
    # the loss sum in float64 from the same inputs: how far each float32
    # sum lies from it, in units of the float32 spacing at that value
    exact = float(K.nce_epoch_plain(*(t.double() for t in (c, q, e_f, b_f, e_a, b_a, m)), 5.0)[0])
    torch.cuda.synchronize()
    deterministic = bit_equal(got, again)
    if not deterministic:
        raise AssertionError(f"nce_epoch at {shape}: two launches differ")
    loss_k, loss_p = float(got[0]), float(want[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ulp = float(np.spacing(np.float32(abs(exact))))
    errs = [float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])]
    scales = [float(w.abs().max()) for w in want[1:]]
    ok = all(bool(torch.isfinite(g).all()) for g in got)
    if not (ok and loss_rel <= RTOL_K4_LOSS
            and all(e <= RTOL_K4_GRAD * sc for e, sc in zip(errs, scales))):
        raise AssertionError(f"nce_epoch at {shape}: loss rel {loss_rel}, grads {errs} vs {scales}")
    nbytes = p * d * c.element_size() + 4 * (2 * d * h + 3 * d + 2 * p * h + 3 * p)
    flops = 6 * p * d * h + 20 * p * d
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": shape, "rows": p, "genes": d, "h": h, "count_dtype": str(c.dtype),
        "max_abs_err": max(errs), "max_abs_plain": max(scales), "loss_rel_err": loss_rel,
        "loss_sum": loss_k, "loss_sum_plain": loss_p, "loss_sum_f64": exact, "f32_ulp": ulp,
        "loss_ulps_from_f64": (loss_k - exact) / ulp, "plain_ulps_from_f64": (loss_p - exact) / ulp,
        "rtol_loss": RTOL_K4_LOSS, "rtol_grad": RTOL_K4_GRAD, "deterministic": deterministic,
        # no single torch call computes the loss and the four gradients
        **time_turns(
            ms=lambda: K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0),
            plain_ms=lambda: K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0),
            library_ms=None,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
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
    with tempfile.TemporaryDirectory() as tmp:
        args.out = f"{tmp}/topic"
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
    with tempfile.TemporaryDirectory() as tmp:
        bargs.out = f"{tmp}/bge"
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
    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    fit = bres["result"]
    pb = bres["pb"]
    pb_t = dev32(pb)
    q_pb = dev32(_neg_marginal(pb, ncfg.neg_alpha))
    e_f, b_f = dev32(fit.e_feat), dev32(fit.b_feat)
    n_pb = pb.shape[0]
    blk = next(iter(visit_columns_by_block(bvec, block_size=ncfg.cell_batch)))
    r, pt, v = block_to_device(blk, dev)
    x = densify_block(r, col_ids_from_ptr(pt), v, ncols=blk.ncols, num_genes=bvec.num_rows)
    nb = blk.ncols
    k4 = [
        check_nce(K, pb_t, q_pb, e_f, b_f, dev32(fit.pb_embeddings[0]),
                  dev32(fit.pb_biases[0]), pb_t.sum(1), shape="e2e_phase1_plane"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb]), dev32(fit.b_cell[:nb]),
                  x.sum(1), shape="e2e_phase2_block"),
    ]
    k4[0]["launches_in_e2e"] = bargs.epochs
    k4[1]["launches_in_e2e"] = n_blocks2 * ncfg.phase2_epochs
    for row in k4:
        row["path"] = "senna_bge"
    ac = dev32(acounts)
    anchor_checks = []
    for dt, cdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ares = anchor[dt]
        row = check_nce(
            K, ac.to(cdt), dev32(_neg_marginal(acounts, ncfg.neg_alpha)), dev32(ares.e_feat),
            dev32(ares.b_feat), dev32(ares.pb_embeddings[0]), dev32(ares.pb_biases[0]),
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

    # ---- phase 8: the kernels line, then the device line ------------------
    # Each kernel's numbers are those of its main-path shape with the most
    # e2e launches; `max_abs_err` is the largest over its checked shapes,
    # and `shapes` holds every checked shape of K3 and K4, each with the
    # run (`path`) whose launches `launches_in_e2e` counts. `launches` is
    # the count of the kernel's own main path: `senna topic` for K1-K3,
    # `senna bge` for K4; `launches_bge` is each kernel's count in bge.
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
            "launches": blaunches[name] if name == "nce_epoch" else launches[name],
            "launches_bge": blaunches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "deterministic": all(r["deterministic"] for r in checks[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        }
        if len(checks[name]) > 1:
            keep = ("shape", "launches_in_e2e", "max_abs_err", "deterministic", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")
            entry["shapes"] = [{"path": r.get("path"), **{k: r[k] for k in keep}}
                               for r in checks[name]]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
