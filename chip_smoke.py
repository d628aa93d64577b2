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
5. print one JSON line of all kernels, then the device line last.

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
WARMUP, REPS = 3, 15

# tolerances: normwise max|kernel - plain| / max|plain| for the
# projections (sums with cancellation), elementwise for the collapse
# (sums of non-negative values)
RTOL_K1, RTOL_K2 = 2e-4, 1e-4
ATOL_K3 = RTOL_K3 = 1e-5

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
    """Median of REPS single-call times by CUDA events, after warm-up."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_projection(K, basis, rows, ptr, vals, *, normed: bool, shape: str) -> dict:
    nnz, ncols, (d, k) = rows.shape[0], ptr.shape[0] - 1, basis.shape
    got = K.project(basis, rows, ptr, vals, normed=normed)
    want = K.project_plain(basis, rows, ptr, vals, normed=normed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rtol = RTOL_K1 if normed else RTOL_K2
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        raise AssertionError(f"project(normed={normed}) at {shape}: err {err} vs scale {scale}")
    library_ms = None
    if not normed:  # the same function as one CSR x dense product
        csr = torch.sparse_csr_tensor(
            ptr.long(), rows.long(), vals, size=(ncols, d), check_invariants=True
        )
        lib = torch.sparse.mm(csr, basis)
        if float((lib - want).abs().max()) > rtol * scale:
            raise AssertionError("torch.sparse.mm disagrees with the plain projection")
        library_ms = time_ms(lambda: torch.sparse.mm(csr, basis))
    nbytes = nnz * 8 + (ncols + 1) * 4 + d * k * 4 + ncols * k * 4
    flops = nnz * k * 2 + (nnz * 3 if normed else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": shape, "nnz": nnz, "ncols": ncols, "genes": d, "k": k,
        "max_abs_err": err, "max_abs_plain": scale, "rtol": rtol,
        "ms": time_ms(lambda: K.project(basis, rows, ptr, vals, normed=normed)),
        "plain_ms": time_ms(lambda: K.project_plain(basis, rows, ptr, vals, normed=normed)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_collapse(K, rows, ptr, vals, seg, *, num_genes: int, num_groups: int, shape: str) -> dict:
    nnz, ncols = rows.shape[0], ptr.shape[0] - 1
    kw = dict(num_genes=num_genes, num_groups=num_groups)
    got = K.collapse(rows, ptr, vals, seg, **kw)
    want = K.collapse_plain(rows, ptr, vals, seg, **kw)
    torch.cuda.synchronize()
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
        "max_abs_err": err, "atol": ATOL_K3, "rtol": RTOL_K3,
        "ms": time_ms(lambda: K.collapse(rows, ptr, vals, seg, **kw)),
        "plain_ms": time_ms(lambda: K.collapse_plain(rows, ptr, vals, seg, **kw)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: flat.zero_().index_add_(0, keys, kv)),
    }


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

    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.sim import simulate_topic
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops import kernels as K
    from legume_tpu_torch.ops.collapse import MATCHED_CELL_BLOCK, matched_block
    from legume_tpu_torch.ops.knn import matched_neighbors_across_batches
    from legume_tpu_torch.ops.random_projection import block_to_device
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
    checks = {
        "project_normed": [check_projection(K, basis, rows, ptr, vals, normed=True, shape="e2e_block")],
        "project_raw": [check_projection(K, basis, rows, ptr, vals, normed=False, shape="e2e_block")],
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
    d, pbasis, prows, pptr, pvals, pseg = production_block(dev)
    production = {
        "project_normed": check_projection(K, pbasis, prows, pptr, pvals, normed=True, shape="production"),
        "project_raw": check_projection(K, pbasis, prows, pptr, pvals, normed=False, shape="production"),
        "collapse": check_collapse(K, prows, pptr, pvals, pseg, num_genes=d, num_groups=607,
                                   shape="production"),
    }
    for name, rows_ in checks.items():
        for row in rows_ + [production[name]]:
            print(json.dumps({"kernel_check": name, "card": card, **row}), flush=True)

    # ---- phase 4: where the trainer's construction spends its time ---------
    probe = subprocess.run(
        [sys.executable, "-c", SETUP_PROBE], capture_output=True, text=True, check=True,
        cwd=Path(__file__).resolve().parent,
    )
    print(probe.stdout.strip().splitlines()[-1], flush=True)

    # ---- phase 5: the kernels line, then the device line ------------------
    # Each kernel's numbers are those of its main-path shape with the most
    # e2e launches; `max_abs_err` is the largest over its main-path shapes,
    # and `shapes` holds every main-path shape of K3.
    meta = {
        "project_normed": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:352"),
        "project_raw": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:93"),
        "collapse": ("legume_tpu_torch/csrc/collapse.cu", "legume_tpu/ops/pallas_kernels.py:480"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main = max(checks[name], key=lambda r: r.get("launches_in_e2e", 0))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        }
        if len(checks[name]) > 1:
            keep = ("shape", "launches_in_e2e", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")
            entry["shapes"] = [{k: r[k] for k in keep} for r in checks[name]]
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
