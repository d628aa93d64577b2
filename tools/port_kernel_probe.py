"""Where K3 (`csrc/collapse.cu`), K1 (`csrc/project.cu`) and K4
(`csrc/nce_epoch.cu`) of the PyTorch/CUDA port spend their time on an
NVIDIA GPU.

    python3 tools/port_kernel_probe.py [--only k4] [--parent-nce OLD.cu]
        [--nce-plans bc:rt,...] [--phase1-turns OLD_TREE]

On synthetic 8,192-cell blocks (2,000 genes at ~790 nonzeros a cell,
about the density of `chip_smoke.py`'s e2e block; 34,008 genes at
~1,010 a cell, its production shape), with group ids drawn uniformly or
from a Zipf law (exponent 1.1, as binary-sort codes are skewed), prints
one JSON line per
case: the wrapper's time (CUDA events around 20 back-to-back calls, after
warm-up), `index_add_`'s time on the same flat keys, whether the kernel
matched its plain version (atol = rtol = 1e-5) and two launches were
bit-equal, and each CUDA kernel's device time per call from
`torch.profiler`. Then the same split for K1 at the e2e block, K = 50.

K4 (`--only k4` runs this part alone): the NCE anchor plane (2,627 x
34,008, ~3% occupied, Poisson(2) + 1; H = 16) in f32 and bf16 in the full
form, a 256 x 2,000 plane as bge's phase 1 takes it (full form), and a
2,048-cell x 2,000-gene phase-2 block (Poisson(1.5)) in the axis form
and the full form; per case the wrapper's time, the plan, the launch
split by CUDA kernel (main, gradient reduce, loss reduce), whether the
kernel matched its plain version, and the host time per call of the
wrapper and of a bare launch of the same library entry (no checks). With
`--parent-nce`, an older `nce_epoch.cu` (one with the C interface
`legume_nce_epoch(c, c_bf16, q, e_f, b_f, e_a, b_a, m, k_neg, P, D, H,
scratch, loss, g_ef, g_bf, g_ea, g_ba, stream)` and
`legume_nce_epoch_scratch(P, D, H)`) is built under another library name
into a scratch directory and timed in turns with the package's kernel on
the same inputs, both through bare launches: parent, this, this, parent,
by CUDA events (wall time of 20 back-to-back calls, which the host time
per call bounds from below on the small planes) and by the profiler's
device time per call. `--nce-plans bc:rt,...` times other launch plans
than `nce_plan`'s at the f32 anchor, through bare launches.
`--phase1-turns OLD_TREE` times `fit_bge`'s phase 1 (1,000 epochs, H =
16) on a seeded 256 x 2,000 plane, as bge's phase 1 takes it, in a
fresh process per run from an older checkout and from this one in
turns (old, this, this, old): its `phase1_s`, host included.
Needs a CUDA device; builds the kernels at first use.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REPS = 20


def time_ms(fn) -> float:
    for _ in range(3):
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


def kernel_split(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def block(ncols: int, genes: int, draws: int, seed: int, dev):
    """A column-sorted block: `draws` gene draws a cell, made distinct and
    sorted within the cell; values 1 + Exp(1) * 3, not whole numbers, so
    that two launches that add in another order differ in the last bits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cells = torch.repeat_interleave(torch.arange(ncols, device=dev), draws)
    keys = torch.unique(cells * genes + torch.randint(0, genes, cells.shape, generator=g, device=dev))
    rows = (keys % genes).to(torch.int32)
    ptr = torch.zeros(ncols + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(keys // genes, minlength=ncols), 0)
    u = torch.rand(rows.shape[0], generator=g, device=dev).clamp_min(1e-6)
    return rows, ptr, 1.0 - torch.log(u) * 3.0


def nce_inputs(p: int, d: int, dtype, dev, *, sparse: bool):
    """Counts (~3% occupied, Poisson(2) + 1, when `sparse`; else
    Poisson(1.5)), the count marginal^0.75, embeddings of std 0.1, small
    biases and the row masses."""
    g = torch.Generator(device=dev).manual_seed(11)
    if sparse:
        flat = torch.zeros(p * d, device=dev)
        nnz = int(0.03 * p * d)
        idx = torch.randint(0, p * d, (nnz,), generator=g, device=dev)
        flat[idx] = torch.poisson(torch.full((nnz,), 2.0, device=dev), generator=g) + 1.0
        counts = flat.view(p, d)
    else:
        counts = torch.poisson(torch.full((p, d), 1.5, device=dev), generator=g)
    q = counts.sum(0) ** 0.75
    q = q / q.sum()
    return [counts.to(dtype), q, 0.1 * torch.randn(d, 16, generator=g, device=dev),
            0.01 * torch.randn(d, generator=g, device=dev),
            0.1 * torch.randn(p, 16, generator=g, device=dev),
            0.01 * torch.randn(p, generator=g, device=dev), counts.sum(1)]


def nvcc_library(src: Path, name: str) -> ctypes.CDLL:
    """`src` built as its own library in a scratch directory."""
    from legume_tpu_torch.ops import kernels as K

    out = Path(tempfile.mkdtemp(prefix="nce_probe_")) / f"lib{name}.so"
    subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def bare_nce(K, plan=None):
    """The package's K4 launched straight through its library entry, with
    `plan` (default `nce_plan`'s) and none of the wrapper's checks: the
    same host work per call as the parent's launcher below."""
    lib = K._lib("nce_epoch")

    def run(c, q, e_f, b_f, e_a, b_a, m, k_neg, need_feat=True):
        (p, d), h, dev = c.shape, e_f.shape[1], c.device
        pl = plan or K.nce_plan(p, d, h)
        fd = d if need_feat else 0
        scratch = torch.empty(pl.scratch_floats(need_feat), device=dev)
        outs = [torch.empty((), device=dev), torch.empty(fd, h, device=dev), torch.empty(fd, device=dev),
                torch.empty(p, h, device=dev), torch.empty(p, device=dev)]
        err = lib.legume_nce_epoch(
            c.data_ptr(), int(c.dtype == torch.bfloat16), *(t.data_ptr() for t in (q, e_f, b_f, e_a, b_a, m)),
            float(k_neg), p, d, h, int(need_feat), pl.band_chunks, pl.range_tiles, scratch.data_ptr(),
            *(t.data_ptr() for t in outs), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err:
            raise RuntimeError(f"nce_epoch failed: cudaError {err}")
        return tuple(outs)

    return run


def host_us(fn) -> float:
    """Host microseconds per call: the time to enqueue REPS calls, after
    warm-up, without waiting for the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPS):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / REPS * 1e6


def build_parent_nce(src: Path):
    """An older K4 source as its own library, in a scratch directory, with
    the C interface it had before the plan moved to Python."""
    lib = nvcc_library(src, "nce_epoch_parent")
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.legume_nce_epoch.argtypes = [P_, I_] + [P_] * 6 + [F_, I_, I_, I_] + [P_] * 7
    lib.legume_nce_epoch.restype = I_
    lib.legume_nce_epoch_scratch.argtypes = [I_, I_, I_]
    lib.legume_nce_epoch_scratch.restype = ctypes.c_longlong

    def run(c, q, e_f, b_f, e_a, b_a, m, k_neg):
        (p, d), h, dev = c.shape, e_f.shape[1], c.device
        scratch = torch.empty(lib.legume_nce_epoch_scratch(p, d, h), device=dev)
        outs = [torch.empty((), device=dev), torch.empty(d, h, device=dev), torch.empty(d, device=dev),
                torch.empty(p, h, device=dev), torch.empty(p, device=dev)]
        err = lib.legume_nce_epoch(
            c.data_ptr(), int(c.dtype == torch.bfloat16), *(t.data_ptr() for t in (q, e_f, b_f, e_a, b_a, m)),
            float(k_neg), p, d, h, scratch.data_ptr(), *(t.data_ptr() for t in outs),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err:
            raise RuntimeError(f"parent nce_epoch failed: cudaError {err}")
        return tuple(outs)

    return run


# one phase-1 fit from the checkout in the working directory, after a
# 10-epoch warm-up fit (CUDA start-up, kernel build and load)
PHASE1_FIT = r"""
import json, numpy as np
from legume_tpu_torch.embedding.nce import NceConfig, fit_bge
counts = np.random.default_rng(5).poisson(100.0, (256, 2000)).astype(np.float32)
fit_bge([counts], config=NceConfig(embedding_dim=16, epochs=10), device="cuda")
res = fit_bge([counts], config=NceConfig(embedding_dim=16, epochs=1000), device="cuda")
print(json.dumps({"phase1_s": res.timings["phase1_s"], "final_loss": res.phase1_losses[-1]}))
"""


def probe_phase1_turns(old_tree: Path, card: str) -> None:
    here = Path(__file__).resolve().parents[1]
    runs = {"parent": [], "pr": []}
    for name, tree in (("parent", old_tree), ("pr", here), ("pr", here), ("parent", old_tree)):
        out = subprocess.run([sys.executable, "-c", PHASE1_FIT], cwd=tree, capture_output=True,
                             text=True, check=True)
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"fit": "bge_phase1", "rows": 256, "genes": 2000, "h": 16, "epochs": 1000,
                      "card": card, **runs}), flush=True)


def probe_nce(K, dev, card: str, parent) -> None:
    bare = bare_nce(K)
    cases = [("anchor", 2627, 34008, torch.float32, True, True),
             ("anchor", 2627, 34008, torch.bfloat16, True, True),
             ("phase1_plane", 256, 2000, torch.float32, False, True),
             ("phase2_block", 2048, 2000, torch.float32, False, False),
             ("phase2_block", 2048, 2000, torch.float32, False, True)]
    for tag, p, d, dtype, sparse, need_feat in cases:
        args = nce_inputs(p, d, dtype, dev, sparse=sparse)
        got = K.nce_epoch(*args, 5.0, need_feat=need_feat)
        want = K.nce_epoch_plain(*args, 5.0, need_feat=need_feat)
        again = K.nce_epoch(*args, 5.0, need_feat=need_feat)
        torch.cuda.synchronize()
        grads = [(x, w) for x, w in zip(got[1:], want[1:]) if w is not None]
        ok = (abs(float(got[0]) - float(want[0])) <= 2e-5 * abs(float(want[0]))
              and all(float((x - w).abs().max()) <= 1e-4 * float(w.abs().max()) for x, w in grads))
        fn = lambda: K.nce_epoch(*args, 5.0, need_feat=need_feat)  # noqa: E731
        bf = lambda: bare(*args, 5.0, need_feat)  # noqa: E731
        row = {
            "kernel": "nce_epoch", "shape": tag, "rows": p, "genes": d, "h": 16,
            "count_dtype": str(dtype), "form": "full" if need_feat else "axis", "card": card,
            "plan": {k: v for k, v in K.nce_plan(p, d, 16).__dict__.items()
                     if k in ("band_chunks", "range_tiles")},
            "ctas_per_sm": K.nce_ctas_per_sm(16, K.nce_plan(p, d, 16).range_tiles, dtype, need_feat),
            "ok": ok, "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)
                                           if a is not None),
            "bare_equal": all(torch.equal(a, b) for a, b in zip(got, bf()) if a is not None),
            "kernels_us": kernel_split(fn), "ms": time_ms(fn),
            "host_us": host_us(fn), "bare_host_us": host_us(bf),
        }
        if parent is not None:
            pf = lambda: parent(*args, 5.0)  # noqa: E731
            pgot = pf()
            torch.cuda.synchronize()
            row["parent_loss_rel"] = abs(float(pgot[0]) - float(want[0])) / abs(float(want[0]))
            # the parent computes the feature side in either form
            turns = [("parent", pf), ("pr", bf), ("pr", bf), ("parent", pf)]
            times = {"parent": [], "pr": []}
            device = {"parent": [], "pr": []}
            for name, f in turns:
                times[name].append(time_ms(f))
                device[name].append(sum(kernel_split(f).values()))
            row.update(parent_ms=times["parent"], pr_ms=times["pr"],
                       parent_device_us=device["parent"], pr_device_us=device["pr"],
                       parent_host_us=host_us(pf), parent_kernels_us=kernel_split(pf))
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["k4"], default=None)
    ap.add_argument("--parent-nce", type=Path, default=None)
    ap.add_argument("--phase1-turns", type=Path, default=None)
    ap.add_argument("--nce-plans", default="",
                    help="band_chunks:range_tiles,... timed at the f32 anchor besides nce_plan's")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_probe: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from legume_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.build_kernels()
    card = torch.cuda.get_device_name(0)
    parent = build_parent_nce(opts.parent_nce) if opts.parent_nce else None
    probe_nce(K, dev, card, parent)
    if opts.phase1_turns:
        probe_phase1_turns(opts.phase1_turns.resolve(), card)
    if opts.nce_plans:
        args = nce_inputs(2627, 34008, torch.float32, dev, sparse=True)
        base = K.nce_plan(2627, 34008, 16)
        for spec in opts.nce_plans.split(","):
            bc, rt = (int(x) for x in spec.split(":"))
            plan = dataclasses.replace(base, band_chunks=bc, range_tiles=rt)
            print(json.dumps({
                "kernel": "nce_epoch", "shape": "anchor", "count_dtype": "torch.float32",
                "card": card, "plan": {"band_chunks": bc, "range_tiles": rt},
                "ctas": plan.bands * plan.ranges, "partial_bytes": 4 * plan.scratch_floats(True),
                "ctas_per_sm": K.nce_ctas_per_sm(16, rt, torch.float32, True),
                "ms": time_ms(lambda: bare_nce(K, plan)(*args, 5.0)),
            }), flush=True)
    if opts.only == "k4":
        return 0
    rng = np.random.default_rng(0)
    shapes = {"e2e": (2000, 1000, (1024, 256, 2)), "production": (34008, 1025, (607,))}
    for tag, (genes, draws, group_counts) in shapes.items():
        rows, ptr, vals = block(8192, genes, draws, 1, dev)
        cols = torch.repeat_interleave(torch.arange(8192, device=dev), (ptr[1:] - ptr[:-1]).long())
        for s in group_counts:
            p = 1.0 / np.arange(1, s + 1) ** 1.1
            draws_of = {"uniform": rng.integers(0, s, 8192), "zipf": rng.choice(s, 8192, p=p / p.sum())}
            for law, seg_np in draws_of.items():
                seg = torch.from_numpy(seg_np.astype(np.int32)).to(dev)
                kw = dict(num_genes=genes, num_groups=s)
                want = K.collapse_plain(rows, ptr, vals, seg, **kw)
                got = K.collapse(rows, ptr, vals, seg, **kw)
                again = K.collapse(rows, ptr, vals, seg, **kw)
                torch.cuda.synchronize()
                keys = rows.long() * s + seg.long()[cols]
                flat = torch.zeros(genes * s, device=dev)
                print(json.dumps({
                    "kernel": "collapse", "shape": tag, "groups": s, "law": law, "card": card,
                    "nnz": rows.shape[0], "largest_group": int(np.bincount(seg_np).max()),
                    "ok": bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()),
                    "deterministic": bool(torch.equal(got, again)),
                    "ms": time_ms(lambda: K.collapse(rows, ptr, vals, seg, **kw)),
                    "index_add_ms": time_ms(lambda: flat.zero_().index_add_(0, keys, vals)),
                    "kernels_us": kernel_split(lambda: K.collapse(rows, ptr, vals, seg, **kw)),
                }), flush=True)
    rows, ptr, vals = block(8192, 2000, 1000, 1, dev)
    basis = torch.randn(2000, 50, device=dev)
    print(json.dumps({
        "kernel": "project_normed", "shape": "e2e", "k": 50, "card": card, "nnz": rows.shape[0],
        "ms": time_ms(lambda: K.project(basis, rows, ptr, vals, normed=True)),
        "kernels_us": kernel_split(lambda: K.project(basis, rows, ptr, vals, normed=True)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
