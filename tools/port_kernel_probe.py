"""Where K3 (`csrc/collapse.cu`) and K1 (`csrc/project.cu`) of the
PyTorch/CUDA port spend their time on an NVIDIA GPU.

    python3 tools/port_kernel_probe.py

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
Needs a CUDA device; builds the kernels at first use.
"""

from __future__ import annotations

import json
import sys
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


def main() -> int:
    if not torch.cuda.is_available():
        print("port_kernel_probe: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from legume_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    K.build_kernels()
    card = torch.cuda.get_device_name(0)
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
