"""Hand-written Hopper kernels of the port, their wrappers and their plain
torch versions.

| Wrapper            | Source             | Replaces (JAX package)                               |
| ------------------ | ------------------ | ---------------------------------------------------- |
| `project(normed)`  | csrc/project.cu    | ops/pallas_kernels.py:352 `tiled_call` (K1)          |
| `project(raw)`     | csrc/project.cu    | ops/pallas_kernels.py:93 `coo_project_pallas` (K2)   |
| `collapse`         | csrc/collapse.cu   | ops/pallas_kernels.py:480 `collapse_tiled_call` (K3) |

The sources compile with nvcc for `sm_90a` into shared libraries with a
plain C interface, at first use, into `legume_tpu_torch/_build/`, and
load through ctypes. Each wrapper checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises
if the launch reported an error, and adds one to `launch_counts[name]`.
A CPU tensor, and only a CPU tensor, takes the plain version beside the
kernel; a tensor on any other device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .sparse import col_ids_from_ptr, collapse_block, project_block, project_block_normed

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("project", "collapse")
MAX_K = 128

# launches per kernel; `chip_smoke.py` zeroes them before the main path
launch_counts = {"project_normed": 0, "project_raw": 0, "collapse": 0}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_kernels() -> dict[str, str]:
    """Compile every source in `csrc/` (one nvcc each, all started
    together) unless a library of the same source hash exists; returns
    the ptxas report of each source, `""` when it was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in SOURCES:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{name}_{digest}.so"
        if lib.exists():
            jobs[name] = (lib, None)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (lib, (proc, tmp))
    reports = {}
    for name, (lib, pending) in jobs.items():
        if pending is None:
            reports[name] = ""
            continue
        proc, tmp = pending
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
        tmp.replace(lib)
        reports[name] = out
    for name, (lib, _) in jobs.items():
        _libs[name] = _load(name, lib)
    return reports


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "project":
        lib.legume_project.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.legume_project.restype = i
    else:
        lib.legume_collapse.argtypes = [p, p, p, p, p, i, i, p]
        lib.legume_collapse.restype = i
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_kernels()
    return _libs[name]


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} have neither a kernel nor a plain path")


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device, ndim: int):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ----------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ----------------------------------------------------------------------------


def project_plain(basis_dk, row_ids, col_ptr, vals, *, normed: bool) -> torch.Tensor:
    ncols = col_ptr.shape[0] - 1
    col_ids = col_ids_from_ptr(col_ptr)
    fn = project_block_normed if normed else project_block
    return fn(basis_dk, row_ids, col_ids, vals, ncols=ncols)


def collapse_plain(row_ids, col_ptr, vals, seg_of_col, *, num_genes: int, num_groups: int):
    col_ids = col_ids_from_ptr(col_ptr)
    return collapse_block(
        row_ids, col_ids, vals, seg_of_col, num_genes=num_genes, num_groups=num_groups
    )


# ----------------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------------


def project(
    basis_dk: torch.Tensor,  # [D, K] f32, K <= 128
    row_ids: torch.Tensor,  # [nnz] int32
    col_ptr: torch.Tensor,  # [ncols + 1] int32
    vals: torch.Tensor,  # [nnz] f32
    *,
    normed: bool,
) -> torch.Tensor:
    """[ncols, K] projection of a column-sorted block: K1 when `normed`
    (log1p, per-cell L2 norm), K2 otherwise (raw values)."""
    if basis_dk.device.type == "cpu":
        return project_plain(basis_dk, row_ids, col_ptr, vals, normed=normed)
    _require_cuda(basis_dk, "project")
    dev = basis_dk.device
    _check(basis_dk, "basis_dk", torch.float32, dev, 2)
    _check(row_ids, "row_ids", torch.int32, dev, 1)
    _check(col_ptr, "col_ptr", torch.int32, dev, 1)
    _check(vals, "vals", torch.float32, dev, 1)
    k = basis_dk.shape[1]
    if k > MAX_K:
        raise ValueError(f"projection width {k} exceeds {MAX_K}")
    if row_ids.shape != vals.shape:
        raise ValueError("row_ids and vals differ in length")
    ncols = col_ptr.shape[0] - 1
    out = torch.empty(ncols, k, dtype=torch.float32, device=dev)
    err = _lib("project").legume_project(
        row_ids.data_ptr(), col_ptr.data_ptr(), vals.data_ptr(), basis_dk.data_ptr(),
        out.data_ptr(), ncols, k, int(normed), _stream(dev),
    )
    _raise_on(err, "project")
    launch_counts["project_normed" if normed else "project_raw"] += 1
    return out


def collapse(
    row_ids: torch.Tensor,  # [nnz] int32
    col_ptr: torch.Tensor,  # [ncols + 1] int32
    vals: torch.Tensor,  # [nnz] f32
    seg_of_col: torch.Tensor,  # [ncols] int32; >= num_groups drops the cell
    *,
    num_genes: int,
    num_groups: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """[num_genes, num_groups] group sums of a column-sorted block (K3).
    With `out`, the sums are added into that plane in place."""
    if vals.device.type == "cpu":
        plane = collapse_plain(
            row_ids, col_ptr, vals, seg_of_col, num_genes=num_genes, num_groups=num_groups
        )
        return plane if out is None else out.add_(plane)
    _require_cuda(vals, "collapse")
    dev = vals.device
    _check(row_ids, "row_ids", torch.int32, dev, 1)
    _check(col_ptr, "col_ptr", torch.int32, dev, 1)
    _check(vals, "vals", torch.float32, dev, 1)
    _check(seg_of_col, "seg_of_col", torch.int32, dev, 1)
    ncols = col_ptr.shape[0] - 1
    if seg_of_col.shape[0] != ncols:
        raise ValueError("seg_of_col must hold one group per cell")
    if row_ids.shape != vals.shape:
        raise ValueError("row_ids and vals differ in length")
    if out is None:
        out = torch.zeros(num_genes, num_groups, dtype=torch.float32, device=dev)
    else:
        _check(out, "out", torch.float32, dev, 2)
        if tuple(out.shape) != (num_genes, num_groups):
            raise ValueError(f"out has shape {tuple(out.shape)}, expected {(num_genes, num_groups)}")
    err = _lib("collapse").legume_collapse(
        row_ids.data_ptr(), col_ptr.data_ptr(), vals.data_ptr(), seg_of_col.data_ptr(),
        out.data_ptr(), ncols, num_groups, _stream(dev),
    )
    _raise_on(err, "collapse")
    launch_counts["collapse"] += 1
    return out
