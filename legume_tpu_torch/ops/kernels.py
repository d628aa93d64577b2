"""Hand-written Hopper kernels of the port, their wrappers and their plain
torch versions.

| Wrapper            | Source             | Replaces (JAX package)                               |
| ------------------ | ------------------ | ---------------------------------------------------- |
| `project(normed)`  | csrc/project.cu    | ops/pallas_kernels.py:352 `tiled_call` (K1)          |
| `project(raw)`     | csrc/project.cu    | ops/pallas_kernels.py:93 `coo_project_pallas` (K2)   |
| `collapse`         | csrc/collapse.cu   | ops/pallas_kernels.py:480 `collapse_tiled_call` (K3) |
| `nce_epoch`        | csrc/nce_epoch.cu  | embedding/nce_pallas.py:101 `_epoch_call` (K4)       |

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
from dataclasses import dataclass
from pathlib import Path

import torch

from .sparse import col_ids_from_ptr, collapse_block, project_block, project_block_normed

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("project", "collapse", "nce_epoch")
MAX_H = 128
SMEM_BYTES = 232_448  # shared memory one CTA may use on an H100 (sm_90)

# csrc/collapse.cu: 8 warps a CTA, each with a private gene column
COLLAPSE_WARPS = 8
COLLAPSE_SMEM = 98_304  # per CTA, so that two fit on an SM
COLLAPSE_PARTIAL_BYTES = 8 << 20  # most scratch the chunk partials may take
COLLAPSE_MIN_CHUNK_CELLS = 64
COLLAPSE_TARGET_CTAS = 132  # the few-group path's chunks fill an H100's 132 SMs
COLLAPSE_ITEMS = 2048  # items the many-group path aims at (a warp each)
COLLAPSE_COLBUF_BYTES = 32 << 20  # scratch its item columns should stay under
COLLAPSE_MAX_CAP = 32
# csrc/project.cu: 128 cells x 16 basis columns a CTA; gene tiles of 1,536
# rows, double-buffered, once a 16-column slice of the basis overflows
# shared memory (above 3,632 genes)
PROJECT_SLICE = 16
PROJECT_CELLS_PER_CTA = 128
PROJECT_GENE_TILE = 1536

# launches per kernel; `chip_smoke.py` zeroes them before the main path
launch_counts = {"project_normed": 0, "project_raw": 0, "collapse": 0, "nce_epoch": 0}

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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of each source: symbol -> (argtypes, restype)
_ENTRIES = {
    "project": {"legume_project": ([_P] * 9 + [_I] * 6 + [_P], _I)},
    "collapse": {
        "legume_collapse": ([_P] * 6 + [_I] * 8 + [_P], _I),
        "legume_collapse_scratch": ([_I] * 5, ctypes.c_longlong),
    },
    "nce_epoch": {
        "legume_nce_epoch": ([_P, _I] + [_P] * 6 + [_F, _I, _I, _I] + [_P] * 7, _I),
        "legume_nce_epoch_scratch": ([_I, _I, _I], ctypes.c_longlong),
    },
}


def _load(name: str, path: Path) -> ctypes.CDLL:
    if name not in _ENTRIES:
        raise KeyError(f"no C entry points declared for kernel source {name!r}")
    lib = ctypes.CDLL(str(path))
    for symbol, (argtypes, restype) in _ENTRIES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------------
# launch plans: how a wrapper cuts its call into CTAs, from the shape alone
# (so the sum order, and the result, is the same for the same inputs on
# any card)
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class CollapsePlan:
    """K3's grid. Few groups (`cap == 0`): a CTA holds
    `COLLAPSE_WARPS // replicas` group slots of `gene_tile` genes; the
    warps of one slot split its cells by index (replica r takes cell c of
    a chunk when (c - chunk start) % replicas == r); chunk i covers cells
    [i * chunk_cells, (i + 1) * chunk_cells), and with more than one
    chunk each writes a partial plane that a second kernel adds into
    `out` in chunk order. Many groups (`cap >= 1`): the kept cells
    are ordered by group, then by index, and each group's run is cut into
    items of at most `cap` cells, a warp each, whose columns a last
    kernel adds into `out` in item order."""

    replicas: int
    gene_tile: int
    gene_tiles: int
    group_tiles: int
    chunk_cells: int
    chunks: int
    cap: int

    @property
    def slots(self) -> int:
        return COLLAPSE_WARPS // self.replicas


def collapse_plan(ncols: int, num_genes: int, num_groups: int) -> CollapsePlan:
    """Few groups (< 8): every warp of a CTA takes a share of one group's
    cells, and chunks of cells fill the card. Many groups: items of about
    `ncols / COLLAPSE_ITEMS` cells, larger where the item columns would
    outgrow `COLLAPSE_COLBUF_BYTES`, so that skewed group sizes stay
    balanced. The gene column is cut into tiles that fit shared memory."""
    if min(ncols, num_genes, num_groups) < 1:
        raise ValueError(f"empty collapse: {ncols} cells, {num_genes} genes, {num_groups} groups")
    max_tile = (COLLAPSE_SMEM // 4 // COLLAPSE_WARPS - 4) // 32 * 32
    gene_tile = min(max_tile, _cdiv(num_genes, 32) * 32)
    gene_tiles = _cdiv(num_genes, gene_tile)
    if num_groups >= COLLAPSE_WARPS:
        cap = max(_cdiv(ncols, COLLAPSE_ITEMS), _cdiv(4 * ncols * num_genes, COLLAPSE_COLBUF_BYTES))
        return CollapsePlan(1, gene_tile, gene_tiles, _cdiv(num_groups, COLLAPSE_WARPS), ncols, 1,
                            min(max(cap, 2), COLLAPSE_MAX_CAP))
    replicas = COLLAPSE_WARPS // (1 << (num_groups - 1).bit_length())
    group_tiles = _cdiv(num_groups, COLLAPSE_WARPS // replicas)
    base = gene_tiles * group_tiles
    chunks = max(1, min(
        COLLAPSE_TARGET_CTAS // base,
        COLLAPSE_PARTIAL_BYTES // (4 * num_genes * num_groups),
        ncols // COLLAPSE_MIN_CHUNK_CELLS,
    ))
    chunk_cells = _cdiv(ncols, chunks)
    return CollapsePlan(replicas, gene_tile, gene_tiles, group_tiles, chunk_cells,
                        _cdiv(ncols, chunk_cells), 0)


@dataclass(frozen=True)
class ProjectPlan:
    """K1/K2's grid: `cell_tiles` x `slices` CTAs, each with
    `PROJECT_CELLS_PER_CTA` cells and `PROJECT_SLICE` basis columns,
    walking `gene_tiles` tiles of `gene_tile` basis rows in order."""

    slices: int
    gene_tile: int
    gene_tiles: int
    cell_tiles: int


def project_plan(ncols: int, num_genes: int, k: int) -> ProjectPlan:
    if min(num_genes, k) < 1:
        raise ValueError(f"empty projection: {num_genes} genes, width {k}")
    if num_genes * PROJECT_SLICE * 4 <= SMEM_BYTES:
        gene_tile = num_genes
    else:
        gene_tile = PROJECT_GENE_TILE
    return ProjectPlan(_cdiv(k, PROJECT_SLICE), gene_tile, _cdiv(num_genes, gene_tile),
                       _cdiv(max(ncols, 0), PROJECT_CELLS_PER_CTA))


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


def nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, k_neg: float):
    """The closed form of K4 in torch ops: `(loss_sum, g_ef, g_bf, g_ea,
    g_ba)`, unscaled. softplus is max(s, 0) + log1p(exp(-|s|)), which is
    `jax.nn.softplus`; torch's own thresholds at 20."""
    s = e_a @ e_f.T + b_f[None, :] + b_a[:, None]
    c32 = c.float()
    a = c32 + k_neg * (m[:, None] * q[None, :])
    softplus = torch.clamp_min(s, 0.0) + torch.log1p(torch.exp(-s.abs()))
    loss = (c32 * s - a * softplus).sum()
    g_s = c32 - a * torch.sigmoid(s)
    return loss, g_s.T @ e_a, g_s.sum(0), g_s @ e_f, g_s.sum(1)


# ----------------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------------


def project(
    basis_dk: torch.Tensor,  # [D, K] f32, any K >= 1
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
    d, k = basis_dk.shape
    if row_ids.shape != vals.shape:
        raise ValueError("row_ids and vals differ in length")
    ncols = col_ptr.shape[0] - 1
    plan = project_plan(ncols, d, k)
    out = torch.empty(ncols, k, dtype=torch.float32, device=dev)
    if ncols == 0:  # no cells, and no launch
        return out
    # scratch of the pre-pass: log1p weights and row norms; each gene
    # tile's first entry per cell, and whether the cell's genes increase
    wts = torch.empty(vals.shape[0] if normed else 0, dtype=torch.float32, device=dev)
    norm = torch.empty(ncols if normed else 0, dtype=torch.float32, device=dev)
    tiled = plan.gene_tiles > 1
    bounds = torch.empty(ncols * (plan.gene_tiles + 1) if tiled else 0, dtype=torch.int32,
                         device=dev)
    inc = torch.empty(ncols if tiled else 0, dtype=torch.int32, device=dev)
    err = _lib("project").legume_project(
        row_ids.data_ptr(), col_ptr.data_ptr(), vals.data_ptr(), basis_dk.data_ptr(),
        out.data_ptr(), wts.data_ptr(), norm.data_ptr(), bounds.data_ptr(), inc.data_ptr(), ncols, d, k,
        int(normed), plan.gene_tile, plan.gene_tiles, _stream(dev),
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
    if ncols == 0:  # nothing to add, and no launch
        return out
    plan = collapse_plan(ncols, num_genes, num_groups)
    lib = _lib("collapse")
    words = lib.legume_collapse_scratch(ncols, num_genes, num_groups, plan.chunks, plan.cap)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    err = lib.legume_collapse(
        row_ids.data_ptr(), col_ptr.data_ptr(), vals.data_ptr(), seg_of_col.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), ncols, num_genes, num_groups, plan.replicas,
        plan.gene_tile, plan.chunk_cells, plan.chunks, plan.cap, _stream(dev),
    )
    _raise_on(err, "collapse")
    launch_counts["collapse"] += 1
    return out


def nce_epoch(
    c: torch.Tensor,  # [P, D] f32 or bf16 counts
    q: torch.Tensor,  # [D] f32 negative marginal
    e_f: torch.Tensor,  # [D, H] f32, H <= 128
    b_f: torch.Tensor,  # [D] f32
    e_a: torch.Tensor,  # [P, H] f32
    b_a: torch.Tensor,  # [P] f32
    m: torch.Tensor,  # [P] f32 row masses
    k_neg: float,
):
    """`(loss_sum [], g_ef [D, H], g_bf [D], g_ea [P, H], g_ba [P])` of
    one expected-NCE epoch, unscaled (K4)."""
    if c.device.type == "cpu":
        return nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, k_neg)
    _require_cuda(c, "nce_epoch")
    dev = c.device
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c has dtype {c.dtype}, expected float32 or bfloat16")
    if c.dim() != 2 or not c.is_contiguous():
        raise ValueError("c must be a contiguous [P, D] plane")
    p, d = c.shape
    h = e_f.shape[-1]
    if not 1 <= h <= MAX_H:
        raise ValueError(f"embedding width {h} is outside [1, {MAX_H}]")
    if p < 1 or d < 1:
        raise ValueError(f"count plane {tuple(c.shape)} is empty")
    for what, t, shape in (("q", q, (d,)), ("e_f", e_f, (d, h)), ("b_f", b_f, (d,)),
                           ("e_a", e_a, (p, h)), ("b_a", b_a, (p,)), ("m", m, (p,))):
        _check(t, what, torch.float32, dev, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    lib = _lib("nce_epoch")
    scratch = torch.empty(lib.legume_nce_epoch_scratch(p, d, h), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    g_ef = torch.empty(d, h, dtype=torch.float32, device=dev)
    g_bf = torch.empty(d, dtype=torch.float32, device=dev)
    g_ea = torch.empty(p, h, dtype=torch.float32, device=dev)
    g_ba = torch.empty(p, dtype=torch.float32, device=dev)
    err = lib.legume_nce_epoch(
        c.data_ptr(), int(c.dtype == torch.bfloat16), q.data_ptr(), e_f.data_ptr(),
        b_f.data_ptr(), e_a.data_ptr(), b_a.data_ptr(), m.data_ptr(), float(k_neg), p, d, h,
        scratch.data_ptr(), loss.data_ptr(), g_ef.data_ptr(), g_bf.data_ptr(), g_ea.data_ptr(),
        g_ba.data_ptr(), _stream(dev),
    )
    _raise_on(err, "nce_epoch")
    launch_counts["nce_epoch"] += 1
    return loss, g_ef, g_bf, g_ea, g_ba
