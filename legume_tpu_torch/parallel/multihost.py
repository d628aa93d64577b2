"""Multi-process streaming reductions (the port of the JAX package's
`parallel/multihost.py`) on `torch.distributed`, one rank per GPU.

- `maybe_initialize_distributed`: the process group behind the JAX
  package's switches (`LEGUME_COORDINATOR`, `LEGUME_NUM_PROCESSES`,
  `LEGUME_PROCESS_ID`, or `LEGUME_DISTRIBUTED=1` under a launcher such as
  torchrun that sets `RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`);
- `plan_column_shards`: the nnz-balanced contiguous column split;
- `collapse_observed_multihost`: each rank reads only its own column
  shards, sums them through kernel K3, and the [D, S] planes sum across
  ranks;
- `DistContext`: the host collectives of `senna topic`'s streaming
  pipeline, which gather every rank's array on the host and concatenate
  or sum them in rank order, so the statistics do not depend on the
  backend and are the same from run to run.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels
from .mesh import Mesh, data_sharding, host_group, world

log = logging.getLogger(__name__)

# how long a collective waits for a peer before the run fails
DEFAULT_TIMEOUT = timedelta(minutes=10)


# ----------------------------------------------------------------------------
# the process group
# ----------------------------------------------------------------------------


def choose_backend(device, local_world: int) -> str:
    """NCCL when every rank of the host has a GPU of its own; gloo when
    ranks share a GPU (NCCL refuses two ranks on one device at the first
    collective) or run on the CPU."""
    if torch.device(device).type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device="cuda",
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Start the process group when configured; no-op otherwise. Returns
    True when a process group is live after the call.

    Switches (env, overridable by args): `LEGUME_COORDINATOR` (host:port
    of rank 0's store), `LEGUME_NUM_PROCESSES`, `LEGUME_PROCESS_ID`; or
    `LEGUME_DISTRIBUTED=1`, where the launcher gives the rendezvous
    (`env://`). The ranks of one host are `LOCAL_WORLD_SIZE` (all of them
    when unset) and this one is `LOCAL_RANK` (the rank modulo that when
    unset); its GPU is `cuda:{local rank % device count}`, or the CPU when
    `device` is the CPU. Call it before any CUDA context exists."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("LEGUME_COORDINATOR")
    n = num_processes if num_processes is not None else os.environ.get("LEGUME_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("LEGUME_PROCESS_ID")
    if coordinator and n is not None and pid is not None:
        init_method, size, rank = f"tcp://{coordinator}", int(n), int(pid)
    elif os.environ.get("LEGUME_DISTRIBUTED") == "1":
        init_method = "env://"
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the data-parallel run asked for cuda, and this rank finds no GPU")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = choose_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=timeout)
    log.info("torch.distributed: rank %d/%d over %s (%s)", rank, size, init_method, backend)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group, if one is live."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# nnz-balanced shard planning
# ----------------------------------------------------------------------------


def column_nnz(vec) -> np.ndarray:
    """Per-column nonzero counts from backend metadata (no data reads)."""
    if hasattr(vec, "column_nnz"):
        out = vec.column_nnz()
        if out is not None:
            return np.asarray(out, np.int64)
    if hasattr(vec, "_backends"):  # SparseIoVec
        return np.concatenate([column_nnz(b) for b in vec._backends])
    if hasattr(vec, "_column_indptr"):
        return np.diff(vec._column_indptr()).astype(np.int64)
    if hasattr(vec, "_csc"):
        return np.diff(vec._csc.indptr).astype(np.int64)
    raise TypeError(f"cannot derive per-column nnz from {type(vec)!r}")


def plan_column_shards(col_nnz: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous [n_shards + 1] column bounds balancing the nonzeros of
    each shard (a prefix-sum split at equal-mass targets)."""
    col_nnz = np.asarray(col_nnz, np.int64)
    n = len(col_nnz)
    if n_shards >= n:  # at most one column a shard
        return np.concatenate([np.arange(n + 1), np.full(n_shards - n, n)]).astype(np.int64)
    # empty columns weigh a little, so all-zero stretches still spread
    w = col_nnz.astype(np.float64) + 1e-3
    cum = np.concatenate([[0.0], np.cumsum(w)])
    targets = cum[-1] * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    np.maximum.accumulate(bounds, out=bounds)
    return bounds


def block_bounds(n: int, block_size: int, parts: int) -> np.ndarray:
    """[parts + 1] bounds of a contiguous split of `n` columns at whole
    blocks of `block_size` (`data_sharding` of the blocks): each column
    lies in the block a one-rank pass over all `n` columns gives it."""
    per = -(-(-(-n // block_size)) // parts)
    return np.minimum(np.arange(parts + 1) * per * block_size, n).astype(np.int64)


# ----------------------------------------------------------------------------
# host collectives
# ----------------------------------------------------------------------------


def _gather(a: np.ndarray, group) -> list[np.ndarray]:
    """Every rank's same-shaped array, in rank order, through a gloo
    all_gather of CPU tensors."""
    a = np.ascontiguousarray(a)
    as_bytes = a.dtype == np.bool_
    t = torch.from_numpy(a.view(np.uint8) if as_bytes else a)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.numpy().view(np.bool_) if as_bytes else o.numpy() for o in out]


def _sum_in_rank_order(parts: list[np.ndarray], dtype) -> np.ndarray:
    out = parts[0].copy()
    for p in parts[1:]:
        out += p
    return out.astype(dtype, copy=False)


def _sum_across(mesh: Mesh, plane: np.ndarray) -> np.ndarray:
    if mesh.size == 1:
        return plane
    return _sum_in_rank_order(_gather(plane, mesh.host_group), plane.dtype)


def _gather_rows(local: np.ndarray, sizes, group) -> np.ndarray:
    """Every rank's rows concatenated in rank order, rank r holding
    `sizes[r]` rows (each padded to the widest for the gather)."""
    padded = np.zeros((max(max(int(s) for s in sizes), 1),) + local.shape[1:], local.dtype)
    padded[: local.shape[0]] = local
    parts = _gather(padded, group)
    return np.concatenate([p[: int(s)] for p, s in zip(parts, sizes)], axis=0)


def sum_across_ranks(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks in rank order (gathered on the host), on
    `t`'s device; `t` itself without a mesh or in a world of one."""
    if mesh is None or mesh.size == 1:
        return t
    a = t.detach().cpu().numpy()
    return torch.from_numpy(_sum_across(mesh, a).reshape(a.shape)).to(t.device)


def gather_shares(mesh: Mesh | None, local, sizes) -> np.ndarray:
    """Every rank's rows concatenated in rank order (rank r holds `sizes[r]`
    rows of `local`), on the host; `local` itself without a mesh."""
    local = local.detach().cpu().numpy() if isinstance(local, torch.Tensor) else np.asarray(local)
    if mesh is None or mesh.size == 1:
        return local
    return _gather_rows(local, sizes, mesh.host_group)


def gather_padded(mesh: Mesh | None, local, n: int) -> np.ndarray:
    """The first `n` rows of the equal shares of `padded_share`, gathered
    in rank order: the unpadded global array."""
    local = local.detach().cpu().numpy() if isinstance(local, torch.Tensor) else np.asarray(local)
    if mesh is None or mesh.size == 1:
        return local[:n]
    return np.concatenate(_gather(np.ascontiguousarray(local), mesh.host_group), axis=0)[:n]


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (nothing without a mesh or in a world of one)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.host_group)


# ----------------------------------------------------------------------------
# sharded collapse reduction
# ----------------------------------------------------------------------------


def _collapse_into(plane: torch.Tensor, rows, cols, vals, seg, *, ncols: int, num_groups: int):
    """Add one column-sorted COO shard into `plane` [D, S] through K3 (its
    plain version on the CPU); columns whose group is `num_groups` drop."""
    dev = plane.device
    ptr = np.searchsorted(np.asarray(cols), np.arange(ncols + 1)).astype(np.int32)
    kernels.collapse(
        torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(dev),
        torch.from_numpy(ptr).to(dev),
        torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(seg, np.int32)).to(dev),
        num_genes=plane.shape[0], num_groups=num_groups, out=plane,
    )


def collapse_stats_sharded(
    mesh: Mesh,
    row_ids: np.ndarray,  # [n_shards, nnz_pad] gene ids of each shard
    col_ids: np.ndarray,  # [n_shards, nnz_pad] LOCAL cell ids, sorted, pads at ncols_pad
    vals: np.ndarray,  # [n_shards, nnz_pad]
    seg_of_col: np.ndarray,  # [n_shards, ncols_pad + 1] group of each local cell
    *,
    num_genes: int,
    num_groups: int,
) -> np.ndarray:
    """observed_sum_ds [D, S]: this rank's shards of the stacked arrays
    (`data_sharding` of the shard axis) summed through K3, the planes then
    summed across ranks in rank order."""
    plane = torch.zeros(num_genes, num_groups, dtype=torch.float32, device=mesh.device)
    lb, ub = data_sharding(mesh, row_ids.shape[0])
    for s in range(lb, ub):
        _collapse_into(plane, row_ids[s], col_ids[s], vals[s], seg_of_col[s],
                       ncols=seg_of_col.shape[1], num_groups=num_groups)
    return _sum_across(mesh, plane.cpu().numpy())


def _local_shard_ids(n_dev: int, process_index: int, num_processes: int) -> list[int]:
    """Shard s lives on rank s // (n_dev / P): contiguous blocks per process."""
    per = n_dev // num_processes
    assert per * num_processes == n_dev, "shard count must divide by process count"
    return list(range(process_index * per, (process_index + 1) * per))


def collapse_observed_multihost(
    vec,
    groups: np.ndarray,  # [N] pseudobulk of each cell
    mesh: Mesh,
    *,
    num_groups: int | None = None,
    block_size: int = 8192,
    nnz_balanced: bool = True,
    shards_per_rank: int = 1,
    process_index: int | None = None,
    num_processes: int | None = None,
    read_log: list | None = None,
) -> np.ndarray:
    """Observed pseudobulk sums [D, S] of a backend, each rank reading
    only its own contiguous column shards (`shards_per_rank` of the
    `mesh.size * shards_per_rank`, nnz-balanced or of equal width) block by
    block through K3, the planes summed across ranks. `num_groups` must
    agree across ranks: pass it when trailing pseudobulks may be empty.

    `process_index` / `num_processes` default to the live rank view; a
    simulated view returns this process's partial plane, and `read_log`
    collects the `(lb, ub)` column ranges read. No shard is padded: the
    ranks sum [D, S] planes and need no common nnz width."""
    d = vec.num_rows
    n = vec.num_columns
    n_dev = mesh.size * shards_per_rank
    if num_groups is None:
        num_groups = int(groups.max()) + 1
    simulated = process_index is not None or num_processes is not None
    p_idx = mesh.rank if process_index is None else int(process_index)
    p_cnt = mesh.size if num_processes is None else int(num_processes)

    if nnz_balanced:
        bounds = plan_column_shards(column_nnz(vec), n_dev)
    else:
        bounds = np.linspace(0, n, n_dev + 1).astype(np.int64)

    groups = np.asarray(groups, np.int32)
    plane = torch.zeros(d, num_groups, dtype=torch.float32, device=mesh.device)
    for s in _local_shard_ids(n_dev, p_idx, p_cnt):
        for blk_lb in range(int(bounds[s]), int(bounds[s + 1]), block_size):
            blk_ub = min(blk_lb + block_size, int(bounds[s + 1]))
            if read_log is not None:
                read_log.append((blk_lb, blk_ub))
            coo = vec.read_columns_csc(np.arange(blk_lb, blk_ub)).tocoo()
            _collapse_into(plane, coo.row, coo.col, coo.data, groups[blk_lb:blk_ub],
                           ncols=blk_ub - blk_lb, num_groups=num_groups)
    local = plane.cpu().numpy()
    if simulated and p_cnt > 1:
        return local
    return _sum_across(mesh, local)


class DistContext:
    """Process-level sharding context of `senna topic`'s streaming
    pipeline under a process group of more than one rank: each rank
    streams only its own nnz-balanced contiguous cell range through
    projection, QC, statistics and the latent eval, and the small
    cross-rank syncs are explicit:

    - `allgather_rows`: per-cell planes (raw projection, QC fields,
      latents) concatenate in rank order, so every rank holds the global
      array;
    - `reduce_sums` / `reduce_stat`: [D, S] sufficient-statistic planes
      sum across ranks in rank order.

    Both gather every rank's array on the host (CPU tensors through a gloo
    group) and concatenate or sum there. The matched-statistics pass reads
    its queries' partner columns wherever they lie."""

    def __init__(self, process_index: int, process_count: int, group=None):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.group = group

    @classmethod
    def detect(cls) -> "DistContext | None":
        """A live context iff the world has more than one rank. Every rank
        calls it at the same point (it may make the gloo side group)."""
        rank, size = world()
        if size > 1:
            return cls(rank, size, host_group())
        return None

    @property
    def primary(self) -> bool:
        return self.process_index == 0

    # -- column plan ---------------------------------------------------

    def column_bounds(self, vec) -> np.ndarray:
        """Per-rank contiguous nnz-balanced bounds [P + 1]."""
        return plan_column_shards(column_nnz(vec), self.process_count)

    def local_range(self, bounds: np.ndarray) -> tuple[int, int]:
        return int(bounds[self.process_index]), int(bounds[self.process_index + 1])

    def local_view(self, vec, bounds: np.ndarray):
        """This rank's column-range view (reads stay inside the range)."""
        lb, ub = self.local_range(bounds)
        keep = np.zeros(vec.num_columns, bool)
        keep[lb:ub] = True
        return vec.subset_columns(keep)

    # -- collectives -----------------------------------------------------

    def allgather_rows(self, local: np.ndarray, bounds: np.ndarray) -> np.ndarray:
        """Concatenate the ranks' row blocks into the global [N, ...] array
        on every rank (pad to the widest range, gather, slice)."""
        local = np.asarray(local)
        lb, ub = self.local_range(bounds)
        if local.shape[0] != ub - lb:
            raise ValueError(f"rank {self.process_index} holds {local.shape[0]} rows "
                             f"of its range [{lb}, {ub})")
        return _gather_rows(local, np.diff(bounds), self.group)

    def reduce_sums(self, *arrays: np.ndarray) -> list[np.ndarray]:
        """Elementwise sums of same-shaped per-rank partials, in rank order."""
        out = []
        for a in arrays:
            a = np.asarray(a)
            out.append(_sum_in_rank_order(_gather(a, self.group), a.dtype))
        return out

    def reduce_stat(self, stat):
        """Sum every plane of a `CollapsedStat` across ranks."""
        (stat.observed_sum_ds, stat.imputed_sum_ds, stat.residual_sum_ds, stat.size_s,
         stat.observed_sum_db, stat.n_bs) = self.reduce_sums(
            stat.observed_sum_ds, stat.imputed_sum_ds, stat.residual_sum_ds, stat.size_s,
            stat.observed_sum_db, stat.n_bs)
        return stat

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def shard_coo_by_cells(csc, groups: np.ndarray, n_shards: int):
    """Split a CSC matrix into per-shard padded COO: contiguous column
    ranges of equal width, local cell ids, one shared nnz pad. Returns
    `(rows, cols, vals, segs)`, each with a leading shard axis."""
    import scipy.sparse as sp

    d, n = csc.shape
    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    shards = []
    max_nnz, max_cols = 1, 1
    for s in range(n_shards):
        lb, ub = bounds[s], bounds[s + 1]
        coo = sp.csc_matrix(csc[:, lb:ub]).tocoo()
        shards.append((coo, ub - lb, groups[lb:ub]))
        max_nnz = max(max_nnz, coo.nnz)
        max_cols = max(max_cols, ub - lb)

    num_groups = int(groups.max()) + 1
    rows = np.zeros((n_shards, max_nnz), np.int32)
    cols = np.full((n_shards, max_nnz), max_cols, np.int32)
    vals = np.zeros((n_shards, max_nnz), np.float32)
    segs = np.full((n_shards, max_cols + 1), num_groups, np.int32)
    for s, (coo, ncols, g) in enumerate(shards):
        rows[s, : coo.nnz] = coo.row
        cols[s, : coo.nnz] = coo.col
        vals[s, : coo.nnz] = coo.data
        segs[s, :ncols] = g
    return rows, cols, vals, segs
