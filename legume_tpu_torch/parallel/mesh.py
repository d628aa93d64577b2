"""The mesh of the multi-GPU layer (the port of the JAX package's
`parallel/mesh.py`) on `torch.distributed`.

PyTorch runs one process per GPU, so the mesh is the world of ranks: the
data axis (`dp`) is the world, each rank holds one device, and rows (cells,
pseudobulks) split into one contiguous range a rank. A process without a
process group is a world of one and runs the code a plain run runs. The
JAX package's single-process mesh over several local devices is not
carried over: a host with n GPUs runs n ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "dp"
GENE_AXIS = "tp"


@dataclass(frozen=True)
class Mesh:
    """The world of ranks as one data axis: `size` ranks, this one
    `rank`, on `device`. `group` is the process group of the trainer's
    device collectives (None in a world of one) and `host_group` the gloo
    group of the host collectives (None: the default group, which is
    gloo). `shape` maps each axis to its size, as a JAX mesh does."""

    size: int
    rank: int
    device: torch.device
    shape: dict
    group: object = None
    host_group: object = None

    @property
    def primary(self) -> bool:
        return self.rank == 0


def world() -> tuple[int, int]:
    """(rank, size) of the live process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_group():
    """The group the host collectives run on: None (the default group)
    when that is gloo, else a gloo group over the same ranks (gloo's
    `all_gather` takes CPU tensors only, NCCL's CUDA tensors only).
    Every rank calls it at the same point, as `new_group` requires."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def make_mesh(device="cuda", *, gene_parallel: int = 1) -> Mesh:
    """The mesh over the world, this rank on `device` ("cuda" names the
    rank's current device). A rank asked for cuda that finds no GPU
    raises; it does not carry on on the CPU."""
    rank, size = world()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the data-parallel run asked for cuda, and this rank finds no GPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    shape = {DATA_AXIS: size}
    if gene_parallel > 1:
        assert size % gene_parallel == 0
        shape = {DATA_AXIS: size // gene_parallel, GENE_AXIS: gene_parallel}
    if size == 1:
        return Mesh(size=1, rank=0, device=device, shape=shape)
    return Mesh(size=size, rank=rank, device=device, shape=shape, group=dist.group.WORLD,
                host_group=host_group())


def data_sharding(mesh: Mesh, n: int) -> tuple[int, int]:
    """This rank's rows `[lb, ub)` of `n` along the data axis: the rows
    padded to a multiple of the axis, an equal share each, and the padding
    taken off the end again, so the last shares may be shorter or empty."""
    dp = mesh.shape[DATA_AXIS]
    index = mesh.rank // (mesh.size // dp)
    per = -(-n // dp)
    lb = min(index * per, n)
    return lb, min(lb + per, n)


def share_sizes(mesh: Mesh, n: int) -> list[int]:
    """The rows of `n` each rank holds under `data_sharding`, in rank order."""
    dp = mesh.shape[DATA_AXIS]
    per = -(-n // dp)
    return [min(per, max(n - (r // (mesh.size // dp)) * per, 0)) for r in range(mesh.size)]


def live(mesh: Mesh | None) -> Mesh | None:
    """`mesh` when it spans more than one rank, else None: `mesh=None` and
    a world of one run the same code, the plain run's."""
    return mesh if mesh is not None and mesh.size > 1 else None


def padded_share(mesh: Mesh | None, n: int) -> tuple[int, int, int]:
    """`(n_pad, lb, ub)`: `n` rows padded to a multiple of the data axis,
    as the JAX package pads an axis it shards, and this rank's equal share
    `[lb, ub)` of the padded rows (`(n, 0, n)` without a mesh)."""
    if mesh is None:
        return n, 0, n
    dp = mesh.shape[DATA_AXIS]
    per = -(-n // dp)
    index = mesh.rank // (mesh.size // dp)
    return per * dp, index * per, (index + 1) * per


def shard_rows(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's rows of `arr` on its device, zero-padded to the full
    share of `data_sharding`."""
    a = torch.as_tensor(np.asarray(arr))
    lb, ub = data_sharding(mesh, a.shape[0])
    per = -(-a.shape[0] // mesh.shape[DATA_AXIS])
    out = torch.zeros((per,) + tuple(a.shape[1:]), dtype=a.dtype, device=mesh.device)
    out[: ub - lb] = a[lb:ub].to(mesh.device)
    return out


class _SumAcrossRanks(torch.autograd.Function):
    """An all_reduce (sum) whose backward sums the gradients across ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_grads_(mesh: Mesh, tensors) -> None:
    """Sum `tensors` (gradients) across the ranks in place: one flat
    all_reduce on the mesh's group, as the data-parallel trainer sums its
    gradients (`models/train.py`)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for t in tensors:
        t.copy_(flat[off : off + t.numel()].view_as(t))
        off += t.numel()


def row_moments(x: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over the rows (dim 0) of `x` on every rank
    together, as XLA forms a batch statistic over a sharded batch: the
    ranks' sums of x, x^2 and rows, summed across ranks."""
    h = x.shape[1]
    local = torch.cat([x.sum(dim=0), (x * x).sum(dim=0), x.new_full((1,), x.shape[0])])
    total = _SumAcrossRanks.apply(local, mesh.group)
    mean = total[:h] / total[-1]
    return mean, torch.clamp(total[h : 2 * h] / total[-1] - mean * mean, min=0.0)


def replicate(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's values of `t` on every rank, in place."""
    if mesh.size > 1:
        dist.broadcast(t, src=0, group=mesh.group)
    return t
