"""The multi-GPU layer on `torch.distributed`: one rank per GPU."""

from .mesh import data_sharding, make_mesh, replicate, shard_rows
