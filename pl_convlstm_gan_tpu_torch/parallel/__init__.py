"""Data and tensor parallelism over ``torch.distributed``: the process group's
bootstrap and the data, model and DP x TP groups (``mesh``), the data-parallel
train steps of the three families (``train_parallel``), the channel-sharded
layout of the ConvLSTM cells (``tensor_parallel``) and its collectives
(``tp_collectives``), counterparts of the JAX package's ``parallel/mesh.py``,
``parallel/train_parallel.py`` and ``parallel/tensor_parallel.py``."""
from .mesh import (MeshGroups, as_groups, barrier, broadcast_module,
                   is_primary, maybe_init_distributed, mesh_position, print0,
                   rank_and_world, train_group)

__all__ = ["MeshGroups", "as_groups", "barrier", "broadcast_module",
           "is_primary", "maybe_init_distributed", "mesh_position", "print0",
           "rank_and_world", "train_group"]
