"""Data parallelism over ``torch.distributed``: the process group's bootstrap
and the data group (``mesh``), and the data-parallel train steps of the three
families (``train_parallel``), counterparts of the JAX package's
``parallel/mesh.py`` and ``parallel/train_parallel.py``."""
from .mesh import (barrier, broadcast_module, data_group, is_primary,
                   maybe_init_distributed, print0, rank_and_world)

__all__ = ["barrier", "broadcast_module", "data_group", "is_primary",
           "maybe_init_distributed", "print0", "rank_and_world"]
