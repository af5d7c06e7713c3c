"""Distributed layers of the port: the ring of devices that the TP ring
primitives (``fusion/overlap_mm.py``) and the compiled pipeline
(:mod:`.pipeline`) run over in one process, and the multi-process
runtime of sharded training: :func:`spawn`, :func:`init_parallel_env`,
the collectives, :class:`ProcessMesh` and the semi-auto surface
(:mod:`.auto_parallel`), and the sharded layouts (:mod:`.sharding`)."""
from . import collective, sharding
from .auto_parallel import (Partial, ProcessMesh, Replicate, Shard,
                            dtensor_from_local, get_mesh, local_value,
                            reshard, set_mesh, shard_tensor,
                            unshard_dtensor)
from .collective import (all_gather, all_reduce, barrier, broadcast,
                         new_group, reduce_scatter)
from .parallel_env import get_rank, get_world_size, init_parallel_env
from .ring import Ring
from .spawn import spawn

__all__ = ["Ring", "spawn", "init_parallel_env", "get_rank",
           "get_world_size", "all_reduce", "all_gather",
           "broadcast", "reduce_scatter", "barrier", "new_group",
           "ProcessMesh", "get_mesh", "set_mesh", "Shard", "Replicate",
           "Partial", "shard_tensor", "dtensor_from_local", "reshard",
           "unshard_dtensor", "local_value", "collective", "sharding"]
