"""Distributed layers of the port: the ring of devices that the TP ring
primitives (``fusion/overlap_mm.py``) and the compiled pipeline
(:mod:`.pipeline`) run over in one process, and the multi-process
runtime of sharded training: :func:`spawn`, :func:`init_parallel_env`,
the collectives, :class:`ProcessMesh` and the semi-auto surface
(:mod:`.auto_parallel`), the sharded layouts (:mod:`.sharding`) and
sequence-parallel attention (:mod:`.sequence_parallel`)."""
from . import collective, sequence_parallel, sharding
from .auto_parallel import (Partial, ProcessMesh, Replicate, Shard,
                            dtensor_from_local, get_mesh, local_value,
                            reshard, set_mesh, shard_tensor,
                            unshard_dtensor)
from .collective import (P2POp, all_gather, all_reduce, all_to_all,
                         barrier, batch_isend_irecv, broadcast, irecv, isend,
                         new_group, recv, reduce_scatter, send)
from .parallel_env import get_rank, get_world_size, init_parallel_env
from .ring import Ring
from .spawn import spawn

__all__ = ["Ring", "spawn", "init_parallel_env", "get_rank",
           "get_world_size", "all_reduce", "all_gather", "all_to_all",
           "broadcast", "reduce_scatter", "barrier", "new_group", "send",
           "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "ProcessMesh", "get_mesh", "set_mesh", "Shard", "Replicate",
           "Partial", "shard_tensor", "dtensor_from_local", "reshard",
           "unshard_dtensor", "local_value", "collective", "sharding",
           "sequence_parallel"]
