"""paddle_tpu_torch.distributed.fleet: the eager hybrid-parallel API.

Port of ``paddle_tpu/distributed/fleet/__init__.py`` for the slice the
port holds: ``fleet.init`` over a :class:`DistributedStrategy`, the
:class:`HybridCommunicateGroup` of the ``dp`` x ``pp`` x ``sharding`` x
``mp`` ranks, the Megatron layers (:mod:`.mp_layers`), the pipeline
engine (:mod:`.meta_parallel`: 1F1B, interleaved, zero-bubble), group
sharding (:mod:`.sharding_optimizer`, ZeRO stages 1-3, and
:class:`ShardingParallel`), recompute, gradient synchronisation
(:mod:`.hybrid_parallel_util`) and :class:`HybridParallelOptimizer`. One
process a rank (:func:`paddle_tpu_torch.distributed.spawn`);
``fleet.init(..., device="cpu")`` runs the ranks over gloo, the default
over NCCL, a card a rank.

Not ported yet (``ROADMAP.md``): ``sequence_parallel_utils``, the role
makers and data generators (``base_role``), elastic training,
``SegmentParallel``, fleet amp and ``HybridParallelGradScaler``.
"""
from . import hybrid_parallel_util, meta_parallel, sharding_optimizer
from .distributed_strategy import DistributedStrategy
from .fleet import (Fleet, barrier_worker, distributed_model,
                    distributed_optimizer, get_hybrid_communicate_group,
                    init, is_first_worker, worker_index, worker_num)
from .hybrid_parallel_optimizer import HybridParallelOptimizer
from .meta_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                            PipelineParallelWithInterleave,
                            PipelineParallelZeroBubble, SharedLayerDesc,
                            ShardingParallel, TensorParallel)
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .recompute import recompute, recompute_sequential
from .topology import CommunicateTopology, HybridCommunicateGroup, ParallelMode


class _Utils:
    hybrid_parallel_util = hybrid_parallel_util


utils = _Utils()


class _MPU:
    VocabParallelEmbedding = VocabParallelEmbedding
    ColumnParallelLinear = ColumnParallelLinear
    RowParallelLinear = RowParallelLinear
    ParallelCrossEntropy = ParallelCrossEntropy


class _Layers:
    mpu = _MPU()


layers = _Layers()

__all__ = ["DistributedStrategy", "Fleet", "init", "barrier_worker",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "is_first_worker",
           "worker_index", "worker_num", "CommunicateTopology",
           "HybridCommunicateGroup", "ParallelMode", "meta_parallel",
           "recompute", "recompute_sequential", "ColumnParallelLinear",
           "ParallelCrossEntropy", "RowParallelLinear",
           "VocabParallelEmbedding", "LayerDesc", "PipelineLayer",
           "PipelineParallel", "PipelineParallelWithInterleave",
           "PipelineParallelZeroBubble", "SharedLayerDesc",
           "TensorParallel", "ShardingParallel", "sharding_optimizer",
           "hybrid_parallel_util",
           "HybridParallelOptimizer", "utils", "layers"]
