"""The fleet facade: ``fleet.init`` and the wrappers it hands out.

Port of ``paddle_tpu/distributed/fleet/fleet.py`` for collective runs:
:func:`init` joins the process group (the port's
:func:`~paddle_tpu_torch.distributed.init_parallel_env`: NCCL on a card,
gloo on the CPU) when the run has more than one rank, lays the ranks out
by ``strategy.hybrid_configs`` and makes the
:class:`~.topology.HybridCommunicateGroup`; :func:`distributed_model`
wraps a model by the run's parallel mode (``PipelineParallel`` for
``pp > 1``, ``TensorParallel`` for ``mp > 1``, ``ShardingParallel`` for
``sharding > 1``) after routing the sublayers named in
``strategy.recompute_configs["checkpoints"]`` through
:func:`.recompute.recompute`; :func:`distributed_optimizer` wraps an
optimizer in :class:`.HybridParallelOptimizer`, which shards it over the
sharding group (stage 1) at its first step; with ``strategy.sharding``
and ``sharding_configs={"stage": 2}`` it wraps the stage-2 optimizer
(:class:`.sharding_optimizer.GroupShardedOptimizerStage2`) first.

The role makers and the parameter-server mode are not ported
(``ROADMAP.md``): ``init`` raises for a non-collective run, and so does
``distributed_model`` for pure data parallelism (the port has no eager
``DataParallel``; ``PipelineParallel`` reduces over ``dp`` itself).
"""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ..parallel_env import get_rank, get_world_size, init_parallel_env
from .distributed_strategy import DistributedStrategy, unported
from .topology import CommunicateTopology, HybridCommunicateGroup, ParallelMode

__all__ = ["init", "Fleet", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "worker_num",
           "worker_index", "is_first_worker", "barrier_worker"]

_fleet: Optional["Fleet"] = None
_hcg: Optional[HybridCommunicateGroup] = None

_NAMES = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
          "mp": "model"}


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


def _apply_strategy_to_model(model, strategy):
    """``strategy.recompute``: each sublayer named in
    ``recompute_configs["checkpoints"]`` runs its forward under
    :func:`.recompute.recompute` (its activations rebuilt in the
    backward)."""
    if strategy is None or not strategy.recompute:
        return model
    from .recompute import recompute

    ckpts = set(strategy.recompute_configs.get("checkpoints") or [])
    for name, sub in model.named_modules():
        if name in ckpts and not getattr(sub, "_fleet_recompute", False):
            orig = sub.forward

            def wrapped(*a, __orig=orig, **kw):
                return recompute(__orig, *a, **kw)

            sub.forward = wrapped
            sub._fleet_recompute = True
    return model


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", device=None):
        """Join the run (``device``: ``"cuda"`` by default, ``"cpu"`` for
        gloo) and build the hybrid topology of ``strategy``."""
        global _hcg
        if role_maker is not None or not is_collective:
            raise unported("the role makers and the parameter-server mode")
        self._strategy = (strategy or DistributedStrategy()).check()
        if dist.is_initialized() or int(os.environ.get("WORLD_SIZE",
                                                       1)) > 1:
            init_parallel_env(device)
        self._init_hybrid_parallel_env()
        _hcg = self._hcg
        return self

    def _init_hybrid_parallel_env(self):
        hc = self._strategy.hybrid_configs
        order = hc.get("order", ["dp", "pp", "sharding", "sep", "mp"])
        degrees = {o: max(int(hc.get(o + "_degree", 1)), 1) for o in _NAMES}
        world = get_world_size()
        rest = 1
        for o in order:
            if o != "dp":
                rest *= degrees[o]
        if rest * degrees["dp"] != world and world % rest == 0:
            # dp takes the ranks the other degrees leave, as in the
            # reference
            degrees["dp"] = world // rest
        self.dp_degree, self.mp_degree = degrees["dp"], degrees["mp"]
        self.pp_degree = degrees["pp"]
        self.sharding_degree = degrees["sharding"]
        self.sep_degree = degrees["sep"]
        self._topology = CommunicateTopology([_NAMES[o] for o in order],
                                             [degrees[o] for o in order])
        self._hcg = HybridCommunicateGroup(self._topology)

    @property
    def strategy(self):
        return self._strategy

    def get_hybrid_communicate_group(self):
        return self._hcg

    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        if dist.is_initialized():
            dist.barrier()

    def distributed_model(self, model):
        from .meta_parallel import (PipelineParallel, ShardingParallel,
                                    TensorParallel)

        if self._strategy is not None:
            self._strategy.check()
        model = _apply_strategy_to_model(model, self._strategy)
        if self._hcg is None:
            return model
        mode = self._hcg.get_parallel_mode()
        if mode == ParallelMode.PIPELINE_PARALLEL:
            return PipelineParallel(model, self._hcg,
                                    strategy=self._strategy)
        if mode == ParallelMode.TENSOR_PARALLEL:
            return TensorParallel(model, self._hcg, strategy=self._strategy)
        if mode == ParallelMode.SHARDING_PARALLEL:
            return ShardingParallel(model, self._hcg,
                                    strategy=self._strategy)
        if self._hcg.get_data_parallel_world_size() > 1:
            raise unported("pure data parallelism (an eager DataParallel)")
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .hybrid_parallel_optimizer import HybridParallelOptimizer

        strategy = strategy or self._strategy
        if strategy is not None:
            strategy.check()
        if self._hcg is None:
            return optimizer
        if strategy is not None and strategy.sharding and int(
                strategy.sharding_configs.get("stage", 1)) == 2:
            if strategy.gradient_merge:
                # stage 2 reduces each backward's gradients from hooks;
                # with clear_grad deferred mid-merge every micro-step
                # would re-reduce (and re-average) the accumulated ones
                raise ValueError(
                    "gradient_merge cannot compose with sharding stage 2 "
                    "(hook-based reduction re-reduces accumulated grads); "
                    "use sharding stage 1 or the compiled "
                    "TrainStep(accumulate_steps=k) path")
            if self._hcg.get_sharding_parallel_world_size() > 1:
                from .sharding_optimizer import GroupShardedOptimizerStage2

                optimizer = GroupShardedOptimizerStage2(
                    list(optimizer._parameter_list), optimizer,
                    group=self._hcg.get_sharding_parallel_group())
        return HybridParallelOptimizer(optimizer, self._hcg, strategy)


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", device=None):
    return _get_fleet().init(role_maker, is_collective, strategy, log_level,
                             device)


def _get_fleet() -> Fleet:
    global _fleet
    if _fleet is None:
        _fleet = Fleet()
    return _fleet


def distributed_model(model):
    return _get_fleet().distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return _get_fleet().distributed_optimizer(optimizer, strategy)


def worker_num():
    return _get_fleet().worker_num()


def worker_index():
    return _get_fleet().worker_index()


def is_first_worker():
    return _get_fleet().is_first_worker()


def barrier_worker():
    return _get_fleet().barrier_worker()
