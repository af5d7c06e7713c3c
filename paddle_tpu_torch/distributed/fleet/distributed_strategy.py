"""DistributedStrategy: the knobs of a fleet run.

Port of ``paddle_tpu/distributed/fleet/distributed_strategy.py``: a
plain tree of the reference's field names (``hybrid_configs``,
``pipeline_configs``, ``recompute`` / ``recompute_configs``,
``gradient_merge`` / ``gradient_merge_configs``, ...).

The port honours the hybrid degrees ``dp``, ``pp``, ``sharding`` and
``mp`` (in any ``order``), ``sharding`` with ``sharding_configs``'
``stage``, the pipeline's ``accumulate_steps``, recompute of the named
sublayers and gradient merge. :meth:`DistributedStrategy.check` raises
``NotImplementedError`` for a field it cannot honour yet (``amp``,
``sep_degree > 1``, ``lamb``, ``dgc``, ``a_sync``, ``auto``,
``heter_ccl_mode``); ``fleet.init``, ``distributed_model`` and
``distributed_optimizer`` call it.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]

# switches the port does not honour yet, and what they are
_UNPORTED_FLAGS = {
    "amp": "fleet amp (auto_cast of the model, HybridParallelGradScaler)",
    "lamb": "the LAMB meta-optimizer",
    "dgc": "deep gradient compression",
    "a_sync": "the parameter-server mode",
    "auto": "the auto-parallel strategy search",
    "heter_ccl_mode": "heterogeneous collectives",
}
_UNPORTED_DEGREES = {"sep_degree": "segment parallelism (SegmentParallel)"}


def unported(what: str) -> NotImplementedError:
    return NotImplementedError("%s is not ported yet: see ROADMAP.md"
                               % what)


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 65536.0,
            "use_pure_fp16": False,
            "use_pure_bf16": False,
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.lamb = False
        self.dgc = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.heter_ccl_mode = False
        self.auto = False
        self.a_sync = False

    def check(self) -> "DistributedStrategy":
        """Raise ``NotImplementedError`` for a field the port cannot
        honour yet; returns the strategy."""
        for name, what in _UNPORTED_FLAGS.items():
            if getattr(self, name, False):
                raise unported("strategy.%s (%s)" % (name, what))
        for name, what in _UNPORTED_DEGREES.items():
            if max(int(self.hybrid_configs.get(name, 1)), 1) > 1:
                raise unported("%s > 1 (%s)" % (name, what))
        return self

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()}
        return f"DistributedStrategy({fields})"
