"""Pipeline parallelism over a ring of devices: :func:`ring_shift` (the
stage-boundary hop, K10 on the card) and :class:`CompiledPipeline` (the
1F1B micro-batch schedule)."""
from .schedule import CompiledPipeline
from .transport import ring_shift

__all__ = ["CompiledPipeline", "ring_shift"]
