"""The collectives of a multi-process run, over ``torch.distributed``.

Port of the calls of ``paddle_tpu/distributed/collective.py`` that the
sharded training step uses (``all_reduce``, ``all_gather``,
``broadcast``, ``reduce_scatter``, ``barrier``, ``new_group``), with
Paddle's argument order; each works in place on its tensors and waits
for the result. ``group=None`` is every rank. These are not autograd
functions: the differentiable forms the models use live in
:mod:`.sharding`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import _REDUCE_SCATTER

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast",
           "reduce_scatter", "barrier", "new_group"]

ReduceOp = dist.ReduceOp

_OPS = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX, "min": ReduceOp.MIN}


def _op(op):
    return _OPS[op] if isinstance(op, str) else op


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """Reduce ``tensor`` over ``group`` in place (``op``: a ReduceOp or
    "sum" / "max" / "min"); returns it."""
    dist.all_reduce(tensor, op=_op(op), group=group)
    return tensor


def all_gather(tensor_list: List[torch.Tensor], tensor: torch.Tensor,
               group=None) -> List[torch.Tensor]:
    """Fill ``tensor_list`` (emptied first) with every rank's
    ``tensor``, in rank order; returns it."""
    n = dist.get_world_size(group)
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor.contiguous(), group=group)
    tensor_list.clear()
    tensor_list.extend(out)
    return tensor_list


def broadcast(tensor: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``tensor`` of global rank ``src`` into every rank's, in place."""
    dist.broadcast(tensor, src, group=group)
    return tensor


def reduce_scatter(tensor: torch.Tensor, tensor_list: Sequence[torch.Tensor],
                   op=ReduceOp.SUM, group=None) -> torch.Tensor:
    """``tensor`` = the reduction over ``group`` of every rank's
    ``tensor_list[i]``, i this rank's index in the group."""
    flat = torch.stack([t.contiguous() for t in tensor_list])
    n = len(tensor_list)
    _REDUCE_SCATTER(tensor, flat.view((n * flat.shape[1],) + tuple(
        flat.shape[2:]) if flat.dim() > 1 else (n,)), op=_op(op), group=group)
    return tensor


def barrier(group=None) -> None:
    dist.barrier(group=group)


def new_group(ranks: Optional[Sequence[int]] = None, backend=None):
    """A process group of ``ranks`` (every rank when None). Every rank
    of the run must call it, members or not, in the same order."""
    return dist.new_group(ranks=None if ranks is None else list(ranks),
                          backend=backend)
