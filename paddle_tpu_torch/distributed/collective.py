"""The collectives of a multi-process run, over ``torch.distributed``.

Port of the calls of ``paddle_tpu/distributed/collective.py`` that the
sharded training step and sequence parallelism use (``all_reduce``,
``all_gather``, ``all_to_all``, ``broadcast``, ``reduce_scatter``,
``barrier``, ``new_group``, and the point-to-point ``send``, ``recv``,
``isend``, ``irecv``, ``batch_isend_irecv``), with Paddle's argument
order. The collectives work in place on their tensors and wait for the
result; ``isend`` / ``irecv`` / ``batch_isend_irecv`` return the
requests to ``wait()`` on. ``group=None`` is every rank; a peer is a
global rank. These are not autograd functions: the differentiable
forms the models use live in :mod:`.sharding` and
:mod:`.sequence_parallel`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import _REDUCE_SCATTER

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_to_all",
           "broadcast", "reduce_scatter", "barrier", "new_group", "send",
           "recv", "isend", "irecv", "P2POp", "batch_isend_irecv"]

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


def all_to_all(out_tensor_list: List[torch.Tensor],
               in_tensor_list: Sequence[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """Send ``in_tensor_list[i]`` to the group's i-th member and fill
    ``out_tensor_list`` (emptied first) with what each member sent this
    one, in group-rank order; returns it."""
    ins = [t.contiguous() for t in in_tensor_list]
    out = [torch.empty_like(t) for t in ins]
    dist.all_to_all(out, ins, group=group)
    out_tensor_list.clear()
    out_tensor_list.extend(out)
    return out_tensor_list


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


def send(tensor: torch.Tensor, dst: int = 0, group=None) -> None:
    """Send ``tensor`` to global rank ``dst`` and wait until it left."""
    dist.send(tensor.contiguous(), dst, group=group)


def recv(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Receive into ``tensor`` (contiguous) from global rank ``src``;
    returns it."""
    dist.recv(tensor, src, group=group)
    return tensor


def isend(tensor: torch.Tensor, dst: int, group=None):
    """Start sending ``tensor`` to global rank ``dst``; returns the
    request (``wait()`` before ``tensor`` is written again)."""
    return dist.isend(tensor, dst, group=group)


def irecv(tensor: torch.Tensor, src: Optional[int] = None, group=None):
    """Start receiving into ``tensor`` from global rank ``src``; returns
    the request (``wait()`` before reading ``tensor``)."""
    return dist.irecv(tensor, src, group=group)


class P2POp:
    """One point-to-point operation of :func:`batch_isend_irecv`: ``op``
    is :func:`isend` or :func:`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor: torch.Tensor, peer: int, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp takes isend or irecv, got %r" % (op,))
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list: Sequence[P2POp]) -> list:
    """Start every send and receive of the list together (NCCL groups
    them, so a pair of ranks may send to each other without a
    deadlock); returns the requests, one an operation."""
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend if op.op is isend else dist.irecv,
                   op.tensor, op.peer, op.group) for op in p2p_op_list])


def barrier(group=None) -> None:
    dist.barrier(group=group)


def new_group(ranks: Optional[Sequence[int]] = None, backend=None):
    """A process group of ``ranks`` (every rank when None). Every rank
    of the run must call it, members or not, in the same order."""
    return dist.new_group(ranks=None if ranks is None else list(ranks),
                          backend=backend)
