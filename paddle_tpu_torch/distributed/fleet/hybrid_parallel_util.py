"""Gradient and parameter synchronisation over a hybrid group.

Port of ``paddle_tpu/distributed/fleet/hybrid_parallel_util.py``:
:func:`fused_allreduce_gradients_with_group` averages the gradients of
a parameter list over a group, flattened into buckets of up to
``bucket_bytes`` a dtype (one all-reduce a bucket, the eager reducer's
scheme); :func:`fused_allreduce_gradients` does it over the data-parallel
group of a :class:`~.topology.HybridCommunicateGroup`; the
``broadcast_*_parameters`` copy the group's source rank's parameters
into every member.

The gradient of a parameter is :func:`~...optimizer.optimizers.grad_of`
(the pipeline's f32 ``main_grad``, else ``.grad``). Every gradient is
averaged, mp-split ones too: the data-parallel replicas of an mp rank
hold the same piece. A model-parallel broadcast skips the mp-split
parameters (``is_distributed``: each rank's piece is its own).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...optimizer.optimizers import grad_of
from .mp_layers import is_distributed

__all__ = ["fused_allreduce_gradients", "broadcast_dp_parameters",
           "broadcast_mp_parameters", "broadcast_sharding_parameters",
           "fused_allreduce_gradients_with_group"]

_FUSE_BYTES = 128 * 1024 * 1024  # bucket size of the fused all-reduce


@torch.no_grad()
def fused_allreduce_gradients_with_group(params, group, scale=None,
                                         bucket_bytes=None):
    """Average the gradients of ``params`` over ``group`` (``scale``:
    multiply by it instead of dividing by the group's size)."""
    if group is None or dist.get_world_size(group) == 1:
        return
    bucket_bytes = _FUSE_BYTES if bucket_bytes is None else bucket_bytes
    scale = 1.0 / dist.get_world_size(group) if scale is None else scale
    buckets = {}
    for p in params:
        g = grad_of(p)
        if g is not None:
            buckets.setdefault((g.dtype, g.device), []).append(g)
    for grads in buckets.values():
        cur, nbytes = [], 0
        for i, g in enumerate(grads):
            cur.append(g)
            nbytes += g.numel() * g.element_size()
            if nbytes >= bucket_bytes or i == len(grads) - 1:
                flat = torch.cat([x.reshape(-1) for x in cur])
                dist.all_reduce(flat, group=group)
                flat.mul_(scale)
                off = 0
                for x in cur:
                    x.copy_(flat[off:off + x.numel()].view_as(x))
                    off += x.numel()
                cur, nbytes = [], 0


def fused_allreduce_gradients(parameter_list, hcg):
    """Average the gradients over the data-parallel group (the dp x sep
    group where sep has more than one rank)."""
    if hcg is None:
        return
    group = hcg.get_dp_sep_parallel_group() \
        if hcg.get_sep_parallel_world_size() > 1 \
        else hcg.get_data_parallel_group()
    fused_allreduce_gradients_with_group(list(parameter_list), group)


@torch.no_grad()
def _broadcast_parameters(model, group, src_rank, skip_distributed):
    if group is None:
        return
    for p in model.parameters():
        if skip_distributed and is_distributed(p):
            continue
        dist.broadcast(p.data, src_rank, group=group)


def broadcast_dp_parameters(model, hcg):
    _broadcast_parameters(model, hcg.get_data_parallel_group(),
                          hcg.get_data_parallel_group_src_rank(), False)


def broadcast_mp_parameters(model, hcg):
    _broadcast_parameters(model, hcg.get_model_parallel_group(),
                          hcg.get_model_parallel_group_src_rank(), True)


def broadcast_sharding_parameters(model, hcg):
    _broadcast_parameters(model, hcg.get_sharding_parallel_group(),
                          hcg.get_sharding_parallel_group_src_rank(), False)
