"""Megatron-style tensor-parallel layers over the model-parallel group.

Port of ``paddle_tpu/distributed/fleet/mp_layers.py``. Each layer holds
this rank's piece of the full matrix and runs the collectives of
:mod:`..sharding`:

- :class:`VocabParallelEmbedding`: rows ``[vocab / mp, h]`` of the
  table; a masked lookup summed over the group
  (:func:`~..sharding.vocab_parallel_embedding`).
- :class:`ColumnParallelLinear`: ``W [in, out / mp]`` (and its bias);
  the input enters by :func:`~..sharding.copy_to` (its gradient summed
  over the group); with ``gather_output`` the pieces of the output are
  all-gathered on the last dim (the gradient takes this rank's slice).
- :class:`RowParallelLinear`: ``W [in / mp, out]``; the products are
  summed by :func:`~..sharding.reduce_from`, then the bias is added
  once; without ``input_is_parallel`` the input's last dim is cut to
  this rank's part first (the gradient gathered back).
- :class:`ParallelCrossEntropy`: the cross entropy of logits split over
  the vocabulary, a loss a token: the global max (no gradient), the sum
  of exponentials and the target's logit summed over the group, in f32.

An mp-split parameter carries ``is_distributed = True`` and
``split_axis`` (the dim the group splits: 1 for a column-parallel
weight, 0 for its bias, a row-parallel weight and the embedding), which
the hybrid clip, the hybrid optimizer and
:func:`paddle_tpu_torch.convert.fleet_params` read. The
group is ``mp_group`` or the fleet's model-parallel group; without one
(``mp 1``) every layer is its plain single-process form.

Layers are built on ``device`` (``cuda`` unless ``"cpu"`` is asked
for) in ``dtype``; the weights are drawn Xavier-normal (over the
piece's shape, as the JAX layers draw them) from the device's
generator of :mod:`paddle_tpu_torch.core.random` (``paddle_tpu_torch.
seed(n)``), the biases zero.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...core import random as _random
from ...device import resolve_device
from ..sharding import (_all_gather, _merge, copy_to, reduce_from,
                        vocab_parallel_embedding)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "is_distributed"]


def is_distributed(p: torch.Tensor) -> bool:
    """Whether ``p`` is an mp-split piece: its ``is_distributed``
    attribute (``torch.Tensor`` has a method of that name, which an
    unmarked tensor would answer with)."""
    return p.__dict__.get("is_distributed", False) is True


def _mp_group(mp_group):
    """``(group or None, world size, rank)``: ``mp_group`` or the
    fleet's model-parallel group; None where it has one rank."""
    if mp_group is None:
        from .fleet import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        mp_group = hcg.get_model_parallel_group() if hcg else None
    if mp_group is None or dist.get_world_size(mp_group) == 1:
        return None, 1, 0
    return mp_group, dist.get_world_size(mp_group), dist.get_rank(mp_group)


def _parameter(shape, device, dtype, split_axis=None, xavier=True):
    """A parameter of ``shape``: Xavier-normal (fan in, fan out = its
    first and last dims) from the device's generator, or zeros."""
    dev = resolve_device(device)
    p = torch.empty(shape, device=dev, dtype=dtype or torch.float32)
    with torch.no_grad():
        if xavier:
            std = math.sqrt(2.0 / (shape[0] + shape[-1]))
            p.normal_(0.0, std, generator=_random.generator(dev))
        else:
            p.zero_()
    p = nn.Parameter(p)
    p.is_distributed = split_axis is not None
    if split_axis is not None:
        p.split_axis = split_axis
    return p


class _GatherLast(torch.autograd.Function):
    """All-gather of the group's pieces on the last dim; the gradient
    (the same on every rank: what follows is replicated) takes this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _merge(_all_gather(x, group), x.dim() - 1, 1)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, -1)[r].contiguous(), None


class _SplitLast(torch.autograd.Function):
    """This rank's part of the last dim; the gradient all-gathered (the
    input is replicated, each rank's part feeds its own rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, -1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _merge(_all_gather(g, ctx.group), g.dim() - 1, 1), None


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocabulary split over the mp group: this rank
    holds rows ``[rank * vocab / mp, (rank + 1) * vocab / mp)``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group, self.world_size, self.rank = _mp_group(mp_group)
        if num_embeddings % self.world_size:
            raise ValueError("vocabulary %d does not split over mp=%d"
                             % (num_embeddings, self.world_size))
        self.origin_num_embeddings = num_embeddings
        self.per_part_size = num_embeddings // self.world_size
        self.vocab_start_index = self.rank * self.per_part_size
        self.weight = _parameter(
            (self.per_part_size, embedding_dim), device, dtype,
            split_axis=0 if self.group is not None else None)

    def forward(self, x):
        return vocab_parallel_embedding(x, self.weight, self.group)


class ColumnParallelLinear(nn.Module):
    """``y = x @ W + b`` with ``W [in, out / mp]``: this rank's columns;
    ``gather_output`` gives every rank the whole ``y``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group, self.world_size, self.rank = _mp_group(mp_group)
        if out_features % self.world_size:
            raise ValueError("out_features %d does not split over mp=%d"
                             % (out_features, self.world_size))
        self.gather_output = gather_output
        self.out_per_part = out_features // self.world_size
        split = 1 if self.group is not None else None
        self.weight = _parameter((in_features, self.out_per_part), device,
                                 dtype, split_axis=split)
        self.bias = _parameter((self.out_per_part,), device, dtype,
                               split_axis=None if split is None else 0,
                               xavier=False) if has_bias else None

    def forward(self, x):
        x = copy_to(x, self.group)
        y = F.linear(x, self.weight.t(), self.bias)
        if self.gather_output and self.group is not None:
            y = _GatherLast.apply(y, self.group)
        return y


class RowParallelLinear(nn.Module):
    """``y = x @ W + b`` with ``W [in / mp, out]``: this rank's rows,
    the products summed over the group, the bias (whole on every rank)
    added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.group, self.world_size, self.rank = _mp_group(mp_group)
        if in_features % self.world_size:
            raise ValueError("in_features %d does not split over mp=%d"
                             % (in_features, self.world_size))
        self.input_is_parallel = input_is_parallel
        self.in_per_part = in_features // self.world_size
        self.weight = _parameter(
            (self.in_per_part, out_features), device, dtype,
            split_axis=0 if self.group is not None else None)
        self.bias = _parameter((out_features,), device, dtype,
                               xavier=False) if has_bias else None

    def forward(self, x):
        if self.group is None:
            return F.linear(x, self.weight.t(), self.bias)
        if not self.input_is_parallel:
            x = _SplitLast.apply(x, self.group)
        y = reduce_from(F.linear(x, self.weight.t()), self.group)
        return y if self.bias is None else y + self.bias


class ParallelCrossEntropy(nn.Module):
    """Cross entropy a token (no reduction) of logits ``[..., vocab /
    mp]`` split over the group and ``label`` ``[...]`` (or ``[..., 1]``)
    of global ids; ``ignore_index`` tokens give 0. The math is f32.
    ``loss_chunks`` is the JAX layer's token chunking of its
    exponentials; autograd keeps them for the backward anyway, so the
    port takes the count and computes in one piece."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100,
                 loss_chunks=4):
        super().__init__()
        self.group, self.world_size, self.rank = _mp_group(mp_group)
        self.ignore_index = ignore_index
        self.loss_chunks = max(1, int(loss_chunks))

    def forward(self, input, label):
        x = input.float()
        if label.dim() == x.dim():
            label = label.squeeze(-1)
        label = label.long()
        per = x.shape[-1]
        start = self.rank * per
        with torch.no_grad():
            gmax = x.amax(-1)
            if self.group is not None:
                dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=self.group)
        shifted = x - gmax.unsqueeze(-1)
        sumexp = reduce_from(shifted.exp().sum(-1), self.group)
        local = label - start
        inside = (local >= 0) & (local < per)
        picked = shifted.gather(
            -1, torch.where(inside, local, 0).unsqueeze(-1)).squeeze(-1)
        picked = reduce_from(torch.where(inside, picked, 0.0), self.group)
        loss = sumexp.log() - picked
        return torch.where(label == self.ignore_index, 0.0, loss)
