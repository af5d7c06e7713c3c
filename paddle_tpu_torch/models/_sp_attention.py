"""Sequence-parallel attention for the models.

Port of ``paddle_tpu/models/_sp_attention.py``. ``sequence_parallel_mode``
on the model configs chooses how attention treats activations split over
the mesh's ``sp`` axis (each rank one contiguous part of the sequence):

- "gspmd" (the default): what GSPMD does for the JAX package, made
  explicit (:func:`gathered_kv`): K and V are all-gathered over ``sp``
  (their gradients reduce-scattered back) and cut to the keys up to this
  rank's last position, so that K1 (and the backward, K3 at ``sq < sk``
  by the JAX package's route rule) under the bottom-right causal mask
  give each query exactly the keys at or before its global position; no
  mask tensor is built.
- "ring": :func:`..distributed.sequence_parallel.ring_attention`.
- "ulysses": :func:`..distributed.sequence_parallel.ulysses_attention`.

:func:`sp_attention` returns None where ring / ulysses do not apply (no
``sp`` group or one of size 1, another mode, non-causal attention): the
caller then takes its usual attention, as the JAX package does in eager
mode, on one device and in decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..distributed.sequence_parallel import ring_attention, ulysses_attention
from ..distributed.sharding import gather_dim
from ..incubate.nn.cuda.flash_attn import _repeat_kv

__all__ = ["sp_attention", "gathered_kv", "sp_positions", "on_sp"]


def sp_attention(q, k, v, mode: str, causal: bool, group
                 ) -> Optional[torch.Tensor]:
    """Ring / Ulysses attention over ``group`` (the ``sp`` group), or None
    where they do not apply (see the module note)."""
    if mode not in ("ring", "ulysses") or not causal:
        return None
    if group is None or dist.get_world_size(group) <= 1:
        return None
    fn = ring_attention if mode == "ring" else ulysses_attention
    return fn(q, k, v, group, causal=True)


def gathered_kv(k, v, group):
    """``(k, v)`` of every ``sp`` rank's part up to and including this
    rank's (``[b, (r + 1) s, h, d]`` on rank r): one all-gather of both,
    whose backward reduce-scatters their gradients."""
    r = dist.get_rank(group)
    kv = gather_dim(torch.stack([k, v]), 2, group)[:, :, :(r + 1) * k.shape[1]]
    return kv[0], kv[1]


def on_sp(q, k, v, mode: str, group):
    """Attention of one sp rank's part, as the model chose it: ``(out,
    k, v)`` with ring / ulysses's output (K / V repeated to the query
    heads first, as the JAX models repeat them), or ``(None, k, v)``
    with K / V gathered for the caller's causal attention at sq < sk
    (gspmd)."""
    out = None
    if mode in ("ring", "ulysses"):
        out = sp_attention(q, *_repeat_kv(q, k, v), mode, True, group)
    if out is None:
        k, v = gathered_kv(k, v, group)
    return out, k, v


def sp_positions(group, s: int, device) -> Optional[torch.Tensor]:
    """``[1, s]`` global positions of this ``sp`` rank's part (None
    without a group)."""
    if group is None:
        return None
    start = dist.get_rank(group) * s
    return torch.arange(start, start + s, device=device)[None]
