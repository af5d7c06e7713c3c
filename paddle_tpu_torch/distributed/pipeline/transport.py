"""The compiled pipeline's ring transfer.

Port of the ``ring_shift`` half of
``paddle_tpu/distributed/pipeline/transport.py``: one ring step that
moves every stage's boundary tensor to the next stage. In the JAX package
it is ``jax.lax.ppermute`` (XLA's ``collective-permute``) or, under
``PADDLE_TPU_PP_RING=pallas`` on a TPU, the remote-DMA kernel K10
(``_pallas_shift_impl``), with the shift by ``size - 1`` as its VJP.

Here the transfer is K10 (``incubate/nn/cuda/ring.py`` ``shift``) for
CUDA tensors: there is no collective to hand it to, so the port reads no
``PADDLE_TPU_PP_RING``. CPU tensors take the plain shift
(:meth:`Ring.shift_ref`). The fleet payload transport and the
``PADDLE_TPU_PP_TRANSPORT`` / ``PP_BUCKET_MB`` rows belong to the host
pipeline leg and the dp buckets, which are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["ring_shift"]


def _shift(tensors: Sequence[torch.Tensor], ring,
           step: int) -> List[torch.Tensor]:
    if ring.device(0).type == "cuda":
        from ...incubate.nn.cuda import ring as kring

        return kring.shift([t.contiguous() for t in tensors], ring, step)
    return ring.shift_ref(tensors, step)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(_shift(tensors, ring, 1))

    @staticmethod
    def backward(ctx, *grads):
        # the transpose of y_i = x_{i-1} sends g_j to position j - 1
        ring = ctx.ring
        return (None, *_shift(grads, ring, ring.size - 1))


def ring_shift(tensors: Sequence[torch.Tensor], ring) -> List[torch.Tensor]:
    """Move every rank's tensor one step forward around ``ring``:
    ``out[(r + 1) % size] = tensors[r]``. Differentiable: the backward is
    the shift by ``size - 1``, on K10 too for CUDA tensors."""
    if len(tensors) != ring.size:
        raise ValueError("%d tensors for a ring of %d"
                         % (len(tensors), ring.size))
    return list(_RingShift.apply(ring, *tensors))
