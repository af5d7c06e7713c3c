"""Dropout.

Port of ``dropout`` of ``paddle_tpu/nn/functional/common.py``: in
training, a keep mask of probability ``1 - p`` (over ``x``'s shape, or
only over the axes ``axis`` names, broadcast along the rest), and
``where(keep, x / (1 - p), 0)`` (``upscale_in_train``) or ``where(keep,
x, 0)`` (``downscale_in_infer``); with ``p = 0`` or outside training,
``x`` itself.

Every dropout site of the port (this function, ``fusion.dropout_add``,
attention dropout) draws its mask through :func:`dropout_mask`, from the
generator :func:`paddle_tpu_torch.core.random.generator` gives for the
tensor's device (``TrainStep``'s inside a step).
"""
from __future__ import annotations

import torch

from ...core import random as _random

__all__ = ["dropout", "dropout_mask"]


def dropout_mask(shape, p: float, device) -> torch.Tensor:
    """The keep mask of one dropout draw: bool ``shape``, True with
    probability ``1 - p`` (the JAX ``bernoulli(key, 1 - p, shape)``:
    a uniform [0, 1) draw below ``1 - p``)."""
    u = torch.rand(tuple(shape), generator=_random.generator(device),
                   device=device, dtype=torch.float32)
    return u < 1.0 - p


def dropout(x: torch.Tensor, p: float = 0.5, axis=None,
            training: bool = True, mode: str = "upscale_in_train"
            ) -> torch.Tensor:
    """``x`` with each entry (each slice along the axes not in ``axis``)
    dropped with probability ``p``; the kept ones scaled by 1 / (1 - p)
    in ``upscale_in_train`` mode."""
    if not training or p == 0.0:
        return x
    if axis is None:
        shape = x.shape
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = dropout_mask(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
