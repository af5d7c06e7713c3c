"""Parameter initializers of the eager layers.

Port of the initializers of ``paddle_tpu/nn/initializer/__init__.py``
that the eager layers take by default (``Constant``, ``Uniform``,
``XavierNormal``) and BERT's ``Normal``; the others wait, ``ROADMAP.md`` §1 item 9), with the JAX package's fan rule (``_fans``: a conv
weight ``[out, in, *k]`` has fan in ``in * prod(k)``). Each call draws
from :func:`paddle_tpu_torch.core.random.generator` of the target
device, which ``paddle_tpu_torch.seed(n)`` seeds: the same distribution
as the JAX package, not its bits (the tests carry weights across).
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierNormal"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    # conv weight [out_c, in_c, *k]
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype, device) -> tensor``."""

    def __call__(self, shape, dtype=torch.float32, device="cpu"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device="cpu"):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


def _normal(shape, mean, std, dtype, device):
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(mean, std, generator=_random.generator(device))
    return t.to(dtype)


def _uniform(shape, low, high, dtype, device):
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.uniform_(low, high, generator=_random.generator(device))
    return t.to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device="cpu"):
        return _uniform(shape, self.low, self.high, dtype, device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device="cpu"):
        return _normal(shape, self.mean, self.std, dtype, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device="cpu"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(shape, 0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                       dtype, device)
