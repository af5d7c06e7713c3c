"""``Conv2D`` (port of ``paddle_tpu/nn/layer/conv.py``): weight ``[out,
in / groups, kh, kw]`` and bias drawn uniform in +-1/sqrt(fan in), fan
in = ``in / groups * kh * kw`` (the JAX package's default);
``bias_attr=False`` for none."""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                "Conv2D: padding_mode %r is not ported, zeros only "
                "(ROADMAP.md §1 item 9)" % padding_mode)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = (kernel_size,) * 2 if isinstance(
            kernel_size, int) else tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr, default_initializer=Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound)) \
            if bias_attr is not False else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self) -> str:
        return "%d, %d, kernel_size=%s, stride=%s" % (
            self._in_channels, self._out_channels, self._kernel_size,
            self._stride)
