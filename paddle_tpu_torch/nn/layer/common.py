"""Common layers: ``Linear`` and ``Flatten``.

Port of ``paddle_tpu/nn/layer/common.py``. Paddle's ``Linear.weight``
is ``[in_features, out_features]`` (the transpose of PyTorch's): the
port keeps that layout, so that state dicts carry across unchanged, and
computes ``x @ W + b``.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import XavierNormal
from .layers import Layer

__all__ = ["Linear", "Flatten"]


class Linear(Layer):
    """``y = x W + b``, ``W`` of shape ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return "in_features=%d, out_features=%d" % (self._in_features,
                                                    self._out_features)


class Flatten(Layer):
    """The axes ``start_axis`` .. ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flatten(x, self.start_axis, self.stop_axis)
