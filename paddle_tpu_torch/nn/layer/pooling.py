"""Pooling layers (port of ``MaxPool2D``, ``AvgPool2D`` and
``AdaptiveAvgPool2D`` of ``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _Pool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}


class MaxPool2D(_Pool2D):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AvgPool2D(_Pool2D):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
