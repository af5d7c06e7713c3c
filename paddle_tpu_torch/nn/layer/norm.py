"""``BatchNorm2D`` and ``LayerNorm`` (port of
``paddle_tpu/nn/layer/norm.py``): weight 1, bias 0; BatchNorm's running
statistics are buffers under the JAX package's names, ``_mean`` (zeros)
and ``_variance`` (ones), in f32."""
from __future__ import annotations

import torch

from ...device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm2D", "LayerNorm"]


class BatchNorm2D(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None
        dev = resolve_device(None)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return "num_features=%d, momentum=%s" % (self._num_features,
                                                 self._momentum)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return "normalized_shape=%s" % (self._normalized_shape,)
