"""Common layers: ``Linear``, ``Flatten``, ``Embedding`` and ``Dropout``.

Port of ``paddle_tpu/nn/layer/common.py``. Paddle's ``Linear.weight``
is ``[in_features, out_features]`` (the transpose of PyTorch's): the
port keeps that layout, so that state dicts carry across unchanged, and
computes ``x @ W + b``. ``Embedding``'s weight is drawn from N(0, 1) by
default, its ``padding_idx`` row set to zero, and the lookup gives zeros
at that index (:func:`..functional.embedding`).
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal, XavierNormal
from .layers import Layer

__all__ = ["Linear", "Flatten", "Embedding", "Dropout"]


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


class Embedding(Layer):
    """A lookup table of ``num_embeddings`` rows of ``embedding_dim``."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return "%d, %d" % (self._num_embeddings, self._embedding_dim)


class Dropout(Layer):
    """:func:`..functional.dropout` in training, the identity in eval."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return "p=%s" % (self.p,)
