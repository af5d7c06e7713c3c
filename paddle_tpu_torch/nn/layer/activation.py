"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``; so
far ``ReLU``, ``GELU`` and ``Tanh``)."""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "GELU", "Tanh"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate=self._approximate)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.tanh(x)
