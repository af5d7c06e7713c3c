"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``; so
far ``ReLU``, the one the eager vision models use)."""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)
