"""Activation functionals (port of ``paddle_tpu/nn/functional/
activation.py``; so far ``relu``)."""
from __future__ import annotations

import torch

__all__ = ["relu"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
