"""Activation functionals (port of ``paddle_tpu/nn/functional/
activation.py``): ``relu``, ``gelu`` (exact, by erf, or with
``approximate=True`` the tanh form, as ``jax.nn.gelu``) and ``tanh``."""
from __future__ import annotations

import torch

__all__ = ["relu", "gelu", "tanh"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def gelu(x: torch.Tensor, approximate: bool = False, name=None
         ) -> torch.Tensor:
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.tanh(x)
