"""Shape ops of the eager path.

Port of the functions of ``paddle_tpu/ops/manipulation.py`` that the
eager vision models call (``flatten`` in LeNet and ResNet), with
``reshape`` and ``concat``: Paddle's argument names over PyTorch's ops.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["flatten", "reshape", "concat"]


def flatten(x: torch.Tensor, start_axis: int = 0, stop_axis: int = -1
            ) -> torch.Tensor:
    """``x`` with the axes ``start_axis`` .. ``stop_axis`` merged."""
    return torch.flatten(x, start_axis, stop_axis)


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return torch.reshape(x, tuple(int(s) for s in shape))


def concat(x: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(x), dim=int(axis))
