"""Training health: the global gradient norm.

Port of ``grad_health`` from ``paddle_tpu/observability/health.py``: one
f32 squared-sum over every gradient, square-rooted once, shared by
gradient clipping. A non-finite gradient anywhere makes the norm
non-finite, so ``torch.isfinite(norm)`` is the whole-model health bit.
The JAX package's health policies (``PADDLE_TPU_HEALTH=warn|skip|raise``)
are not ported yet: :func:`policy` reads the knob so that ``TrainStep``
can refuse a policy it would not honour.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..config import knobs

__all__ = ["grad_health", "policy"]

_POLICIES = ("off", "warn", "skip", "raise")


def grad_health(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every gradient's squares), in f32, as a 0-d tensor on
    the gradients' device (no host sync)."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def policy() -> str:
    """The ``PADDLE_TPU_HEALTH`` policy; "off" when unset or unknown, as
    in the JAX package."""
    v = knobs.get_str("PADDLE_TPU_HEALTH").strip().lower()
    return v if v in _POLICIES else "off"
