"""Training health: the global gradient norm and the non-finite policies.

Port of ``paddle_tpu/observability/health.py``: one f32 squared-sum over
every gradient, square-rooted once, shared by gradient clipping. A
non-finite gradient anywhere makes the norm non-finite, so
``torch.isfinite(norm)`` is the whole-model health bit. On a mesh each
rank holds shards: a parameter's squared sum is all-reduced over the
group of the axes that shard it, once (a parameter the ``mp`` ranks
replicate counts once, not once a rank), so every rank reads the same
global norm and ``skip`` / ``raise`` decide on it.

The policy (``PADDLE_TPU_HEALTH=warn|skip|raise``, read once at import,
or :func:`configure` before building the train step):

- ``warn``  -- warn on a non-finite step, keep the update;
- ``skip``  -- discard the update: parameters and optimizer state keep
  their values (``TrainStep`` reads ``isfinite(gnorm)`` once, before it
  writes anything: its update is in place);
- ``raise`` -- raise :class:`NonFiniteError` after the step.

``TrainStep`` captures the policy when it is built, as the JAX package
compiles it into the step. The JAX module's telemetry half (the
``train.grad_norm`` gauge, the ``train.nonfinite_steps`` counter, the
flight recorder) is not ported (ROADMAP.md).
"""
from __future__ import annotations

import math
import warnings
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import knobs

__all__ = ["NonFiniteError", "configure", "enabled", "get_policy",
           "policy", "grad_health", "record_step"]

_POLICIES = ("off", "warn", "skip", "raise")


def _env_policy() -> str:
    v = knobs.get_str("PADDLE_TPU_HEALTH").strip().lower()
    return v if v in _POLICIES else "off"


_policy = _env_policy()


class NonFiniteError(RuntimeError):
    """A training step produced a non-finite global grad norm (or loss)
    under the ``raise`` policy."""


def configure(policy: str) -> None:
    """Set the health policy ("off" disables). Takes effect for steps
    BUILT afterwards."""
    global _policy
    if policy not in _POLICIES:
        raise ValueError(
            f"health policy must be one of {_POLICIES}, got {policy!r}")
    _policy = policy


def enabled() -> bool:
    return _policy != "off"


def get_policy() -> str:
    return _policy


policy = get_policy


def grad_health(grads: Iterable[torch.Tensor],
                groups: Optional[Sequence] = None) -> torch.Tensor:
    """sqrt(sum of every gradient's squares), in f32, as a 0-d tensor on
    the gradients' device (no host sync). With ``groups`` (one a
    gradient: the process group over which it is sharded, or None) the
    gradients are shards: each group's squared sum is all-reduced over
    it, the groups in the order they first appear."""
    sq = [g.float().square().sum() for g in grads]
    if groups is None:
        return torch.stack(sq).sum().sqrt()
    by_group = {}
    for s, group in zip(sq, groups):
        by_group.setdefault(group, []).append(s)
    total = []
    for group, parts in by_group.items():
        part = torch.stack(parts).sum()
        if group is not None:
            dist.all_reduce(part, group=group)
        total.append(part)
    return torch.stack(total).sum().sqrt()


def record_step(gnorm: float, source: str = "grad",
                step: Optional[int] = None) -> bool:
    """Apply the warn / raise policy to one step's health scalar (on the
    host). Returns True when the step was finite."""
    if math.isfinite(gnorm):
        return True
    if _policy == "raise":
        raise NonFiniteError(
            f"non-finite {source} at step {step}: {gnorm!r}")
    if _policy in ("warn", "skip"):
        warnings.warn(
            f"paddle_tpu_torch.health: non-finite {source} at step {step} "
            f"({gnorm!r}); policy={_policy}"
            + (" — update discarded" if _policy == "skip" else ""),
            stacklevel=2)
    return False
