"""Gradient clipping by the global norm.

Port of ``ClipGradByGlobalNorm`` of ``paddle_tpu/nn/clip.py``, the clip
an eager optimizer takes as ``grad_clip=``: over ``(param, grad)``
pairs, the f32 norm of every gradient together, and each gradient
times ``min(clip_norm / max(norm, 1e-12), 1)`` in its own dtype. Under
hybrid parallelism ``HybridParallelOptimizer`` replaces it with a clip
whose squared norm is summed over the model- and pipeline-parallel
groups (``distributed/fleet/hybrid_parallel_optimizer.py``).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @staticmethod
    def global_norm_sq(params_grads) -> torch.Tensor:
        """The f32 sum of every gradient's squares (a 0-d tensor)."""
        sq = [g.float().square().sum() for _, g in params_grads
              if g is not None]
        return torch.stack(sq).sum() if sq else torch.zeros(())

    def scaled(self, params_grads, norm_sq: torch.Tensor):
        """The pairs, each gradient clipped by the global squared norm
        ``norm_sq``."""
        scale = torch.clamp(self.clip_norm / norm_sq.sqrt().clamp_min(
            1e-12), max=1.0)
        return [(p, g if g is None else (g * scale).to(g.dtype))
                for p, g in params_grads]

    def __call__(self, params_grads):
        params_grads = list(params_grads)
        return self.scaled(params_grads, self.global_norm_sq(params_grads))
