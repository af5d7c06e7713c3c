"""Sharding annotations of parameters and activations.

Port of ``paddle_tpu/distributed/auto_parallel/constraint.py``. The
models annotate each parameter at construction with a mesh-axis name (or
None) per dim, as the JAX models do: ``(None, "mp")`` is a
column-parallel linear weight, ``("mp", None)`` a row-parallel one or a
vocab-parallel embedding. Names the mesh lacks drop out
(:func:`filtered_spec`), so the same model runs on a dp mesh, an mp
mesh or both. ``parts`` (port-only) says that a dim holds that many
equal parts, each split on its own: GPT's fused ``[q | k | v]``
projection is split so that a rank holds its heads of each of q, k
and v.

The JAX package lets GSPMD place the collectives; the port's layouts
are explicit (:mod:`..sharding`), so :func:`shard_activation` is the
identity.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["annotate_param", "param_spec", "shard_activation",
           "filtered_spec"]


def filtered_spec(axes: Sequence, mesh) -> Tuple:
    """``axes`` without the names ``mesh`` lacks (None in their place;
    a tuple of names keeps the ones it has)."""
    names = set(mesh.dim_names)

    def keep(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in names)
            return kept if kept else None
        return a if a in names else None

    return tuple(keep(a) for a in axes)


def annotate_param(p: torch.Tensor, axes: Sequence,
                   parts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Attach a mesh-axis name (or None) per dim to ``p`` and, with
    ``parts``, the count of equal parts each dim holds."""
    p.dist_spec = tuple(axes)
    p.dist_parts = tuple(parts) if parts is not None else (1,) * p.dim()
    return p


def param_spec(p: torch.Tensor, mesh) -> Tuple:
    """``p``'s annotation filtered by ``mesh``, one entry a dim
    (replicated when ``p`` has none)."""
    axes = getattr(p, "dist_spec", None)
    if axes is None:
        return (None,) * p.dim()
    return filtered_spec(tuple(axes) + (None,) * (p.dim() - len(axes)), mesh)


def shard_activation(x, axes: Sequence):
    """The identity: the port's layouts are explicit."""
    return x
