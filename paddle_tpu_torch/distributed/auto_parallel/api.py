"""The semi-auto surface: tensors placed on a mesh.

Port of the calls of ``paddle_tpu/distributed/auto_parallel/api.py``
that the sharded step's users need: ``shard_tensor``,
``dtensor_from_local``, ``reshard``, ``unshard_dtensor`` and
``local_value``. The JAX package keeps one global array whose shards
XLA places; here each rank holds a plain tensor, its piece, carrying
``process_mesh``, ``placements`` (one :class:`Shard` / :class:`Replicate`
/ :class:`Partial` a mesh axis) and ``dist_layout`` (a
:class:`..sharding.Layout` over the global shape). ``Partial`` pieces
are summed over their axis when the tensor is unsharded or resharded.
Every call that gathers or sums is a collective of every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..sharding import Layout
from .placement_type import Partial, Replicate, Shard

__all__ = ["shard_tensor", "dtensor_from_local", "reshard",
           "unshard_dtensor", "local_value"]


def _spec(placements, mesh, ndim):
    if len(placements) != mesh.ndim:
        raise ValueError("%d placements for a %d-D mesh"
                         % (len(placements), mesh.ndim))
    spec = [None] * ndim
    for name, p in zip(mesh.dim_names, placements):
        if isinstance(p, Shard):
            if spec[p.dim] is not None:
                raise NotImplementedError(
                    "dim %d sharded over two mesh axes" % p.dim)
            spec[p.dim] = name
    return tuple(spec)


def _annotated(t, mesh, placements, shape):
    t.process_mesh, t.placements = mesh, list(placements)
    t.dist_layout = Layout(mesh, shape, _spec(placements, mesh, len(shape)))
    return t


def shard_tensor(data, mesh, placements) -> torch.Tensor:
    """This rank's piece of the full tensor ``data`` (the same on every
    rank) placed by ``placements`` (no Partial: use
    :func:`dtensor_from_local`)."""
    full = torch.as_tensor(data)
    if any(isinstance(p, Partial) for p in placements):
        raise ValueError("shard_tensor with Partial: use dtensor_from_local")
    layout = Layout(mesh, full.shape, _spec(placements, mesh, full.dim()))
    return _annotated(layout.local(full), mesh, placements, full.shape)


def dtensor_from_local(local_tensor, mesh, placements) -> torch.Tensor:
    """``local_tensor`` as this rank's piece of a tensor placed by
    ``placements`` (global shape: each sharded dim times its axis)."""
    t = torch.as_tensor(local_tensor)
    shape = list(t.shape)
    for name, p in zip(mesh.dim_names, placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.get_dim_size(name)
    return _annotated(t, mesh, placements, shape)


def local_value(dist_tensor) -> torch.Tensor:
    """This rank's piece (for a Partial tensor its unreduced part)."""
    return dist_tensor.detach()


def unshard_dtensor(dist_tensor) -> torch.Tensor:
    """The full tensor on every rank: Partial pieces summed over their
    axes, shards gathered."""
    mesh = dist_tensor.process_mesh
    t = dist_tensor.detach().clone()
    for name, p in zip(mesh.dim_names, dist_tensor.placements):
        if isinstance(p, Partial):
            dist.all_reduce(t, group=mesh.group(name))
    return dist_tensor.dist_layout.gather(t)


def reshard(dist_tensor, mesh, placements) -> torch.Tensor:
    """The same global tensor placed by ``placements``: unsharded, then
    sliced; a Partial axis keeps the value on its index 0 and zeros on
    the others."""
    full = unshard_dtensor(dist_tensor)
    partial = [name for name, p in zip(mesh.dim_names, placements)
               if isinstance(p, Partial)]
    plain = [Replicate() if isinstance(p, Partial) else p
             for p in placements]
    out = shard_tensor(full, mesh, plain)
    if any(mesh.coord(name) for name in partial):
        out.zero_()
    out.placements = list(placements)
    return out
