"""ProcessMesh: the ranks of a run laid out on named axes.

Port of ``paddle_tpu/distributed/auto_parallel/process_mesh.py``
(``ProcessMesh``, ``set_mesh``, ``get_mesh``). The JAX mesh maps the
ids onto devices of one controller; here an id is a rank of the
process group (:func:`..parallel_env.init_parallel_env`), one process a
device. On first use of :meth:`ProcessMesh.group` the mesh makes one
process group for every line of ranks along every axis (every rank
makes all of them, in the same order, as ``new_group`` requires) and
keeps the ones that hold this rank; a group over several axes (the
``dp`` x ``sp`` ranks that hold one batch's tokens) is made the same way
on its first use, which every rank must reach in the same order.
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..collective import new_group

__all__ = ["ProcessMesh", "get_mesh", "set_mesh"]

_global_mesh: Optional["ProcessMesh"] = None


class ProcessMesh:
    """N-D logical mesh of ranks; ``dim_names`` name the axes (e.g.
    ``["dp", "mp"]``)."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None):
        arr = np.asarray(mesh)
        if sorted(arr.reshape(-1).tolist()) != list(range(arr.size)):
            raise ValueError("a ProcessMesh holds the ranks 0..%d once "
                             "each, got %s" % (arr.size - 1, arr.tolist()))
        self._mesh = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError("%d dim_names for a %d-D mesh"
                             % (len(dim_names), arr.ndim))
        self._dim_names = list(dim_names)
        self._groups: Optional[Dict[str, object]] = None
        self._multi: Dict[tuple, object] = {}

    @property
    def shape(self) -> List[int]:
        return list(self._mesh.shape)

    @property
    def ndim(self) -> int:
        return self._mesh.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def size(self) -> int:
        return int(self._mesh.size)

    def get_dim_size(self, dim_name: str) -> int:
        return self.shape[self._dim_names.index(dim_name)]

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 when the mesh lacks it."""
        return self.get_dim_size(name) if name in self._dim_names else 1

    # ------------------------------------------------------- this rank
    def coords_of(self, rank: int) -> Dict[str, int]:
        loc = np.argwhere(self._mesh == rank)[0]
        return dict(zip(self._dim_names, (int(i) for i in loc)))

    def coord(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 when the mesh lacks
        it)."""
        if name not in self._dim_names:
            return 0
        return self.coords_of(dist.get_rank())[name]

    def group(self, name: str):
        """The process group of this rank's line along axis ``name``."""
        if self._groups is None:
            self._build_groups()
        return self._groups[name]

    def group_of(self, axes) -> Optional[object]:
        """The group of the ranks that share this rank's coordinates on
        every axis but ``axes`` (names the mesh lacks are left out): one
        axis's line, every rank for all of them, None for none."""
        axes: FrozenSet[str] = frozenset(
            a for a in axes if a is not None and a in self._dim_names)
        if not axes:
            return None
        if len(axes) == 1:
            return self.group(next(iter(axes)))
        self.group(self._dim_names[0])        # the mesh's groups first
        if axes == frozenset(self._dim_names):
            return dist.group.WORLD
        key = tuple(n for n in self._dim_names if n in axes)
        if key not in self._multi:
            idx = [self._dim_names.index(n) for n in key]
            me, group = dist.get_rank(), None
            blocks = np.moveaxis(self._mesh, idx, list(range(-len(idx), 0)))
            for block in blocks.reshape(-1, math.prod(
                    self._mesh.shape[i] for i in idx)):
                members = sorted(map(int, block))
                g = new_group(members)
                if me in members:
                    group = g
            self._multi[key] = group
        return self._multi[key]

    def _build_groups(self) -> None:
        if not dist.is_initialized():
            raise RuntimeError("the mesh's groups need the process group: "
                               "call init_parallel_env() first")
        if dist.get_world_size() != self.size:
            raise ValueError("a mesh of %d ranks in a run of %d"
                             % (self.size, dist.get_world_size()))
        me = dist.get_rank()
        groups = {}
        for name in self._dim_names:
            for line in self.lines(name):
                # a group ranks its members in increasing order: the
                # line's order must be that one for an axis index to be
                # the group rank
                if line != sorted(line):
                    raise NotImplementedError(
                        "mesh %s: the ranks along %r must increase"
                        % (self._mesh.tolist(), name))
                g = new_group(line)
                if me in line:
                    groups[name] = g
        self._groups = groups

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"

    def lines(self, name: str):
        """Every line of ranks along axis ``name`` (the groups'
        members)."""
        axis = self._dim_names.index(name)
        return [list(map(int, line)) for line in np.moveaxis(
            self._mesh, axis, -1).reshape(-1, self._mesh.shape[axis])]

    def all_coords(self):
        """Every rank's coordinates, in rank order."""
        return [self.coords_of(r) for r in range(self.size)]


def set_mesh(mesh: Optional[ProcessMesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh
