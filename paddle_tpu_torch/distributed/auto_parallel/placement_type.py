"""Placements: Shard / Replicate / Partial, one a mesh axis (port of
``paddle_tpu/distributed/auto_parallel/placement_type.py``)."""
from __future__ import annotations

__all__ = ["Placement", "Shard", "Replicate", "Partial"]


class Placement:
    def is_shard(self, dim=None) -> bool:
        return False

    def is_replicated(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self).__name__)


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def is_shard(self, dim=None) -> bool:
        return dim is None or dim == self.dim

    def get_dim(self) -> int:
        return self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicated(self) -> bool:
        return True

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    """Pending-reduction placement (the reference's `Partial(SUM)`):
    each shard holds a partial sum; reshard to Replicate/Shard inserts the
    all-reduce / reduce-scatter."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self) -> bool:
        return True

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("Partial", self.reduce_type))

    def __repr__(self):
        return f"Partial({self.reduce_type})"
