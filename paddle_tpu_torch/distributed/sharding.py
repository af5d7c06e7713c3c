"""Sharded parameters on a mesh, and the collectives that move them.

The JAX ``TrainStep`` hands its whole program to GSPMD, which splits
every annotated array over the mesh and places the collectives. The
port runs one process a rank and places them itself:

- :class:`Layout`: where the pieces of a tensor live: its global shape,
  a mesh axis (or None) a dim, and the equal parts a dim holds (GPT's
  ``[q | k | v]``). It slices a full tensor into a rank's piece, gathers
  the pieces back (a collective) and puts pieces together offline.
- Differentiable collectives (``torch.autograd.Function``):
  :func:`copy_to` (identity forward, all-reduce of the gradient: the
  input of a column-parallel layer), :func:`reduce_from` (all-reduce
  forward, identity backward: the output of a row-parallel layer),
  :func:`gather_dim` (all-gather forward, reduce-scatter of the
  gradient: an FSDP parameter) and :func:`vocab_parallel_embedding`. Each is the identity for
  ``group=None``.
- :func:`shard_model`: slices every parameter of a model to this rank's
  piece, in place (the same ``Parameter`` objects), records its
  :class:`Layout` as ``p.dist_layout``, hands the modules their ``mp``
  and ``sp`` groups (no ``sp`` group where that axis has one rank) and
  the loss its ``dp`` x ``sp`` group (the ranks
  that hold the global batch's other tokens), and gives each block an
  :class:`FSDPUnit` over its parameters that the FSDP axis shards. No
  parameter is split over ``sp``: sequence parallelism splits the
  activations only.

FSDP (the JAX ``_add_fsdp``): a parameter is sharded over the FSDP axis
on its first dim that no axis shards yet and that the axis divides
(else it stays replicated). A block's unit all-gathers its shards when
the block runs and drops the full tensors when it returns; a block under
recompute gathers again in the backward, and the gradients leave by
reduce-scatter (summed over the data-parallel ranks). The parameters
outside the blocks (embeddings, final norm, head) form the root unit,
gathered once for the whole forward. Without recompute autograd keeps a
block's gathered weights until its backward.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["Layout", "FSDPUnit", "copy_to", "reduce_from", "gather_dim",
           "vocab_parallel_embedding", "shard_model",
           "fsdp_spec", "param_layout"]


# the names of torch 2.11's collectives, which later releases keep
# beside new ones (and warn about)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _take(x: torch.Tensor, d: int, n: int, k: int, c: int) -> torch.Tensor:
    """Piece ``c`` of ``n`` of dim ``d`` of ``x``, whose dim holds ``k``
    equal parts, each split on its own."""
    m = x.shape[d] // (k * n)
    return x.unflatten(d, (k, n, m)).select(d + 1, c).flatten(d, d + 1)


def _merge(buf: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """The inverse of :func:`_take`: ``buf`` [n, *piece] -> the full
    tensor, each of the ``k`` parts of dim ``d`` the n pieces' in
    order."""
    x = buf.movedim(0, d)                                # [.., n, k m, ..]
    x = x.unflatten(d + 1, (k, x.shape[d + 1] // k))     # [.., n, k, m, ..]
    return x.transpose(d, d + 1).flatten(d, d + 2)


def _stacked(shape, n):
    """The flat shape the collectives take for n stacked tensors of
    ``shape`` (gloo wants the members' rows one after another)."""
    return (n * shape[0],) + tuple(shape[1:]) if shape else (n,)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[n, *t.shape]: every member's ``t`` in group-rank order."""
    t = t.contiguous()
    n = _size(group)
    buf = t.new_empty(_stacked(tuple(t.shape), n))
    _ALL_GATHER(buf, t, group=group)
    return buf.view((n,) + tuple(t.shape))


def _reduce_scatter(full: torch.Tensor, d: int, group) -> torch.Tensor:
    """This member's piece of dim ``d`` of the sum of every member's
    ``full``."""
    n = _size(group)
    src = full.unflatten(d, (n, full.shape[d] // n)).movedim(d, 0)
    out = full.new_empty(src.shape[1:])
    _REDUCE_SCATTER(
        out, src.contiguous().view(_stacked(tuple(out.shape), n)),
        group=group)
    return out


class Layout:
    """Where the pieces of a tensor of global ``shape`` live on ``mesh``:
    ``spec`` a mesh axis (or None) a dim, ``parts`` the equal parts a dim
    holds (1 each by default)."""

    def __init__(self, mesh, shape, spec, parts=None):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.parts = tuple(parts) if parts is not None else \
            (1,) * len(self.shape)
        for d, a in enumerate(self.spec):
            if a is None:
                continue
            if isinstance(a, tuple):
                raise NotImplementedError(
                    "dim %d split over several axes %s" % (d, a))
            n = mesh.axis_size(a) * self.parts[d]
            if self.shape[d] % n:
                raise ValueError(
                    "dim %d of size %d does not split into %d pieces over "
                    "%r" % (d, self.shape[d], n, a))

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.spec if a is not None)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s // self.mesh.axis_size(a) if a else s
                     for s, a in zip(self.shape, self.spec))

    def piece(self, full: torch.Tensor, coords: Dict[str, int]
              ) -> torch.Tensor:
        """The piece of ``full`` at mesh coordinates ``coords``."""
        if tuple(full.shape) != self.shape:
            raise ValueError("a tensor of shape %s for a layout of %s"
                             % (tuple(full.shape), self.shape))
        for d, a in enumerate(self.spec):
            if a is not None:
                full = _take(full, d, self.mesh.axis_size(a),
                             self.parts[d], coords[a])
        return full

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of ``full`` (a contiguous copy)."""
        me = self.mesh.coords_of(dist.get_rank())
        return self.piece(full, me).contiguous().clone()

    def assemble(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every rank's piece, in rank order (no
        collective: the pieces are at hand)."""
        cur = {tuple(sorted(c.items())): p
               for c, p in zip(self.mesh.all_coords(), pieces)}
        for d, a in enumerate(self.spec):
            if a is None:
                continue
            lines: Dict[tuple, list] = {}
            for key, p in cur.items():
                rest = tuple(kv for kv in key if kv[0] != a)
                lines.setdefault(rest, [None] * self.mesh.axis_size(a))[
                    dict(key)[a]] = p
            cur = {rest: _merge(torch.stack(ps), d, self.parts[d])
                   for rest, ps in lines.items()}
        # what is left differs only on axes that replicate the tensor
        return next(iter(cur.values()))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor on every rank (a collective of every rank)."""
        t = local
        for d, a in enumerate(self.spec):
            if a is not None:
                t = _merge(_all_gather(t, self.mesh.group(a)), d,
                           self.parts[d])
        return t

    def rows(self) -> "Layout":
        """The layout of a per-row vector (a factored ``vr``)."""
        return Layout(self.mesh, self.shape[:1], self.spec[:1],
                      self.parts[:1])

    def cols(self) -> "Layout":
        """The layout of a per-column vector over the flattened dims
        after the first (a factored ``vc``)."""
        if any(a is not None for a in self.spec[2:]):
            raise NotImplementedError("column statistics of %s" % (self,))
        return Layout(self.mesh, (math.prod(self.shape[1:]),),
                      self.spec[1:2], self.parts[1:2])

    def __repr__(self):
        return "Layout(shape=%s, spec=%s, parts=%s)" % (
            self.shape, self.spec, self.parts)


# ------------------------------------------------ differentiable collectives
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, d, group):
        ctx.d, ctx.group = d, group
        return _merge(_all_gather(shard, group), d, 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.d, ctx.group), None, None


def copy_to(x, group):
    """``x`` as it is; its gradient all-reduced over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum of every member's ``x``; the gradient passes as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_dim(shard, d: int, group):
    """The members' shards concatenated on dim ``d``; the gradient
    reduce-scattered (summed over the members) back onto the shard."""
    return shard if group is None else _GatherDim.apply(shard, d, group)


def vocab_parallel_embedding(ids, weight, group):
    """Rows ``ids`` of an embedding whose vocabulary is split over
    ``group`` (``weight`` this member's ``[vocab / n, h]`` rows): each
    member looks up the ids in its range, zeros the others, and the
    members' results are summed."""
    if group is None:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids - dist.get_rank(group) * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(inside, local, 0), weight)
    return reduce_from(out * inside.unsqueeze(-1).to(out.dtype), group)


# --------------------------------------------------------------- the model
def fsdp_spec(spec: Sequence, shape: Sequence[int], axis: str, size: int
              ) -> Tuple:
    """The JAX ``_add_fsdp``: ``spec`` with ``axis`` on the first dim
    that no axis shards and that ``size`` divides (unchanged when the
    axis already shards a dim or no dim qualifies)."""
    spec = list(spec)
    if axis in spec:
        return tuple(spec)
    for d, a in enumerate(spec):
        if a is None and shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axis
            break
    return tuple(spec)


def param_layout(p: torch.Tensor, mesh, fsdp_axis: Optional[str] = None
                 ) -> Layout:
    """The layout of full parameter ``p`` on ``mesh``: its annotation
    filtered by the mesh, plus the FSDP axis (when the mesh has it)."""
    # here, not at import: the semi-auto surface imports this module
    from .auto_parallel.constraint import param_spec

    spec = param_spec(p, mesh)
    # a dim's parts go with the axis of its annotation: where the mesh
    # lacks that axis the dim is one block (FSDP may split it plainly)
    parts = tuple(k if a is not None else 1 for k, a in zip(
        getattr(p, "dist_parts", (1,) * p.dim()), spec))
    if fsdp_axis is not None and fsdp_axis in mesh.dim_names:
        spec = fsdp_spec(spec, p.shape, fsdp_axis, mesh.axis_size(fsdp_axis))
    return Layout(mesh, p.shape, spec, parts)


def _owner(model: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


class FSDPUnit:
    """The parameters of one module that the FSDP axis shards: gathered
    while the module runs, dropped when it returns."""

    def __init__(self, entries, group):
        # (owning module, attribute, Parameter, sharded dim)
        self.entries: List[tuple] = entries
        self.group = group

    @contextlib.contextmanager
    def gathered(self):
        """The full (mp-local) tensors in place of the shards, for the
        duration of the block; the shards' gradients come back through
        the gathers."""
        full = [gather_dim(p, d, self.group) for _, _, p, d in self.entries]
        saved = [mod._parameters[leaf] for mod, leaf, _, _ in self.entries]
        for (mod, leaf, _, _), t in zip(self.entries, full):
            mod._parameters[leaf] = t
        try:
            yield
        finally:
            for (mod, leaf, _, _), p in zip(self.entries, saved):
                mod._parameters[leaf] = p

    def wrap(self, fn):
        """``fn`` run with the unit's parameters gathered."""
        def run(*args, **kwargs):
            with self.gathered():
                return fn(*args, **kwargs)
        return run


def shard_model(model: torch.nn.Module, mesh, fsdp_axis: Optional[str]
                ) -> Optional[FSDPUnit]:
    """Slice ``model``'s parameters to this rank's pieces in place and
    wire its modules to the mesh (see the module note). Returns the
    root unit (the FSDP-sharded parameters outside the blocks), None
    without FSDP."""
    mp = mesh.group("mp") if "mp" in mesh.dim_names else None
    sp = (mesh.group("sp") if "sp" in mesh.dim_names
          and mesh.axis_size("sp") > 1 else None)
    batch = mesh.group_of(("dp", "sp"))
    fsdp = fsdp_axis if fsdp_axis in mesh.dim_names else None
    blocks = [(name, m) for name, m in model.named_modules()
              if hasattr(m, "fsdp")]
    units = {name: [] for name, _ in blocks}
    root = []
    for name, p in model.named_parameters():
        layout = param_layout(p, mesh, fsdp)
        spec = layout.spec
        with torch.no_grad():
            p.data = layout.local(p.data)
        p.dist_layout = layout
        if fsdp is None or fsdp not in spec:
            continue
        mod, leaf = _owner(model, name)
        entry = (mod, leaf, p, spec.index(fsdp))
        owner = next((b for b, _ in blocks if name.startswith(b + ".")),
                     None)
        (root if owner is None else units[owner]).append(entry)
    for m in model.modules():
        if hasattr(m, "mp_group"):
            m.mp_group = mp
        if hasattr(m, "sp_group"):
            m.sp_group = sp
        if hasattr(m, "batch_group"):
            m.batch_group = batch
    group = mesh.group(fsdp) if fsdp is not None else None
    for name, m in blocks:
        m.fsdp = FSDPUnit(units[name], group) if units[name] else None
    return FSDPUnit(root, group) if root else None
