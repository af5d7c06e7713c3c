"""Group sharding (ZeRO) of the eager optimizers, stages 1, 2 and 3.

Port of ``paddle_tpu/distributed/fleet/sharding_optimizer.py``, one
process a rank over ``torch.distributed`` (NCCL on cards, gloo on the
CPU), on the public collectives only, as the JAX package runs them:

- :class:`DygraphShardingOptimizer` (stage 1, optimizer-state
  sharding): the parameters are split over the group's ranks by a greedy
  size balance (:func:`_partition_params`), and the inner optimizer
  keeps and steps only this rank's part (its ``_parameter_list`` is cut
  to it, its AdamW state follows). ``step`` reduces each gradient to its
  owner (averaged there; the other ranks drop theirs), the owners update
  their parts, then every parameter is broadcast from its owner.
- :class:`GroupShardedOptimizerStage2` (stage 2, and gradient sharding):
  stage 1 whose reductions run during the backward, from a hook on each
  parameter: the hook reduces the backward's gradient of that parameter
  to its owner (averaged there), and a rank that does not own it drops
  the accumulated ``.grad`` right after accumulation. The hooks fire in
  the backward's order, which is the same on every rank (one device
  thread runs a rank's backward over the same graph), so every rank
  issues the same reductions in the same order.
  :class:`GroupShardedStage2` is its model wrapper.
- :class:`GroupShardedStage3` (stage 3, and parameter sharding): between
  steps every parameter is a flat 1/N piece of itself, padded to N
  pieces; a forward pre-hook on each layer all-gathers its parameters
  before it runs. ``optimizer.step`` is routed through the wrapper: the
  gradients (whole, after the backward) are all-reduced and averaged,
  the inner optimizer steps the whole parameters, then they are cut to
  their pieces again. So every rank holds the whole optimizer state and
  repeats the whole update, as in the JAX package. ``state_dict`` gives
  the whole parameters.

The tied weight of a model (BERT's decoder is its word embeddings) is one
parameter in ``parameters()``, so it is partitioned, reduced and updated
once.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...optimizer.optimizers import clear_grads, grad_of
from .. import collective as dist

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3"]


def _partition_params(params, nranks: int) -> List[List[torch.Tensor]]:
    """Greedy size-balanced split: largest first, each to the rank that
    holds the fewest elements so far (the lowest rank on a tie)."""
    buckets: List[List[torch.Tensor]] = [[] for _ in range(nranks)]
    sizes = [0] * nranks
    for p in sorted(params, key=lambda p: -p.numel()):
        i = int(np.argmin(sizes))
        buckets[i].append(p)
        sizes[i] += p.numel()
    return buckets


def _sharding_group(group, hcg):
    """``group`` as a :class:`~..collective.Group`; None: the sharding
    group of the fleet's hybrid topology (a one-rank axis has no process
    group: this rank alone)."""
    if group is not None:
        return dist.as_group(group)
    if hcg is None:
        from .fleet import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    return dist.Group(hcg.get_sharding_parallel_group()
                      if hcg is not None else None)


def _drop_grad(p: torch.Tensor) -> None:
    clear_grads((p,))


def _restrict(optimizer, params) -> None:
    """Make ``optimizer`` step ``params`` (a part of its parameter list)
    only: its list, and its state and mp shards where it has them, cut to
    those entries."""
    index = {id(p): i for i, p in enumerate(optimizer._parameter_list)}
    idx = [index[id(p)] for p in params]
    state = getattr(optimizer, "_state", None)
    if state is not None:
        optimizer._state = {k: [v[i] for i in idx] if isinstance(v, list)
                            else v for k, v in state.items()}
    if getattr(optimizer, "_shards", None) is not None:
        optimizer._shards = [optimizer._shards[i] for i in idx]
    optimizer._parameter_list = list(params)


class DygraphShardingOptimizer:
    """Stage 1 over ``group`` (None: the fleet's sharding group)."""

    def __init__(self, optimizer, hcg=None, group=None):
        self._inner_opt = optimizer
        self._group = _sharding_group(group, hcg)
        self._nranks = self._group.nranks
        self._rank = self._group.rank
        all_params = list(optimizer._parameter_list)
        self._all_params = all_params
        self._buckets = _partition_params(all_params, self._nranks)
        self._local_params = self._buckets[self._rank]
        self._param_owner: Dict[int, int] = {
            id(p): r for r, bucket in enumerate(self._buckets)
            for p in bucket}
        # the inner optimizer updates (and keeps the state of) this
        # rank's part only
        _restrict(optimizer, self._local_params)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _owner_rank(self, r: int) -> int:
        return self._group.ranks[r]

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Each gradient summed into its owner's and averaged there; the
        other ranks drop theirs."""
        if self._nranks == 1:
            return
        for r, bucket in enumerate(self._buckets):
            for p in bucket:
                g = grad_of(p)
                if g is None:
                    continue
                dist.reduce(g, self._owner_rank(r), group=self._group)
                if r == self._rank:
                    g.div_(self._nranks)
                else:
                    _drop_grad(p)

    @torch.no_grad()
    def _sharding_sync_parameters(self) -> None:
        """Every parameter from its owner into every rank."""
        if self._nranks == 1:
            return
        for r, bucket in enumerate(self._buckets):
            for p in bucket:
                dist.broadcast(p.data, self._owner_rank(r),
                               group=self._group)

    def step(self) -> None:
        self.reduce_gradients()
        self._inner_opt.step()
        self._sharding_sync_parameters()

    def clear_grad(self, set_to_zero: bool = False) -> None:
        clear_grads(self._all_params, set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        return None, None


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Stage 2: ``optim`` over ``params``, sharded over ``group``, its
    gradients reduced to their owners during the backward."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kw):
        if offload:
            raise NotImplementedError(
                "stage 2's offload is not ported yet: see ROADMAP.md")
        optim._parameter_list = list(params)
        super().__init__(optim, group=group)
        self._offload = offload
        self._register_hooks()

    def _register_hooks(self) -> None:
        if self._nranks == 1:
            return
        for p in self._all_params:
            owner = self._param_owner[id(p)]
            p.register_hook(self._reduce_hook(owner))
            if owner != self._rank:
                # after .grad holds the sum, a part this rank does not own
                p.register_post_accumulate_grad_hook(_drop_grad)

    def _reduce_hook(self, owner: int):
        def hook(grad):
            # the backward's gradient of one parameter, all its uses
            # summed: into the owner's, averaged there. A copy: the
            # backward may hand the same tensor to another input, and a
            # reduce leaves a non-owner's buffer undefined
            out = grad.clone(memory_format=torch.contiguous_format)
            dist.reduce(out, self._owner_rank(owner), group=self._group)
            return out.div_(self._nranks) if owner == self._rank else grad

        return hook

    def reduce_gradients(self) -> None:
        """The hooks reduced the gradients; drop any a rank does not own."""
        for r, bucket in enumerate(self._buckets):
            if r != self._rank:
                for p in bucket:
                    _drop_grad(p)


class GroupShardedStage2:
    """The model of a stage-2 run: calls ``layer``; its attributes pass
    through."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="gpu", **kw):
        self._layer = layer
        self._sharding_optimizers = sharding_optimizer if isinstance(
            sharding_optimizer, list) else [sharding_optimizer]

    def __call__(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._layer, item)


class GroupShardedStage3:
    """Stage 3: ``layer``'s parameters sharded over ``group`` between
    steps, ``optimizer.step`` routed through :meth:`step`."""

    def __init__(self, layer, optimizer, group=None, sync_buffers=False,
                 device="gpu", segment_size=2 ** 15,
                 pertrain_sync_models=True, offload=False, sync_comm=False,
                 **kw):
        if getattr(optimizer, "_stage3_wrapped_by", None) is not None:
            # before any parameter is touched: raising after the shard
            # would leave the layer cut with no way back
            raise RuntimeError(
                "optimizer.step is already routed through a "
                "GroupShardedStage3 wrapper; sharing one optimizer across "
                "stage-3 wrappers would chain duplicate grad reduce + "
                "reshard passes. Use a separate optimizer per wrapped "
                "layer.")
        if offload:
            raise NotImplementedError(
                "stage 3's offload is not ported yet: see ROADMAP.md")
        self._layer = layer
        self._optimizer = optimizer
        self._group = _sharding_group(group, None)
        self._nranks = self._group.nranks
        self._rank = self._group.rank
        self._params = [p for p in layer.parameters() if p.requires_grad]
        if pertrain_sync_models and self._nranks > 1:
            with torch.no_grad():
                for p in self._params:
                    dist.broadcast(p.data, self._group.ranks[0],
                                   group=self._group)
        self._full_shapes = {id(p): tuple(p.shape) for p in self._params}
        self._sharded_ids: set = set()
        self._sharded = False
        if self._nranks > 1:
            self._shard_all()
            self._register_hooks()
        self._opt_step_orig = optimizer.step
        optimizer.step = self.step
        optimizer._stage3_wrapped_by = self

    # ------------------------------------------------ pieces and wholes
    def _shard_param(self, p: torch.Tensor) -> None:
        if id(p) in self._sharded_ids:
            return              # already a piece (its layer did not run)
        flat = p.data.reshape(-1)
        per = -(-flat.numel() // self._nranks)
        pad = per * self._nranks - flat.numel()
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        # a copy: the whole tensor's memory goes
        p.data = flat[self._rank * per:(self._rank + 1) * per].clone()
        self._sharded_ids.add(id(p))

    def _unshard_param(self, p: torch.Tensor) -> None:
        if id(p) not in self._sharded_ids:
            return              # a pre-hook made it whole this step
        pieces = dist.all_gather([], p.data, group=self._group)
        shape = self._full_shapes[id(p)]
        n = int(np.prod(shape))
        p.data = torch.cat(pieces)[:n].view(shape)
        self._sharded_ids.discard(id(p))

    def _shard_all(self) -> None:
        for p in self._params:
            self._shard_param(p)
        self._sharded = True

    def _unshard_all(self) -> None:
        for p in self._params:
            self._unshard_param(p)
        self._sharded = False

    def _register_hooks(self) -> None:
        def pre_hook(layer, inputs):
            for p in layer._parameters.values():
                if p is not None and id(p) in self._sharded_ids:
                    self._unshard_param(p)
            return None

        for sub in self._layer.sublayers(include_self=True):
            if sub._parameters:
                sub.register_forward_pre_hook(pre_hook)

    # ------------------------------------------------ the model's surface
    def __call__(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._layer, item)

    @torch.no_grad()
    def step(self) -> None:
        """Average the gradients over the group, update the whole
        parameters, cut them to their pieces again."""
        if self._nranks <= 1:
            self._opt_step_orig()
            return
        for p in self._params:
            g = grad_of(p)
            if g is None:
                continue
            dist.all_reduce(g, group=self._group)
            g.div_(self._nranks)
        self._opt_step_orig()
        self._optimizer.clear_grad()
        self._shard_all()

    def state_dict(self, *args, **kwargs):
        """The layer's state dict with every parameter whole (copies)."""
        was_sharded = self._sharded
        if was_sharded:
            self._unshard_all()
        sd = {k: v.detach().clone() for k, v in
              self._layer.state_dict(*args, **kwargs).items()}
        if was_sharded:
            self._shard_all()
        return sd
