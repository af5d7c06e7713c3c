"""``DataParallel``: eager pure data parallelism, one process a rank.

Port of ``paddle_tpu/distributed/parallel.py`` (``DataParallel``,
``_Reducer``, after Paddle's C++ ``EagerReducer``):

* at wrap time every parameter is broadcast from the group's first rank;
* the trainable parameters are cut into buckets of ``comm_buffer_size``
  MB in reverse registration order (about the order backward finishes
  them);
* each parameter's gradient-ready hook (``register_post_accumulate_
  grad_hook``: after ``.grad`` holds its sum) marks it ready, and a
  bucket whose members are all ready is all-reduced at once: the grads
  flattened into one f32 buffer, summed over the group (NCCL on cards,
  gloo on the CPU), divided by ``nranks`` and copied back;
* ``forward`` re-arms the buckets in training; ``sync_gradients`` /
  ``apply_collective_grads`` flush a bucket left pending (a parameter
  that received no gradient); ``scale_loss`` returns the loss;
  ``state_dict`` / ``parameters`` pass through to the wrapped layer.

The gradients are the mean over the ranks, so every rank steps its
optimizer to the same parameters.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..nn import Layer

__all__ = ["DataParallel"]


class _Reducer:
    """Buckets of at most ``bucket_bytes`` in reverse registration order,
    each all-reduced when all its gradients are ready."""

    def __init__(self, params, group, nranks: int, bucket_bytes: int):
        self._params = [p for p in params if p.requires_grad]
        self._group = group
        self._nranks = nranks
        self.buckets: List[List[torch.Tensor]] = []
        cur, cur_bytes = [], 0
        for p in reversed(self._params):
            cur.append(p)
            cur_bytes += p.numel() * p.element_size()
            if cur_bytes >= bucket_bytes:
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            self.buckets.append(cur)
        self._bucket_of = {id(p): bi for bi, b in enumerate(self.buckets)
                           for p in b}
        self.flushes = 0
        self.prepare_for_backward()
        for p in self._params:
            p.register_post_accumulate_grad_hook(self._ready)

    def _ready(self, p: torch.Tensor) -> None:
        bi = self._bucket_of[id(p)]
        self._pending[bi].discard(id(p))
        if not self._pending[bi]:
            self._flush(bi)

    @torch.no_grad()
    def _flush(self, bi: int) -> None:
        bucket = [p for p in self.buckets[bi] if p.grad is not None]
        if not bucket:
            return
        flat = torch.cat([p.grad.reshape(-1).float() for p in bucket])
        dist.all_reduce(flat, group=self._group)
        flat.div_(self._nranks)
        off = 0
        for p in bucket:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n
        self.flushes += 1

    def prepare_for_backward(self) -> None:
        self._pending = [set(id(p) for p in b) for b in self.buckets]

    def sync(self) -> None:
        """Flush every bucket that still waits for a member."""
        for bi, pending in enumerate(self._pending):
            if pending:
                self._flush(bi)
                self._pending[bi] = set()


class DataParallel(Layer):
    """``DataParallel(layers, comm_buffer_size=25, group=None)``: runs
    ``layers`` and averages its gradients over ``group`` (every rank when
    None) during backward. One rank: the layer itself, no hooks."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        nranks = dist.get_world_size(group) if dist.is_initialized() else 1
        self._reducer: Optional[_Reducer] = None
        if nranks > 1:
            src = dist.get_global_rank(group, 0) if group is not None else 0
            with torch.no_grad():
                for p in layers.parameters():
                    dist.broadcast(p.data, src, group=group)
            self._reducer = _Reducer(layers.parameters(), group, nranks,
                                     comm_buffer_size * 1024 * 1024)

    def forward(self, *inputs, **kwargs):
        if self._reducer is not None and self.training:
            self._reducer.prepare_for_backward()
        return self._layers(*inputs, **kwargs)

    def sync_gradients(self) -> None:
        if self._reducer is not None:
            self._reducer.sync()

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self) -> None:
        self.sync_gradients()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             recurse, remove_duplicate)
