"""The 1F1B micro-batch pipeline over a ring of devices.

Port of ``paddle_tpu/distributed/pipeline/schedule.py``'s
:class:`CompiledPipeline`. The JAX class runs the whole schedule as one
``jit`` of a ``shard_map`` body over a ``pp`` mesh axis; here one process
drives a :class:`~paddle_tpu_torch.distributed.Ring` with stage s on
``ring.device(s)`` and runs the same schedule eagerly:

* stage s's slice of every ``stacked_params`` leaf (``[S, ...]``) lives
  on stage s's device; ``extra_params`` (embeddings, head, final norm)
  are replicated on every stage's device;
* ``M + S - 1`` ticks: at each tick every stage receives its upstream
  boundary tensor through :func:`~.transport.ring_shift` (K10 on the
  card), runs ``stage_fn`` on it (stage 0 on ``pre_fn`` of its
  micro-batch instead, which masks the ring's wrap-around edge), and
  passes the result on; the last stage keeps its outputs from tick
  ``S - 1`` on. The host enqueues every stage's work each tick, so
  stages on distinct cards run side by side;
* the loss is the mean of ``loss_fn`` over the micro-batches on the last
  stage; autograd runs the backward (the transpose of each ring step is
  the reverse step, on K10 too), and the gradients of the replicated
  ``extra_params`` are summed over the stages (the JAX ``bucket_taps``
  psum over ``pp``) before the optimizer updates every replica alike.

Per step the schedule shifts ``M + S - 1`` times forward (one K10 launch
a stage each) and ``M + S - 2`` times backward: the first tick's shift
carries the zero boundary tensors, which need no gradient.

There is no ``jit`` (and no ``trace_count``). ``dp > 1`` (the
data-parallel ``bucket_taps``) and ``bucket_bytes`` are not ported yet
and raise, as does the Engine bridge ``CompiledStagedTrainStep``
(ROADMAP.md).

The parameters come in as arrays (numpy or tensors): the JAX package's
numpy leaves carry over with ``torch.from_numpy`` (or
``paddle_tpu_torch.convert.params_from_paddle_tpu``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ring import Ring
from .transport import ring_shift

__all__ = ["CompiledPipeline"]


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of a tree of dicts / lists / tuples (dicts in key order, as
    JAX flattens them) and the function that rebuilds the tree."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(flat):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(flat[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out) if isinstance(tree, tuple) else out

    return leaves, rebuild


def _tensor(a) -> torch.Tensor:
    return a.detach() if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.asarray(a))


class CompiledPipeline:
    """1F1B pipeline over a ring of ``num_stages`` devices.

    Args (as the JAX class):
        stage_fn: ``(stage_params, h) -> h``, the same for every stage,
            applied to stage s's slice of ``stacked_params``.
        stacked_params: tree whose leaves are per-stage arrays ``[S, ...]``.
        loss_fn: ``(extra_params, h_last, y_micro) -> scalar`` mean loss of
            one micro-batch, on the last stage.
        num_stages / num_micro: pipeline depth ``S`` and micro-batch count
            ``M`` (the batch size must divide by ``M``).
        optimizer: functional optimizer (``init_state`` / ``update``, e.g.
            :class:`~paddle_tpu_torch.optimizer.SGD`) or None.
        extra_params: tree of parameters shared across stage boundaries,
            replicated on every stage's device.
        pre_fn: ``(extra_params, x_micro) -> h0``, the input embedding of
            stage 0; identity when None.
        devices: a :class:`Ring` or a list of ``S`` devices (one a stage;
            a device may repeat); ``None`` means cards ``cuda:0`` ..
            ``cuda:S-1``.
        dp, bucket_bytes: data parallelism; only ``dp=1`` is ported.
    """

    def __init__(self, stage_fn: Callable, stacked_params, loss_fn: Callable,
                 num_stages: int, num_micro: int, optimizer=None,
                 extra_params=None, pre_fn: Optional[Callable] = None,
                 devices=None, dp: int = 1,
                 bucket_bytes: Optional[int] = None):
        if dp != 1 or bucket_bytes is not None:
            raise NotImplementedError(
                "dp > 1 and bucket_bytes (the data-parallel bucket_taps) are "
                "not ported yet: see ROADMAP.md")
        self.stage_fn, self.loss_fn, self.pre_fn = stage_fn, loss_fn, pre_fn
        self.optimizer = optimizer
        self.S, self.M = int(num_stages), int(num_micro)
        if devices is None:
            devices = ["cuda:%d" % s for s in range(self.S)]
        self.ring = devices if isinstance(devices, Ring) else \
            Ring(list(devices)[:self.S])
        if self.ring.size != self.S:
            raise ValueError("CompiledPipeline needs %d devices (one a "
                             "stage), got %d" % (self.S, self.ring.size))

        leaves, self._stacked_def = _flatten(stacked_params)
        leaves = [_tensor(a) for a in leaves]
        # _stage[s]: stage s's slices, leaf by leaf, on its device
        self._stage = [[a[s].to(self.ring.device(s)).clone()
                        .requires_grad_() for a in leaves]
                       for s in range(self.S)]
        extra, self._extra_def = _flatten(
            extra_params if extra_params is not None else {})
        extra = [_tensor(a) for a in extra]
        # _extra[s]: the replica on stage s's device
        self._extra = [[a.to(self.ring.device(s)).clone().requires_grad_()
                        for a in extra] for s in range(self.S)]
        self.opt_state = optimizer.init_state(self._flat()) \
            if optimizer is not None else {}

    def _flat(self) -> List[torch.Tensor]:
        return [p for st in self._stage for p in st] + \
            [p for rep in self._extra for p in rep]

    # ------------------------------------------------------------ views
    @property
    def params(self):
        """``stacked_params`` as they stand: leaves ``[S, ...]`` gathered
        onto the CPU (copies)."""
        n = len(self._stage[0])
        return self._stacked_def([torch.stack(
            [self._stage[s][i].detach().cpu() for s in range(self.S)])
            for i in range(n)])

    @property
    def extra(self):
        """``extra_params`` as they stand, from stage 0's replica, on the
        CPU (copies)."""
        return self._extra_def([p.detach().cpu() for p in self._extra[0]])

    # --------------------------------------------------------- schedule
    def _loss(self, x, y) -> torch.Tensor:
        S, M, ring = self.S, self.M, self.ring
        x, y = _tensor(x), _tensor(y)
        xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:])) \
            .to(ring.device(0))
        ys = y.reshape((M, y.shape[0] // M) + tuple(y.shape[1:])) \
            .to(ring.device(S - 1))
        stage_p = [self._stacked_def(p) for p in self._stage]
        extra_first = self._extra_def(self._extra[0])
        extra_last = self._extra_def(self._extra[S - 1])

        def embed(xm):
            return self.pre_fn(extra_first, xm) if self.pre_fn is not None \
                else xm

        h0 = embed(xs[0])
        y_prev = [h0.new_zeros(h0.shape, device=ring.device(s))
                  for s in range(S)]
        outs = []
        for t in range(M + S - 1):
            recv = ring_shift(y_prev, ring)
            h_in = [h0 if t == 0 else embed(xs[min(t, M - 1)])] + recv[1:]
            y_prev = [self.stage_fn(stage_p[s], h_in[s]) for s in range(S)]
            if t >= S - 1:
                outs.append(y_prev[S - 1])
        losses = [self.loss_fn(extra_last, h, ys[i])
                  for i, h in enumerate(outs)]
        return torch.stack(losses).mean()

    def _grads(self, loss) -> Tuple[List[List[torch.Tensor]],
                                    List[torch.Tensor]]:
        """Per-stage gradients, and the extra gradients summed over the
        stages onto stage 0's device."""
        flat = self._flat()
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, gs)]
        n = len(self._stage[0])
        stage_g = [gs[s * n:(s + 1) * n] for s in range(self.S)]
        e = len(self._extra[0])
        rest = gs[self.S * n:]
        dev0 = self.ring.device(0)
        extra_g = []
        for i in range(e):
            acc = rest[i]
            for s in range(1, self.S):
                acc = acc + rest[s * e + i].to(dev0)
            extra_g.append(acc)
        return stage_g, extra_g

    def loss_and_grads(self, x, y):
        """``(loss, stage_grads, extra_grads)`` without the update:
        ``stage_grads[s]`` is stage s's slice of the ``stacked_params``
        tree, on its device (the JAX class returns them stacked and
        sharded over ``pp``); ``extra_grads`` the ``extra_params`` tree,
        summed over the stages, on stage 0's device."""
        loss = self._loss(x, y)
        stage_g, extra_g = self._grads(loss)
        return (loss.detach(), [self._stacked_def(g) for g in stage_g],
                self._extra_def(extra_g))

    def step(self, x, y) -> torch.Tensor:
        """One train step over the full batch; returns the loss (a 0-d
        tensor on the last stage's device)."""
        loss = self._loss(x, y)
        stage_g, extra_g = self._grads(loss)
        if self.optimizer is not None:
            flat = self._flat()
            grads = [g for st in stage_g for g in st] + \
                [g.to(self.ring.device(s)) for s in range(self.S)
                 for g in extra_g]
            new, self.opt_state = self.optimizer.update(
                [p.detach() for p in flat], grads, self.opt_state)
            with torch.no_grad():
                for p, q in zip(flat, new):
                    p.copy_(q)
        return loss.detach()
