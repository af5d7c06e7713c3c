"""The training step: forward, backward, global-norm clipping, update.

Port of ``paddle_tpu/jit/train_step.py`` (``TrainStep``,
``ChunkPrefetcher``) for one device. The JAX package compiles the step
(``pure_step``) into one program; PyTorch runs eagerly, so here the step
is plain code over the model's own parameters, which the optimizer
updates in place:

  loss = loss_fn(model, *batch)      or model(*inputs, labels=labels)
  grads = d loss / d params          (accumulate_steps = k > 1: summed
                                      in f32 over k micro-batches, / k)
  gnorm = grad_health(grads)         (with clipping or a health policy)
  skip policy and gnorm non-finite:  stop here, nothing written
  grads *= min(1, clip / (gnorm + 1e-6)) (cast to each grad's dtype)
  optimizer.update(params, grads, opt_state, lr)

``opt_state`` keeps the JAX package's layout (``{"m", "v", "vr", "vc",
"t"}``, or ``{"m", "m_ax", "v", "v_ax", "t"}`` with 8-bit moments; lists
in ``named_parameters`` order), so a JAX run's state carries over
(:func:`paddle_tpu_torch.convert.opt_state_from_paddle_tpu`, then
:meth:`TrainStep.restore_state`).

The health policy (:mod:`..observability.health`) is captured when the
step is built, as the JAX package compiles it in. Under ``skip`` the
step reads ``isfinite(gnorm)`` on the host once before it writes (the
update is in place); under ``warn`` / ``raise`` the norms are read after
the step or the chunk; with the policy ``off`` nothing syncs.

Dropout draws from the step's own ``torch.Generator`` (seeded by
``seed``), installed for the duration of each step
(:func:`paddle_tpu_torch.core.random.rng_guard`, the JAX ``rng_guard``).

On a mesh (``mesh=ProcessMesh(...)`` over the axes ``dp``, ``sp`` and
``mp``, ``fsdp_axis="dp"`` optional, ``batch_specs`` as in the JAX step) the
step is one process a rank (:func:`paddle_tpu_torch.distributed.spawn`,
:func:`~paddle_tpu_torch.distributed.init_parallel_env`), each running
this code on its shards, the counterpart of the JAX step's one SPMD
program:

  the model's parameters are sliced to this rank's pieces
  (:func:`..distributed.sharding.shard_model`: tensor-parallel layers
  over ``mp``, FSDP units over ``dp``);
  every rank is given the global batch and takes its ``dp`` part (with
  ``accumulate_steps = k`` the global batch's k micro-batches, each
  split over ``dp``, as the JAX step splits them) and of each row its
  ``sp`` part along dim 1 (whether or not ``batch_specs`` names ``sp``:
  the JAX model moves its activations onto ``sp`` either way), which the
  model's attention joins by ``sequence_parallel_mode``;
  the loss is the global mean over every ``dp`` and ``sp`` rank's tokens;
  gradients are summed over the ``dp`` and ``sp`` ranks that replicate
  the parameter, in one all-reduce over both (FSDP ones arrive
  reduce-scattered over ``dp``; no parameter is split over ``sp``);
  the clip norm is global (:func:`..observability.health.grad_health`
  over the shards' groups), and AdamW's factored statistics are the
  whole matrix's (``AdamW.update(..., shards=...)``).

``opt_state`` then holds this rank's pieces, and the model keeps its
local shards; :func:`paddle_tpu_torch.convert.gather_params` and
:func:`~paddle_tpu_torch.convert.gather_opt_state` gather them whole.
A mesh axis other than ``dp`` / ``sp`` / ``mp``, an FSDP axis other than
``dp``, MoE, dropout, 8-bit moments, ``run_steps_stream`` and the TP
overlap raise on a mesh (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import math
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import knobs
from ..core import random as _random
from ..device import DeviceLike, resolve_device
from ..distributed import collective
from ..distributed.auto_parallel.constraint import filtered_spec
from ..distributed.auto_parallel.process_mesh import ProcessMesh
from ..distributed.sharding import shard_model
from ..observability import health
from ..optimizer.lr import LRScheduler

__all__ = ["TrainStep", "ChunkPrefetcher"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ChunkPrefetcher:
    """Assembles ``[n, ...]`` stacked chunks from a batch iterator on a
    background thread while the device runs the current chunk (the JAX
    package's ``ChunkPrefetcher``).

    ``source`` yields per-step batches (tuples / lists of arrays or
    tensors, or one array); each chunk stacks ``n`` of them along a new
    leading axis (numpy arrays), ready for
    ``TrainStep.run_steps_stream``. At most ``depth`` chunks wait in the
    queue. A trailing partial group (fewer than ``n`` batches) is
    dropped, like drop_last. An error in ``source`` surfaces from
    ``next()``; :meth:`close` stops the thread.
    """

    _SENTINEL = object()

    def __init__(self, source, n: int, depth: int = 2):
        if n <= 0:
            raise ValueError(f"chunk size must be >= 1, got {n}")
        self._n = n
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._terminal = None  # StopIteration / surfaced error, sticky
        self._thread = threading.Thread(
            target=self._fill, args=(iter(source),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts when close() poisons the feeder."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, it):
        try:
            while not self._stop.is_set():
                group = []
                for _ in range(self._n):
                    try:
                        group.append(next(it))
                    except StopIteration:
                        self._put(self._SENTINEL)
                        return
                group = [b if isinstance(b, (tuple, list)) else (b,)
                         for b in group]
                chunk = tuple(np.stack([_host(b[i]) for b in group])
                              for i in range(len(group[0])))
                if not self._put(chunk):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._put(e)

    def close(self):
        """Stop the fill thread and release buffered chunks (call when
        abandoning iteration early)."""
        self._stop.set()
        self._terminal = StopIteration()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        if self._terminal is not None:
            raise self._terminal
        item = self._q.get()
        if item is self._SENTINEL:
            self._terminal = StopIteration()
            raise self._terminal
        if isinstance(item, BaseException):
            self._terminal = item
            raise item
        return item


_MESH_AXES = ("dp", "sp", "mp")
_UNPORTED_AXES = {
    "ep": "the expert-parallel axis",
    "pp": "pipeline x tensor-parallel hybrids"}


def _unported(what: str):
    return NotImplementedError("%s on a mesh is not ported yet: see "
                               "ROADMAP.md" % what)


class TrainStep:
    """``step = TrainStep(model, opt, grad_clip_norm=1.0)``;
    ``loss = step(input_ids, labels)``.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for) and
    must be where the model's parameters are; batches (tensors or numpy
    arrays) are moved there. Without ``loss_fn(model, *batch)`` the last
    batch entry goes to the model as ``labels`` (CausalLM models return
    the loss when given labels). ``accumulate_steps = k > 1`` splits
    each batch along dim 0 into k micro-batches (gradient merge).
    ``seed`` seeds the step's dropout generator. ``mesh``, ``fsdp_axis``
    and ``batch_specs``: sharded training (the module note); the model
    is sliced to this rank's shards when the step is built. On a mesh a
    ``loss_fn`` must return the global loss as the models do (its
    gradient this rank's share, see :mod:`..fusion.chunked`)."""

    def __init__(self, model: torch.nn.Module, optimizer, mesh=None,
                 loss_fn: Optional[Callable] = None,
                 grad_clip_norm: Optional[float] = None,
                 fsdp_axis: Optional[str] = None, accumulate_steps: int = 1,
                 device: DeviceLike = None, seed: int = 0,
                 batch_specs=None):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = max(int(accumulate_steps), 1)
        # captured at build, as the JAX step compiles the policy in
        self._health = health.get_policy()
        self._health_on = self._health != "off"
        self._params = []
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError("parameter %s is on %s, the step on %s"
                                 % (name, p.device, self.device))
            self._params.append(p)
        self.mesh = mesh
        self._root = self._norm_groups = self._adam_shards = None
        if mesh is not None:
            self._setup_mesh(mesh, fsdp_axis, batch_specs)
        self.opt_state = optimizer.init_state(self._params)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._step_count = 0

    # ----------------------------------------------------------------- mesh
    def _setup_mesh(self, mesh, fsdp_axis, batch_specs) -> None:
        """Check what the mesh path supports, shard the model and note
        each parameter's groups."""
        if not isinstance(mesh, ProcessMesh):
            raise _unported("a mesh other than paddle_tpu_torch.distributed."
                            "ProcessMesh (%s)" % type(mesh).__name__)
        for name in mesh.dim_names:
            if name not in _MESH_AXES:
                raise _unported(_UNPORTED_AXES.get(
                    name, "a mesh axis %r" % name))
        if fsdp_axis in mesh.dim_names and fsdp_axis != "dp":
            raise _unported("FSDP over %r (only dp is ported)" % fsdp_axis)
        if knobs.get_str("PADDLE_TPU_TP_OVERLAP").strip().lower() in (
                "on", "pallas"):
            raise _unported("the TP overlap (overlap_linear, K9)")
        if getattr(self.optimizer, "_moment_quant", None):
            raise _unported("8-bit moments")
        cfg = getattr(self.model, "config", None)
        if getattr(cfg, "moe_num_experts", 0):
            raise _unported("MoE GPT")
        if getattr(cfg, "dropout", 0.0) or getattr(
                cfg, "attention_dropout", 0.0):
            raise _unported("dropout")
        mp, sp = mesh.axis_size("mp"), mesh.axis_size("sp")
        for key in ("num_heads", "num_kv_heads"):
            if getattr(cfg, key, 0) % mp:
                raise ValueError("%s=%d does not divide by mp=%d"
                                 % (key, getattr(cfg, key), mp))
        if getattr(cfg, "sequence_parallel_mode", "gspmd") == "ulysses" \
                and (cfg.num_heads // mp) % sp:
            raise ValueError("ulysses: num_heads / mp = %d does not divide "
                             "by sp=%d" % (cfg.num_heads // mp, sp))
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs the process group: call "
                               "paddle_tpu_torch.distributed."
                               "init_parallel_env() in every rank first")
        self._root = shard_model(self.model, mesh, fsdp_axis)
        self._norm_groups, self._adam_shards = [], []
        self._grad_reduce = []      # (parameter index, group)
        for i, p in enumerate(self._params):
            spec = p.dist_layout.spec
            self._norm_groups.append(mesh.group_of(spec))
            self._adam_shards.append((mesh.group_of(spec[:1]),
                                      mesh.group_of(spec[1:])))
            # the batch axes that replicate p: one all-reduce over both
            group = mesh.group_of(a for a in ("dp", "sp") if a not in spec)
            if group is not None:
                self._grad_reduce.append((i, group))
        self._dp_size, self._dp_rank = mesh.axis_size("dp"), mesh.coord("dp")
        self._sp_size, self._sp_rank = sp, mesh.coord("sp")
        self._batch_specs = None if batch_specs is None else [
            filtered_spec(b, mesh) for b in batch_specs]
        for spec in self._batch_specs or ():
            if "dp" in spec[1:]:
                raise _unported("a batch split over dp past its dim 0")

    def _dp_part(self, a: torch.Tensor, spec) -> torch.Tensor:
        """This rank's ``dp`` rows of a global batch array: with k
        micro-batches, its part of each, as the JAX step splits them."""
        split = a.dim() > 0 if spec is None else bool(spec) and \
            spec[0] == "dp"
        if not split:
            return a
        k, n = self.accumulate_steps, self._dp_size
        if a.shape[0] % (k * n):
            raise ValueError("batch dim %d does not split into %d "
                             "micro-batches over dp=%d"
                             % (a.shape[0], k, n))
        m = a.shape[0] // (k * n)
        r = self._dp_rank
        return a.reshape((k, n * m) + tuple(a.shape[1:]))[
            :, r * m:(r + 1) * m].reshape((k * m,) + tuple(a.shape[1:]))

    def _sp_part(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's ``sp`` part of dim 1 (each row's sequence) of a
        batch array."""
        n = self._sp_size
        if n == 1 or a.dim() < 2:
            return a
        if a.shape[1] % n:
            raise ValueError("sequence dim %d does not split over sp=%d"
                             % (a.shape[1], n))
        s = a.shape[1] // n
        return a[:, self._sp_rank * s:(self._sp_rank + 1) * s].contiguous()

    # ----------------------------------------------------------- one step
    def _loss(self, batch) -> torch.Tensor:
        with (self._root.gathered() if self._root is not None
              else contextlib.nullcontext()):
            return self._model_loss(batch)

    def _model_loss(self, batch) -> torch.Tensor:
        if self.loss_fn is not None:
            return self.loss_fn(self.model, *batch)
        if len(batch) >= 2:
            return self.model(*batch[:-1], labels=batch[-1])
        return self.model(*batch)

    def _loss_and_grads(self, batch):
        k = self.accumulate_steps
        if k == 1:
            loss = self._loss(batch)
            return loss.detach(), list(torch.autograd.grad(loss,
                                                           self._params))
        # gradient merge: f32 accumulators (k successive bf16 adds would
        # round away low-order gradient bits before the / k)
        micro = [b.chunk(k) for b in batch]
        g_sum, l_sum = None, torch.zeros((), dtype=torch.float32,
                                         device=self.device)
        for i in range(k):
            loss = self._loss(tuple(m[i] for m in micro))
            grads = torch.autograd.grad(loss, self._params)
            l_sum += loss.detach().float()
            if g_sum is None:
                g_sum = [g.to(torch.float32, copy=True) for g in grads]
            else:
                for a, g in zip(g_sum, grads):
                    a.add_(g)
            del loss, grads
        return l_sum / k, [g.div_(k) for g in g_sum]

    def _step(self, batch, lr: float):
        """One optimizer step; returns ``(loss, gnorm)``: gnorm a 0-d
        tensor, a float under the skip policy (read before the update),
        None without clipping or health."""
        with _random.rng_guard(self._generator):
            loss, grads = self._loss_and_grads(batch)
        if self.mesh is not None:
            for i, group in self._grad_reduce:
                collective.all_reduce(grads[i], group=group)
        gnorm = seen = None
        if self.grad_clip_norm is not None or self._health_on:
            gnorm = seen = health.grad_health(grads, self._norm_groups)
        if self._health == "skip":
            seen = gnorm.item()
            if not math.isfinite(seen):
                return loss, seen           # params and state untouched
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-6),
                                max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.optimizer.update(self._params, grads, self.opt_state, lr=lr,
                              shards=self._adam_shards)
        return loss, seen

    def _run(self, n: int, batch_of, lrs):
        """``n`` steps, step i on ``batch_of(i)`` at ``lrs[i]``; returns
        the last loss and every step's gnorm (health on)."""
        gnorms = []
        for i in range(n):
            loss, gnorm = self._step(batch_of(i), lrs[i])
            if self._health_on:
                gnorms.append(gnorm)
        return loss, gnorms

    def _record_chunk_health(self, gnorms, base: int) -> None:
        """With health on, record every step's grad norm in order (one
        device-to-host read of the chunk's norms; under skip they are
        already on the host)."""
        if not gnorms:
            return
        if not isinstance(gnorms[0], float):
            gnorms = torch.stack(gnorms).tolist()
        for i, g in enumerate(gnorms):
            health.record_step(float(g), source="grad", step=base + i)

    def _finish(self, n: int, loss, gnorms) -> torch.Tensor:
        base = self._step_count
        self._step_count += n
        self._record_chunk_health(gnorms, base)
        return loss

    # -------------------------------------------------------------- batches
    def _check_batch(self, arrays, leading_steps: Optional[int] = None):
        """The JAX ``_prepare_batch`` checks: with ``leading_steps=n`` the
        arrays are stacked per-step chunks [n, batch, ...] (the leading
        dim must be n, the divisibility check applies to the inner batch
        dim)."""
        bdim = 0 if leading_steps is None else 1
        if leading_steps is not None:
            for a in arrays:
                if not a.ndim or a.shape[0] != leading_steps:
                    raise ValueError(
                        f"run_steps_stream({leading_steps}): stacked "
                        f"arrays need leading dim {leading_steps}, "
                        f"got {tuple(a.shape)}")
        if self.accumulate_steps > 1:
            for a in arrays:
                if a.ndim > bdim and a.shape[bdim] % self.accumulate_steps:
                    raise ValueError(
                        f"gradient merge: batch dim {a.shape[bdim]} is not "
                        f"divisible by accumulate_steps="
                        f"{self.accumulate_steps}")
        return arrays

    def _batch(self, batch):
        if self.mesh is None:
            return self._check_batch(tuple(
                torch.as_tensor(b, device=self.device) for b in batch))
        arrays = self._check_batch(tuple(torch.as_tensor(b) for b in batch))
        specs = self._batch_specs or [None] * len(arrays)
        return tuple(self._sp_part(self._dp_part(a, s)).to(self.device)
                     for a, s in zip(arrays, specs))

    def _stacked(self, stacked, n: int):
        """Per-step slices of ``[n, ...]`` stacked inputs, each copied to
        the device when its step starts, so the device never holds all n
        batches: host inputs are pinned once (on a CUDA step) and each
        slice goes over by a non-blocking copy on the step's stream."""
        host = self._check_batch(tuple(
            b if isinstance(b, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(b)) for b in stacked), leading_steps=n)
        if self.device.type == "cuda":
            host = tuple(b.pin_memory() if b.device.type == "cpu" else b
                         for b in host)

        def batch_of(i):
            return tuple(b[i].to(self.device, non_blocking=True)
                         for b in host)
        return batch_of

    # ------------------------------------------------------------------ run
    def __call__(self, *batch) -> torch.Tensor:
        """One step on ``batch`` (inputs..., labels); returns the loss (a
        0-d tensor)."""
        arrays = self._batch(batch)
        return self._finish(1, *self._run(
            1, lambda i: arrays, [self.optimizer.get_lr()]))

    def run_steps(self, n: int, *batch) -> torch.Tensor:
        """``n`` steps on the same batch at the learning rate read once
        at the start (a scheduler is not advanced: the JAX ``run_steps``
        holds it for the chunk); returns the last step's loss."""
        if n <= 0:
            raise ValueError(f"run_steps needs n >= 1, got {n}")
        arrays = self._batch(batch)
        lr = self.optimizer.get_lr()
        return self._finish(n, *self._run(n, lambda i: arrays, [lr] * n))

    def _chunk_lrs(self, n: int):
        """Per-step learning rates for an n-step chunk (f32 values, as
        the JAX step takes them); advances an LRScheduler by n so chunked
        training follows the step-by-step schedule."""
        lr = self.optimizer._learning_rate
        if isinstance(lr, LRScheduler):
            vals = []
            for _ in range(n):
                vals.append(float(lr()))
                lr.step()
            return np.asarray(vals, np.float32).tolist()
        return np.full((n,), float(lr), np.float32).tolist()

    def run_steps_stream(self, n: int, *stacked, lrs=None) -> torch.Tensor:
        """``n`` optimizer steps, each on its OWN slice of ``stacked``
        arrays of shape ``[n, batch, ...]`` and at its own learning rate:
        training on fresh data every step (pair with
        :class:`ChunkPrefetcher`). ``lrs`` is an optional ``[n]`` array;
        by default the rates come from the optimizer's scheduler, which
        is advanced n steps (and restored from its snapshot if the chunk
        fails). Returns the last step's loss."""
        if n <= 0:
            raise ValueError(f"run_steps_stream needs n >= 1, got {n}")
        if self.mesh is not None:
            raise _unported("run_steps_stream")
        batch_of = self._stacked(stacked, n)
        if lrs is not None:
            lrs = np.asarray(_host(lrs), np.float32)
            if lrs.shape != (n,):
                raise ValueError(f"lrs must have shape ({n},), "
                                 f"got {lrs.shape}")
            lrs = lrs.tolist()
        sched = self.optimizer._learning_rate
        snapshot = sched.state_dict() if (
            lrs is None and isinstance(sched, LRScheduler)) else None
        if lrs is None:
            lrs = self._chunk_lrs(n)
        try:
            out = self._run(n, batch_of, lrs)
        except Exception:
            if snapshot is not None:
                sched.set_state_dict(snapshot)
            raise
        return self._finish(n, *out)

    def sync_params_to_model(self) -> None:
        """Kept for the JAX API: the step updates the model's own
        parameters in place, so there is nothing to write back (on a
        mesh they stay this rank's shards:
        :func:`paddle_tpu_torch.convert.gather_params` gathers them)."""

    def restore_state(self, opt_state=None) -> None:
        """Resume: the step already works on the model's parameters (so
        an in-place ``load_state_dict`` is seen as it is); when given,
        ``opt_state`` (the layout of ``self.opt_state``; see
        :func:`paddle_tpu_torch.convert.opt_state_from_paddle_tpu`)
        replaces the optimizer state, moved onto the step's device and
        into the current entries' dtypes and shapes."""
        if opt_state is None:
            return
        new = {}
        for key, cur in self.opt_state.items():
            src = opt_state[key]
            if isinstance(cur, list):
                if len(src) != len(cur):
                    raise ValueError("opt_state[%r] has %d entries, the "
                                     "step %d" % (key, len(src), len(cur)))
                new[key] = [torch.as_tensor(s).to(self.device, c.dtype)
                            .reshape(c.shape).clone()
                            for s, c in zip(src, cur)]
            else:
                new[key] = torch.as_tensor(src).to(
                    self.device, cur.dtype).reshape(cur.shape).clone()
        self.opt_state = new
