"""The training step: forward, backward, global-norm clipping, update.

Port of ``paddle_tpu/jit/train_step.py`` ``TrainStep`` for one device.
The JAX package compiles the step (``pure_step``) into one program;
PyTorch runs eagerly, so here the step is plain code over the model's
own parameters, which the optimizer updates in place:

  loss = model(*inputs, labels=labels)
  grads = d loss / d params
  gnorm = grad_health(grads); scale = min(1, clip / (gnorm + 1e-6))
  grads *= scale (cast to each grad's dtype)
  optimizer.update(params, grads, opt_state, lr)

``opt_state`` keeps the JAX package's layout (``{"m", "v", "vr", "vc",
"t"}``, lists in ``named_parameters`` order), so a JAX run's state carries
over (:func:`paddle_tpu_torch.convert.opt_state_from_paddle_tpu`, then
:meth:`TrainStep.restore_state`). A custom ``loss_fn``, a mesh, FSDP,
gradient merge, the health policies and ``run_steps_stream`` are later
slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..observability import health

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, opt, grad_clip_norm=1.0)``;
    ``loss = step(input_ids, labels)``.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for) and
    must be where the model's parameters are; batches (tensors or numpy
    arrays) are moved there. The last batch entry goes to the model as
    ``labels`` (CausalLM models return the loss when given labels)."""

    def __init__(self, model: torch.nn.Module, optimizer, mesh=None,
                 grad_clip_norm: Optional[float] = None,
                 fsdp_axis: Optional[str] = None, accumulate_steps: int = 1,
                 device: DeviceLike = None):
        if mesh is not None or fsdp_axis is not None:
            raise NotImplementedError(
                "sharded training (mesh, fsdp_axis) is not ported yet: see "
                "ROADMAP.md")
        if int(accumulate_steps) > 1:
            raise NotImplementedError(
                "gradient merge (accumulate_steps > 1) is not ported yet: "
                "see ROADMAP.md")
        if health.policy() != "off":
            raise NotImplementedError(
                "the training health policies (PADDLE_TPU_HEALTH=%s) are "
                "not ported yet: see ROADMAP.md" % health.policy())
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.grad_clip_norm = grad_clip_norm
        self._params = []
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError("parameter %s is on %s, the step on %s"
                                 % (name, p.device, self.device))
            self._params.append(p)
        self.opt_state = optimizer.init_state(self._params)

    def _step(self, batch, lr: float) -> torch.Tensor:
        loss = self.model(*batch[:-1], labels=batch[-1])
        grads = list(torch.autograd.grad(loss, self._params))
        if self.grad_clip_norm is not None:
            gnorm = health.grad_health(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-6),
                                max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.optimizer.update(self._params, grads, self.opt_state, lr=lr)
        return loss.detach()

    def _batch(self, batch):
        return tuple(torch.as_tensor(b, device=self.device) for b in batch)

    def __call__(self, *batch) -> torch.Tensor:
        """One step on ``batch`` (inputs..., labels); returns the loss (a
        0-d tensor)."""
        return self._step(self._batch(batch), self.optimizer.get_lr())

    def run_steps(self, n: int, *batch) -> torch.Tensor:
        """``n`` steps on the same batch at the learning rate read once
        at the start; returns the last step's loss."""
        if n <= 0:
            raise ValueError("run_steps needs n >= 1, got %d" % n)
        arrays = self._batch(batch)
        lr = self.optimizer.get_lr()
        for _ in range(n):
            loss = self._step(arrays, lr)
        return loss

    def sync_params_to_model(self) -> None:
        """Kept for the JAX API: the step updates the model's own
        parameters in place, so there is nothing to write back."""

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
