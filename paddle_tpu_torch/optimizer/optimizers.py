"""AdamW, as a functional update over lists of tensors.

Port of the functional path of ``paddle_tpu/optimizer/optimizers.py``
(``Adam.init_state`` / ``_functional_update`` as ``AdamW.update`` runs
it, with the learning rate of the ``Optimizer`` base) that ``TrainStep``
drives. The state keeps the JAX package's layout, one list entry per
parameter in ``named_parameters`` order:

  {"m": [...], "v": [...], "t": 0-d f32}                         dense
  {"m": [...], "v": [...], "vr": [...], "vc": [...], "t": ...}   factored_v

``m`` is stored in ``moment_dtype`` (the first moment only: a bf16
second moment could not represent a beta2 = 0.999 decay step). With
``factored_v`` a parameter of ndim >= 2 keeps f32 row and column EMAs of
g^2 (``vr`` [rows], ``vc`` [prod of the other dims], ``v`` empty) and
reads its second moment as the rank-1 ``outer(vr, vc) / sum(vr)``
(Adafactor); a 1-D parameter keeps a full f32 ``v``. The update math is
f32; each parameter is written back in its own dtype. Weight decay is
decoupled (``p *= 1 - lr * weight_decay``) and applies to every
parameter, as in the JAX functional update.

Unlike the JAX version, which returns new arrays, :meth:`AdamW.update`
updates the parameters and the state IN PLACE (under ``no_grad``), so a
step holds one parameter's f32 temporaries at a time and never a second
copy of the model. 8-bit moments (``moment_quant="8bit"``) and learning
rate schedulers are later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

__all__ = ["AdamW"]

State = Dict[str, Union[List[torch.Tensor], torch.Tensor]]


class AdamW:
    """``AdamW(learning_rate=1e-4, weight_decay=0.01,
    moment_dtype="bfloat16", factored_v=True)``; :meth:`init_state`
    makes the state, :meth:`update` applies one step to it."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 moment_dtype: Union[str, torch.dtype] = "float32",
                 moment_quant: Optional[str] = None,
                 factored_v: bool = False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet: see "
                "ROADMAP.md")
        if moment_quant not in (None, "none"):
            raise NotImplementedError(
                "moment_quant=%r is not ported yet: see ROADMAP.md"
                % (moment_quant,))
        self._learning_rate = float(learning_rate)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._coeff = float(weight_decay)
        self._moment_dtype = moment_dtype if isinstance(
            moment_dtype, torch.dtype) else getattr(torch, moment_dtype)
        self._factored_v = bool(factored_v)

    def get_lr(self) -> float:
        return self._learning_rate

    def init_state(self, params: Sequence[torch.Tensor]) -> State:
        """Zero moments beside ``params`` (on their devices)."""
        md = self._moment_dtype
        state: State = {
            "m": [torch.zeros_like(p, dtype=md) for p in params],
            "v": [], "t": torch.zeros((), dtype=torch.float32,
                                      device=params[0].device)}
        if not self._factored_v:
            state["v"] = [torch.zeros_like(p, dtype=torch.float32)
                          for p in params]
            return state
        state["vr"], state["vc"] = [], []
        for p in params:
            f32 = {"dtype": torch.float32, "device": p.device}
            if p.dim() >= 2:
                state["v"].append(torch.zeros(0, **f32))
                state["vr"].append(torch.zeros(p.shape[0], **f32))
                state["vc"].append(torch.zeros(p[0].numel(), **f32))
            else:
                state["v"].append(torch.zeros_like(p, dtype=torch.float32))
                state["vr"].append(torch.zeros(0, **f32))
                state["vc"].append(torch.zeros(0, **f32))
        return state

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: State,
               lr: Optional[float] = None) -> None:
        """One step over every parameter, in place."""
        lr = self.get_lr() if lr is None else float(lr)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        state["t"] += 1
        bc1 = 1 - torch.pow(b1, state["t"])     # f32, on the state's device
        bc2 = 1 - torch.pow(b2, state["t"])
        for i, (p, g) in enumerate(zip(params, grads)):
            # .float() of an f32 tensor is the tensor itself: m and p are
            # then updated in place, which is what the copies below do too
            g32 = g.float()
            m = state["m"][i].float().mul_(b1).add_(g32, alpha=1 - b1)
            if self._factored_v and p.dim() >= 2:
                g2 = (g32 * g32).reshape(p.shape[0], -1) + 1e-30
                vr = state["vr"][i].mul_(b2).add_(g2.sum(1), alpha=1 - b2)
                vc = state["vc"][i].mul_(b2).add_(g2.sum(0), alpha=1 - b2)
                del g2
                denom = (torch.outer(vr, vc) / vr.sum().clamp_min(1e-30)
                         ).reshape(p.shape)
            else:
                denom = state["v"][i].mul_(b2).addcmul_(
                    g32, g32, value=1 - b2).clone()
            del g32
            denom.div_(bc2).sqrt_().add_(eps)
            p32 = p.float().mul_(1 - lr * self._coeff)
            p32.addcdiv_(m / bc1, denom, value=-lr)
            p.copy_(p32)
            state["m"][i].copy_(m)
