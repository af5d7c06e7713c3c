"""AdamW and SGD, as functional updates over lists of tensors.

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

On a mesh each rank updates its shards, and the factored statistics
stay those of the whole matrix: ``update(..., shards=...)`` names, for
each parameter, the groups over which its rows (dim 0) and its columns
(the other dims) are split. The row sums are all-reduced over the column
group, the column sums and the total over the row group, so ``denom``
is the JAX one at this rank's entries.

Unlike the JAX version, which returns new arrays, :meth:`AdamW.update`
updates the parameters and the state IN PLACE (under ``no_grad``), so a
step holds one parameter's f32 temporaries at a time and never a second
copy of the model.

``moment_quant="8bit"`` keeps both moments blockwise-quantized (the JAX
``_q8_quantize``: 256-element blocks, an f32 absmax each, 4th-root
companding, int8 ``m`` and uint8 ``v``), in the layout

  {"m": [...], "m_ax": [...], "v": [...], "v_ax": [...], "t": ...}

(codes ``[nb, 256]``, absmax ``[nb, 1]``). A step decodes one
parameter's moments to f32, updates them and the parameter, and encodes
them again with stochastic rounding. The JAX package draws that noise
from ``fold_in(fold_in(PRNGKey(0x51ab), t), i)``; the port draws it from
a ``torch.Generator`` the optimizer owns (one a device, seeded with the
same number), through the one method :meth:`AdamW._q8_noise`.

``learning_rate`` may be an :class:`~.lr.LRScheduler`: ``get_lr()`` reads
it, ``set_lr`` then raises, as in the JAX ``Optimizer``.

:class:`SGD` is the JAX ``SGD.init_state`` / ``update`` that the compiled
pipeline drives: no state, ``p - lr * (g + weight_decay * p)``, returning
new tensors as the JAX version returns new arrays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .lr import LRScheduler

__all__ = ["AdamW", "SGD"]

State = Dict[str, Union[List[torch.Tensor], torch.Tensor]]

_QBLOCK = 256  # blockwise-quantization block size (8-bit moments)
_Q8_SEED = 0x51ab  # the 8-bit rounding noise's seed (the JAX key's)


def _q8_quantize(x: torch.Tensor, signed: bool,
                 noise: Optional[torch.Tensor] = None):
    """``(codes, absmax)`` of ``x`` (the JAX ``_q8_quantize``): ``x``
    flattened into f32 blocks of 256 (the last zero-padded), each block's
    absmax ``[nb, 1]``, and codes ``round(scale * |x / absmax| ** 0.25)``
    with the sign (scale 127, int8) or without (255, uint8) ``[nb,
    256]``. With ``noise`` (uniform [0, 1) of the codes' shape) the
    rounding is stochastic, ``floor(mag + noise)`` clipped to the scale:
    a beta2 = 0.999 decay step is smaller than one code step, so
    round-to-nearest would ratchet the second moment upward."""
    n = x.numel()
    nb = -(-n // _QBLOCK)
    xp = torch.zeros(nb * _QBLOCK, dtype=torch.float32, device=x.device)
    xp[:n] = x.reshape(-1)
    xp = xp.reshape(nb, _QBLOCK)
    ax = xp.abs().amax(dim=1, keepdim=True)
    u = xp / ax.clamp_min(1e-30)
    scale = 127.0 if signed else 255.0
    mag = u.abs().sqrt_().sqrt_().mul_(scale)
    if noise is not None:
        qmag = mag.add_(noise).floor_().clamp_(0.0, scale)
    else:
        qmag = mag.round_()
    if signed:
        return (u.sign_() * qmag).to(torch.int8), ax
    return qmag.to(torch.uint8), ax


_Q8_SCALES: Dict[tuple, torch.Tensor] = {}


def _q8_dequantize(q: torch.Tensor, ax: torch.Tensor, shape,
                   signed: bool) -> torch.Tensor:
    """f32 ``x`` of ``shape`` from ``(codes, absmax)``: sign(u) |u|^4
    absmax, u = code / scale (|u|^4 as (u u)(u u), JAX's integer
    power). The scale is a 0-d tensor on the codes' device, made once:
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, one rounding away from the division the CPU and the JAX
    package do."""
    key = (q.device, signed)
    if key not in _Q8_SCALES:
        _Q8_SCALES[key] = torch.tensor(127.0 if signed else 255.0,
                                       device=q.device)
    u = q.float() / _Q8_SCALES[key]
    a = u.abs()
    a = a * a
    a = a * a
    n = math.prod(shape)
    return (u.sign_().mul_(a).mul_(ax)).reshape(-1)[:n].reshape(shape)


class _LearningRate:
    """The learning rate of the JAX ``Optimizer`` base: a float or an
    :class:`LRScheduler`."""

    def __init__(self, learning_rate):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a number or an "
                            "LRScheduler, got %r" % (learning_rate,))
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the lr is an LRScheduler; call "
                "scheduler.step() instead")
        self._learning_rate = float(value)


class AdamW(_LearningRate):
    """``AdamW(learning_rate=1e-4, weight_decay=0.01,
    moment_dtype="bfloat16", factored_v=True)``; :meth:`init_state`
    makes the state, :meth:`update` applies one step to it.
    ``learning_rate`` may be an :class:`LRScheduler`."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 moment_dtype: Union[str, torch.dtype] = "float32",
                 moment_quant: Optional[str] = None,
                 factored_v: bool = False):
        super().__init__(learning_rate)
        if moment_quant not in (None, "none", "8bit"):
            raise ValueError(f"moment_quant: unknown mode {moment_quant!r}")
        self._moment_quant = moment_quant if moment_quant != "none" \
            else None
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._coeff = float(weight_decay)
        self._moment_dtype = moment_dtype if isinstance(
            moment_dtype, torch.dtype) else getattr(torch, moment_dtype)
        self._factored_v = bool(factored_v)
        if self._factored_v and self._moment_quant:
            raise ValueError("factored_v and moment_quant are exclusive")
        # the 8-bit codes' rounding noise: one generator a device, each
        # seeded with _Q8_SEED when init_state first meets the device
        self._q8_gens: Dict[torch.device, torch.Generator] = {}

    def _q8_noise(self, shape, step: torch.Tensor, index: int,
                  signed: bool, device: torch.device) -> torch.Tensor:
        """Uniform [0, 1) f32 noise of ``shape`` for the stochastic
        rounding of parameter ``index``'s ``m`` (``signed``) or ``v`` at
        step ``step`` (a 0-d tensor, the step being taken). Every draw of
        the 8-bit path goes through here, from the optimizer's own
        generator on ``device``."""
        return torch.rand(shape, generator=self._q8_gens[device],
                          device=device, dtype=torch.float32)

    def init_state(self, params: Sequence[torch.Tensor]) -> State:
        """Zero moments beside ``params`` (on their devices)."""
        md = self._moment_dtype
        if self._moment_quant == "8bit":
            state: State = {"m": [], "m_ax": [], "v": [], "v_ax": [],
                            "t": torch.zeros((), dtype=torch.float32,
                                             device=params[0].device)}
            for p in params:
                if p.device not in self._q8_gens:
                    self._q8_gens[p.device] = torch.Generator(
                        device=p.device).manual_seed(_Q8_SEED)
                zero = torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                for key, signed in (("m", True), ("v", False)):
                    q, ax = _q8_quantize(zero, signed)
                    state[key].append(q)
                    state[key + "_ax"].append(ax)
            return state
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
               lr: Optional[float] = None, shards=None) -> None:
        """One step over every parameter, in place. ``shards`` (a mesh):
        one ``(row_group, col_group)`` a parameter, either None where
        that side is whole (see the module note)."""
        lr = self.get_lr() if lr is None else float(lr)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        state["t"] += 1
        bc1 = 1 - torch.pow(b1, state["t"])     # f32, on the state's device
        bc2 = 1 - torch.pow(b2, state["t"])
        if self._moment_quant == "8bit":
            for i, (p, g) in enumerate(zip(params, grads)):
                self._update_q8(i, p, g.float(), state, lr, bc1, bc2)
            return
        for i, (p, g) in enumerate(zip(params, grads)):
            # .float() of an f32 tensor is the tensor itself: m and p are
            # then updated in place, which is what the copies below do too
            g32 = g.float()
            m = state["m"][i].float().mul_(b1).add_(g32, alpha=1 - b1)
            if self._factored_v and p.dim() >= 2:
                rows, cols = shards[i] if shards is not None else (None,
                                                                    None)
                g2 = (g32 * g32).reshape(p.shape[0], -1) + 1e-30
                rs, cs = g2.sum(1), g2.sum(0)
                del g2
                if cols is not None:
                    dist.all_reduce(rs, group=cols)
                if rows is not None:
                    dist.all_reduce(cs, group=rows)
                vr = state["vr"][i].mul_(b2).add_(rs, alpha=1 - b2)
                vc = state["vc"][i].mul_(b2).add_(cs, alpha=1 - b2)
                total = vr.sum()
                if rows is not None:
                    dist.all_reduce(total, group=rows)
                denom = (torch.outer(vr, vc) / total.clamp_min(1e-30)
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

    def _update_q8(self, i: int, p: torch.Tensor, g32: torch.Tensor,
                   state: State, lr: float, bc1: torch.Tensor,
                   bc2: torch.Tensor) -> None:
        """Parameter ``i``'s step with 8-bit moments: decode, the f32
        update, encode with the step's noise, all in place."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _q8_dequantize(state["m"][i], state["m_ax"][i], p.shape,
                           signed=True).mul_(b1).add_(g32, alpha=1 - b1)
        v = _q8_dequantize(state["v"][i], state["v_ax"][i], p.shape,
                           signed=False).mul_(b2).addcmul_(g32, g32,
                                                           value=1 - b2)
        denom = (v / bc2).sqrt_().add_(eps)
        p32 = p.float().mul_(1 - lr * self._coeff)
        p32.addcdiv_(m / bc1, denom, value=-lr)
        p.copy_(p32)
        del p32, denom
        for key, x, signed in (("m", m, True), ("v", v, False)):
            q = state[key][i]
            q_new, ax = _q8_quantize(x, signed, noise=self._q8_noise(
                q.shape, state["t"], i, signed, q.device))
            q.copy_(q_new)
            state[key + "_ax"][i].copy_(ax)


class SGD(_LearningRate):
    """``SGD(learning_rate=0.001, weight_decay=None)``: plain gradient
    descent with L2 weight decay folded into the gradient;
    ``learning_rate`` may be an :class:`LRScheduler`."""

    def __init__(self, learning_rate=0.001,
                 weight_decay: Optional[float] = None):
        super().__init__(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)

    def init_state(self, params: Sequence[torch.Tensor]) -> State:
        return {}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: State,
               lr: Optional[float] = None):
        """``(new_params, state)``: each ``p - lr * (g + wd * p)``."""
        lr = self.get_lr() if lr is None else lr
        wd = self._weight_decay
        return [p - lr * (g + wd * p) for p, g in zip(params, grads)], state
