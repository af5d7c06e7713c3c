"""AdamW, Adam, SGD and Momentum, as functional updates over lists of
tensors.

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
new tensors as the JAX version returns new arrays. :class:`Momentum`
(``velocity`` state, ``use_nesterov``) returns new tensors the same way.
:class:`Adam` is :class:`AdamW`'s update with the JAX ``Adam``'s coupled
L2 decay (``g + weight_decay * p``) in place of the decoupled one.

All four also carry the JAX eager surface that the fleet and dygraph
paths drive (``AdamW(..., parameters=model.parameters(),
grad_clip=clip)``,
``step()``, ``clear_grad()``), built on the same ``init_state`` /
``update``: ``step`` reads each parameter's gradient (:func:`grad_of`:
the f32 ``main_grad`` the fleet pipeline accumulates, else ``.grad``),
clips the pairs with ``grad_clip``, makes the state on the first step
and updates the parameters that have a gradient in place. ``_shards``
(None, or one ``(row_group, col_group)`` a parameter, which
``HybridParallelOptimizer`` sets for the model-parallel pieces) goes to
``AdamW.update`` as its ``shards``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .lr import LRScheduler

__all__ = ["Adam", "AdamW", "SGD", "Momentum", "grad_of"]

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


def grad_of(p: torch.Tensor) -> Optional[torch.Tensor]:
    """The gradient an eager step reads: ``p.main_grad`` (the f32
    accumulator of the fleet pipeline) when set, else ``p.grad``."""
    g = getattr(p, "main_grad", None)
    return g if g is not None else p.grad


class _Eager:
    """The eager ``step`` / ``clear_grad`` over ``parameters``."""

    def _init_eager(self, parameters, grad_clip) -> None:
        self._parameter_list = None if parameters is None else \
            list(parameters)
        self._grad_clip = grad_clip
        self._state: Optional[State] = None
        self._shards = None

    def step(self) -> None:
        """One update of the parameters that have a gradient."""
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer constructed without parameters")
        idx = [i for i, p in enumerate(params)
               if p.requires_grad and grad_of(p) is not None]
        pairs = [(params[i], grad_of(params[i])) for i in idx]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        if self._state is None:
            self._state = self.init_state(params)
        self._apply(idx, [g for _, g in pairs])

    def clear_grad(self, set_to_zero: bool = False) -> None:
        clear_grads(self._parameter_list or (), set_to_zero)


def clear_grads(params, set_to_zero: bool = False) -> None:
    """Drop (or zero) each parameter's ``.grad`` and ``main_grad``."""
    for p in params:
        for key in ("grad", "main_grad"):
            g = getattr(p, key, None)
            if g is None:
                continue
            if set_to_zero:
                g.zero_()
            else:
                setattr(p, key, None)


class AdamW(_LearningRate, _Eager):
    """``AdamW(learning_rate=1e-4, weight_decay=0.01,
    moment_dtype="bfloat16", factored_v=True)``; :meth:`init_state`
    makes the state, :meth:`update` applies one step to it.
    ``learning_rate`` may be an :class:`LRScheduler`."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 moment_dtype: Union[str, torch.dtype] = "float32",
                 moment_quant: Optional[str] = None,
                 factored_v: bool = False, parameters=None,
                 grad_clip=None):
        super().__init__(learning_rate)
        self._init_eager(parameters, grad_clip)
        if moment_quant not in (None, "none", "8bit"):
            raise ValueError(f"moment_quant: unknown mode {moment_quant!r}")
        self._moment_quant = moment_quant if moment_quant != "none" \
            else None
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._coeff = float(weight_decay)
        self._l2 = 0.0      # Adam's coupled decay, added to the gradient
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
                self._update_q8(i, p, self._grad32(p, g), state, lr, bc1,
                                bc2)
            return
        for i, (p, g) in enumerate(zip(params, grads)):
            # .float() of an f32 tensor is the tensor itself: m and p are
            # then updated in place, which is what the copies below do too
            g32 = self._grad32(p, g)
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

    def _grad32(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The f32 gradient the update takes (Adam: plus ``wd * p``)."""
        return g.float() + self._l2 * p.float() if self._l2 else g.float()

    def _apply(self, idx, grads) -> None:
        """The eager step's update of parameters ``idx`` (indices into
        the parameter list) on a view of the state (the entries are
        updated in place)."""
        params = self._parameter_list
        state = {k: v if not isinstance(v, list) else [v[i] for i in idx]
                 for k, v in self._state.items()}
        shards = None if self._shards is None else [self._shards[i]
                                                    for i in idx]
        self.update([params[i] for i in idx], grads, state, shards=shards)

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


class Adam(AdamW):
    """Adam (port of ``Adam`` of ``paddle_tpu/optimizer/optimizers.py``):
    :class:`AdamW`'s update with the JAX ``Adam``'s weight decay, the
    coupled L2 (``_decayed``: ``g + weight_decay * p`` enters the
    moments), where AdamW's is decoupled (``p *= 1 - lr *
    weight_decay``). ``weight_decay`` is a float or an ``L2Decay``-like
    object with a ``coeff``."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 moment_dtype: Union[str, torch.dtype] = "float32",
                 moment_quant: Optional[str] = None,
                 factored_v: bool = False):
        super().__init__(learning_rate, beta1, beta2, epsilon, 0.0,
                         moment_dtype, moment_quant, factored_v, parameters,
                         grad_clip)
        self._l2 = _coeff(weight_decay)


def _coeff(weight_decay) -> float:
    """A weight decay given as a number, None or an object with a
    ``coeff`` (``L2Decay``)."""
    if weight_decay is None or isinstance(weight_decay, (int, float)):
        return float(weight_decay or 0.0)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


class SGD(_LearningRate, _Eager):
    """``SGD(learning_rate=0.001, weight_decay=None)``: plain gradient
    descent with L2 weight decay folded into the gradient;
    ``learning_rate`` may be an :class:`LRScheduler`."""

    def __init__(self, learning_rate=0.001,
                 weight_decay: Optional[float] = None, parameters=None,
                 grad_clip=None):
        super().__init__(learning_rate)
        self._init_eager(parameters, grad_clip)
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

    @torch.no_grad()
    def _apply(self, idx, grads) -> None:
        params = [self._parameter_list[i] for i in idx]
        new, _ = self.update(params, grads, {})
        for p, n in zip(params, new):
            p.copy_(n)


class Momentum(_LearningRate, _Eager):
    """``Momentum(learning_rate=0.001, momentum=0.9, use_nesterov=False,
    weight_decay=None)`` (port of ``Momentum`` of
    ``paddle_tpu/optimizer/optimizers.py``): with ``g' = g + wd * p``,
    ``v = momentum * v + g'`` and ``p -= lr * v``, or ``p -= lr * (g' +
    momentum * v)`` with ``use_nesterov``. State ``{"velocity": [...]}``
    beside the parameters. :meth:`update` is the JAX functional update
    (new tensors back, as :class:`SGD`'s); the eager ``step`` copies
    them into the parameters."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate)
        self._init_eager(parameters, grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        self._weight_decay = _coeff(weight_decay)

    def init_state(self, params: Sequence[torch.Tensor]) -> State:
        return {"velocity": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: State,
               lr: Optional[float] = None):
        """``(new_params, new_state)`` after one step."""
        lr = self.get_lr() if lr is None else lr
        wd, mu = self._weight_decay, self._momentum
        new_p, new_v = [], []
        for p, g, v in zip(params, grads, state["velocity"]):
            if wd:
                g = g + wd * p
            v = mu * v + g
            new_v.append(v)
            new_p.append(p - lr * (g + mu * v if self._use_nesterov else v))
        return new_p, {"velocity": new_v}

    @torch.no_grad()
    def _apply(self, idx, grads) -> None:
        params = [self._parameter_list[i] for i in idx]
        vel = self._state["velocity"]
        new, st = self.update(params, grads,
                              {"velocity": [vel[i] for i in idx]})
        for p, n in zip(params, new):
            p.copy_(n)
        for i, v in zip(idx, st["velocity"]):
            vel[i] = v
