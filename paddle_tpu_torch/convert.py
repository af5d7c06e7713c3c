"""Weights and optimizer state from the JAX package into the port.

The port's GPT and Llama keep the JAX package's parameter names and
Paddle's ``[in, out]`` linear layout, and its optimizer keeps the JAX
state layout, so the conversion is a copy: this module is the one place
that knows the two trees line up. The TP ring primitives and the
compiled pipeline take plain arrays (``x`` and ``w``; the pipeline's
numpy leaves): :func:`params_from_paddle_tpu` or ``torch.from_numpy``
carries the JAX package's arrays over.

On a mesh (a model that ``TrainStep(..., mesh=...)`` sharded, each
parameter carrying its ``dist_layout``) :func:`shard_params` and
:func:`shard_opt_state` slice full arrays into this rank's pieces, and
:func:`gather_params` / :func:`gather_opt_state` gather every piece back
into full numpy arrays (collectives: every rank calls them). The
optimizer state's pieces follow their parameter's: ``m`` and a full
``v`` its layout, a factored ``vr`` the rows' and ``vc`` the columns'.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu", "opt_state_from_paddle_tpu",
           "shard_params", "gather_params", "shard_opt_state",
           "gather_opt_state", "state_layout"]


def _tensor(arr: Any) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` (any array numpy can read;
    bfloat16 arrays, which numpy only knows through an extension type,
    are carried over bit for bit)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_paddle_tpu(state: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX model's ``state_dict()`` as numpy arrays -> the port's
    ``state_dict`` (CPU tensors of the same dtypes; ``load_state_dict``
    moves and casts them onto the port's model)."""
    return {name: _tensor(arr) for name, arr in state.items()}


def opt_state_from_paddle_tpu(opt_state: Mapping[str, Any]
                              ) -> Dict[str, Any]:
    """The JAX ``TrainStep.opt_state`` (``{"m", "v", "vr", "vc", "t"}``,
    or with 8-bit moments ``{"m", "m_ax", "v", "v_ax", "t"}``; lists in
    ``named_parameters`` order, as numpy-readable arrays) -> the port's
    optimizer state, as CPU tensors of the same dtypes (a factored ``v``
    of a 3-D MoE expert weight ``[E, h, ffn]`` is ``vr [E]``, ``vc [h *
    ffn]`` in both; 8-bit codes are int8 ``m`` / uint8 ``v`` ``[nb,
    256]`` beside f32 absmax ``[nb, 1]`` in both).
    :meth:`paddle_tpu_torch.jit.TrainStep.restore_state` takes it."""
    return {key: [_tensor(e) for e in val]
            if isinstance(val, (list, tuple)) else _tensor(val)
            for key, val in opt_state.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 widened to float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _layouts(model) -> Dict[str, Any]:
    return {name: getattr(p, "dist_layout", None)
            for name, p in model.named_parameters()}


def shard_params(state: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Full arrays (the JAX model's ``state_dict`` as numpy) -> this
    rank's pieces for ``model``'s sharded parameters (CPU tensors, for
    ``load_state_dict``); names the model does not shard stay whole."""
    layouts = _layouts(model)
    return {name: layouts[name].local(_tensor(arr))
            if layouts.get(name) is not None else _tensor(arr)
            for name, arr in state.items()}


def gather_params(model) -> Dict[str, np.ndarray]:
    """Every parameter of a sharded ``model``, whole, as numpy arrays on
    every rank (a collective)."""
    return {name: _numpy(p.dist_layout.gather(p.detach())
                         if hasattr(p, "dist_layout") else p)
            for name, p in model.named_parameters()}


def state_layout(key: str, p: torch.Tensor, entry):
    """The layout of ``entry``, optimizer state ``key`` of sharded
    parameter ``p`` (None: whole on every rank)."""
    lay = getattr(p, "dist_layout", None)
    if lay is None:
        return None
    if key in ("m", "v"):
        return lay if tuple(entry.shape) == tuple(p.shape) else None
    if key in ("vr", "vc") and entry.numel():
        return lay.rows() if key == "vr" else lay.cols()
    return None


def shard_opt_state(opt_state: Mapping[str, Any], step) -> Dict[str, Any]:
    """Full optimizer state (the JAX ``TrainStep.opt_state`` as numpy
    arrays) -> this rank's pieces for a mesh ``step``, ready for
    :meth:`~paddle_tpu_torch.jit.TrainStep.restore_state`."""
    full = opt_state_from_paddle_tpu(opt_state)
    out = {}
    for key, val in full.items():
        if not isinstance(val, list):
            out[key] = val
            continue
        out[key] = []
        for p, cur, t in zip(step._params, step.opt_state[key], val):
            lay = state_layout(key, p, cur)
            out[key].append(t if lay is None else lay.local(t))
    return out


def gather_opt_state(step) -> Dict[str, Any]:
    """A mesh ``step``'s optimizer state, whole, as numpy arrays on every
    rank (a collective)."""
    out = {}
    for key, val in step.opt_state.items():
        if not isinstance(val, list):
            out[key] = _numpy(val)
            continue
        out[key] = []
        for p, e in zip(step._params, val):
            lay = state_layout(key, p, e)
            out[key].append(_numpy(e if lay is None else lay.gather(e)))
    return out
