"""Weights and optimizer state from the JAX package into the port.

The port's GPT and Llama keep the JAX package's parameter names and
Paddle's ``[in, out]`` linear layout, and its optimizer keeps the JAX
state layout, so the conversion is a copy: this module is the one place
that knows the two trees line up. The TP ring primitives and the
compiled pipeline take plain arrays (``x`` and ``w``; the pipeline's
numpy leaves): :func:`params_from_paddle_tpu` or ``torch.from_numpy``
carries the JAX package's arrays over.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu", "opt_state_from_paddle_tpu"]


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
    lists in ``named_parameters`` order, as numpy-readable arrays) ->
    the port's optimizer state, as CPU tensors of the same dtypes (a
    factored ``v`` of a 3-D MoE expert weight ``[E, h, ffn]`` is ``vr
    [E]``, ``vc [h * ffn]`` in both).
    :meth:`paddle_tpu_torch.jit.TrainStep.restore_state` takes it."""
    return {key: [_tensor(e) for e in val]
            if isinstance(val, (list, tuple)) else _tensor(val)
            for key, val in opt_state.items()}
