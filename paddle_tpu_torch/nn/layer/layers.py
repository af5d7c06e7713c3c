"""``nn.Layer``: the base class of the eager layers.

Port of ``paddle_tpu/nn/layer/layers.py``. A ``Layer`` is a
``torch.nn.Module``: its parameters are ``torch.nn.Parameter``s, its
buffers, sublayers, hooks, ``train`` / ``eval`` and ``to`` are
PyTorch's. On top it carries Paddle's names:

* ``create_parameter(shape, attr, dtype, is_bias, default_initializer)``
  on the default place (:func:`paddle_tpu_torch.device.set_device`),
  drawn by the JAX package's initializers (``nn/initializer.py``);
  ``attr=False`` means no parameter, an ``Initializer`` or an object
  with ``initializer`` / ``trainable`` (a ``ParamAttr``; a
  ``learning_rate`` other than 1 raises) overrides the default;
* ``parameters()`` as a list, ``named_parameters(prefix,
  include_sublayers)``, ``sublayers(include_self)``, ``add_sublayer``,
  ``register_buffer(name, tensor, persistable)``, ``clear_gradients()``;
* ``register_forward_pre_hook(hook)`` (``hook(layer, inputs)``, which
  may return new inputs) and ``register_forward_post_hook(hook)``
  (``hook(layer, inputs, outputs)``, which may return new outputs), each
  returning a remover with ``remove()``: PyTorch's forward hooks;
* ``state_dict()`` under the JAX package's key names (a Paddle
  ``BatchNorm``'s ``_mean`` / ``_variance``, a ``Linear``'s ``[in, out]``
  weight), and ``set_state_dict(state)`` taking tensors or numpy arrays,
  cast to each entry's type, returning ``(missing, unexpected)``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..initializer import Constant, Initializer, XavierNormal

__all__ = ["Layer", "Parameter"]

Parameter = torch.nn.Parameter


class Layer(torch.nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        from ...core.tensor import as_dtype

        self._dtype = as_dtype(dtype or "float32")

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        """A new parameter of ``shape`` on the default place."""
        from ...core.tensor import as_dtype

        init = default_initializer or (Constant(0.0) if is_bias
                                       else XavierNormal())
        trainable = True
        if isinstance(attr, Initializer):
            init = attr
        elif attr is not None and attr is not False:
            init = getattr(attr, "initializer", None) or init
            trainable = getattr(attr, "trainable", True)
            if getattr(attr, "learning_rate", 1.0) != 1.0:
                raise NotImplementedError(
                    "a parameter's own learning rate is not ported "
                    "(ROADMAP.md §1 item 9)")
        dt = as_dtype(dtype) if dtype is not None else self._dtype
        return Parameter(init(shape, dt, resolve_device(None)),
                         requires_grad=trainable)

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True, persistent=None):
        super().register_buffer(name, tensor, persistent=persistable
                                if persistent is None else persistent)

    def parameters(self, include_sublayers: bool = True, recurse=None
                   ) -> List[Parameter]:
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, recurse=None,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, Parameter]]:
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        """Every layer below this one, depth first (this one first with
        ``include_self``)."""
        mods = list(self.modules())
        return mods if include_self else mods[1:]

    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s entries (tensors or numpy arrays) into
        this layer's parameters and buffers of the same names, cast to
        their types; returns ``(missing, unexpected)`` names. A shape
        that differs raises."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    continue
                src = state_dict[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src, copy=True))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError("shape mismatch for %s: %s vs %s"
                                     % (name, tuple(src.shape),
                                        tuple(t.shape)))
                t.copy_(src)
        return missing, unexpected

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None
