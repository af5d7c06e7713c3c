"""Custom-op extension point.

Port of ``paddle_tpu/utils/custom_op.py``: a custom op is a function of
tensors (PyTorch code, or a wrapper that launches a hand-written CUDA
kernel) registered once by name and mounted on
``paddle_tpu_torch.ops``, on the package's top level and, when asked, as
a ``torch.Tensor`` method. :func:`deregister_op` unmounts it and puts
back whatever the registration shadowed.

Gradients: with ``backward(res, cot)`` the op is a
``torch.autograd.Function`` whose backward calls it with ``res =
(inputs, outputs)`` (the JAX ``jax.custom_vjp``); without one, autograd
differentiates ``fn``'s own PyTorch ops (the JAX ``jax.vjp``). A kernel
launched through ``ctypes`` is invisible to autograd: when an input
records its gradient and ``fn``'s outputs do not reach it, the op
raises and names ``backward=``, rather than hand back a tensor that
silently stops the gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["register_op", "deregister_op", "registered_ops"]

_registry = {}
_shadowed = {}  # name -> what the registration touched, for the restore


def registered_ops():
    """Names of the custom ops registered now."""
    return set(_registry)


def _hosts():
    import paddle_tpu_torch as _pt

    from .. import ops as _ops

    return _pt, _ops


def deregister_op(name: str) -> None:
    """Remove a custom op registered with :func:`register_op`: unmount it
    from ``paddle_tpu_torch``, ``paddle_tpu_torch.ops`` and
    ``torch.Tensor``, restoring any attribute the registration
    shadowed."""
    if name not in _registry:
        raise KeyError(f"custom op '{name}' is not registered")
    shadowed = _shadowed.pop(name, {})
    del _registry[name]
    _pt, _ops = _hosts()
    for key, host in (("pt", _pt), ("ops", _ops)):
        if key in shadowed:
            setattr(host, name, shadowed[key])
        elif name in vars(host):
            delattr(host, name)
    if shadowed.get("appended_all") and name in _ops.__all__:
        _ops.__all__.remove(name)
    if shadowed.get("set_tensor_method"):
        if "tensor" in shadowed:
            setattr(torch.Tensor, name, shadowed["tensor"])
        elif name in vars(torch.Tensor):
            delattr(torch.Tensor, name)


def _reaches(outputs, inputs) -> bool:
    """Whether the graph of ``outputs`` reaches every tensor of
    ``inputs`` (leaves through their ``AccumulateGrad`` node, the others
    through their ``grad_fn``). Stops as soon as all are found."""
    want = {}
    for t in inputs:
        want[t.grad_fn if t.grad_fn is not None else id(t)] = t
    todo = [o.grad_fn for o in outputs if o.grad_fn is not None]
    seen = set()
    while todo and want:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        want.pop(node, None)
        var = getattr(node, "variable", None)
        if var is not None:
            want.pop(id(var), None)
        todo.extend(n for n, _ in node.next_functions)
    return not want


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def register_op(name: str, fn: Optional[Callable] = None, *,
                backward: Optional[Callable] = None,
                num_outputs: int = 1,
                tensor_method: bool = False):
    """Register ``fn(*inputs, **attrs) -> tensor(s)`` as
    ``paddle_tpu_torch.ops.<name>`` (and ``paddle_tpu_torch.<name>``).

    - ``fn`` takes tensors (numpy inputs are moved to the default place
      first) and any non-tensor arguments, passed through in their
      positions, and ``**attrs``.
    - ``backward(res, cot) -> input grads``, optional: ``res = (inputs,
      outputs)``, ``cot`` the outputs' cotangent (a tuple for several);
      one gradient a positional input (None for a non-tensor), or one a
      tensor input.
    - ``tensor_method=True`` also mounts it as ``torch.Tensor.<name>``.

    Usable as a decorator: ``@register_op("fancy_relu")``.
    """
    if fn is None:
        return lambda f: register_op(name, f, backward=backward,
                                     num_outputs=num_outputs,
                                     tensor_method=tensor_method)
    if name in _registry:
        raise ValueError(f"custom op '{name}' is already registered")
    from ..core.tensor import to_tensor

    def call(full, attrs):
        out = fn(*full, **attrs)
        if backward is not None or not torch.is_grad_enabled():
            return out
        need = [t for t in full if isinstance(t, torch.Tensor)
                and t.requires_grad]
        outs = [o for o in _as_tuple(out) if isinstance(o, torch.Tensor)]
        if need and not _reaches(outs, need):
            raise RuntimeError(
                f"custom op '{name}': an input records its gradient but "
                "the op's outputs do not reach it (a kernel launched "
                "outside autograd?); register the op with backward=... "
                "or call it under no_grad()")
        return out

    class _WithBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, attrs, *full):
            out = fn(*full, **attrs)
            outs = _as_tuple(out)
            # the tensors through save_for_backward (no cycle through
            # the outputs' grad_fn), the other arguments as they are
            ctx.others = [None if isinstance(t, torch.Tensor) else t
                          for t in full]
            ctx.multi = isinstance(out, (list, tuple))
            ctx.save_for_backward(*[t for t in full
                                    if isinstance(t, torch.Tensor)], *outs)
            return out

        @staticmethod
        def backward(ctx, *cot):
            saved = iter(ctx.saved_tensors)
            full = tuple(next(saved) if t is None else t
                         for t in ctx.others)
            outs = tuple(saved)
            out = outs if ctx.multi else outs[0]
            grads = _as_tuple(backward((full, out),
                                       cot if ctx.multi else cot[0]))
            if len(grads) != len(full):     # one a tensor input
                it = iter(grads)
                grads = [next(it) if isinstance(t, torch.Tensor) else None
                         for t in full]
            return (None,) + tuple(grads)

    def op(*inputs, **attrs):
        full = [to_tensor(t) if isinstance(t, np.ndarray) else t
                for t in inputs]
        if backward is not None:
            return _WithBackward.apply(attrs, *full)
        return call(full, attrs)

    op.__name__ = name
    op.__doc__ = fn.__doc__ or f"custom op '{name}'"
    _registry[name] = op

    _pt, _ops = _hosts()
    # remember exactly what is touched so deregister_op can undo it: any
    # shadowed attributes, whether the name was appended to ops.__all__,
    # and whether a Tensor method was mounted at all
    shadowed = {"set_tensor_method": tensor_method,
                "appended_all": name not in _ops.__all__}
    if hasattr(_ops, name):
        shadowed["ops"] = getattr(_ops, name)
    if hasattr(_pt, name):
        shadowed["pt"] = getattr(_pt, name)
    setattr(_ops, name, op)
    if shadowed["appended_all"]:
        _ops.__all__.append(name)
    setattr(_pt, name, op)
    if tensor_method:
        if name in vars(torch.Tensor):
            shadowed["tensor"] = vars(torch.Tensor)[name]

        def method(self, *a, **kw):
            return op(self, *a, **kw)

        method.__name__ = name
        setattr(torch.Tensor, name, method)
    _shadowed[name] = shadowed
    return op
