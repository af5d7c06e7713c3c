"""Grad mode and functional gradients of the eager surface.

Port of ``paddle_tpu/core/autograd.py`` (``no_grad``, ``enable_grad``,
``set_grad_enabled``, ``is_grad_enabled``, ``grad``, ``backward``): the
JAX package keeps its own tape; the port maps each name onto
``torch.autograd``, Paddle's argument names kept.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "grad", "backward"]

is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled


def no_grad(fn=None):
    """Context manager, or decorator of ``fn``, that records no graph."""
    return torch.no_grad()(fn) if fn is not None else torch.no_grad()


def enable_grad(fn=None):
    """Context manager, or decorator of ``fn``, that records the graph."""
    return torch.enable_grad()(fn) if fn is not None else \
        torch.enable_grad()


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``."""
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=True):
    """d(outputs)/d(inputs) as a list, leaving ``.grad`` alone; an input
    the outputs do not reach gives None (``allow_unused``, the JAX
    default) or raises."""
    single = isinstance(inputs, torch.Tensor)
    res = torch.autograd.grad(outputs, [inputs] if single else list(inputs),
                              grad_outputs, retain_graph=retain_graph or
                              create_graph, create_graph=create_graph,
                              allow_unused=allow_unused)
    return list(res)
