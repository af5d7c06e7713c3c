"""Row norms over the last axis, and the fused RMSNorm entry.

Port of the norm half of ``paddle_tpu/incubate/nn/functional/
fused_ops.py``. :func:`rms_norm` and :func:`layer_norm` are the port's
one dispatching layer for the norms: a CUDA tensor goes through the
Hopper kernel (:mod:`..cuda.norms`, the counterpart of the TPU kernel
K7) and a CPU tensor through its plain version. Either way the gradient
is autograd through the plain composition, as the JAX package's
``_rms_bwd`` and ``_ln_bwd`` are the vjp of ``_rms_ref`` and ``_ln_ref``.
The JAX package's TPU gate (``_pallas_norm_ok``) is not carried over:
every CUDA tensor the kernel takes goes to it.
"""
from __future__ import annotations

import torch

from ..cuda import norms as _k

__all__ = ["rms_norm", "layer_norm", "fused_rms_norm"]


def _forward(kind, x, w, b, eps):
    if x.device.type == "cuda":
        kernel = _k.rms_norm if kind == "rms" else _k.layer_norm
        return kernel(x, w, b, eps)
    if x.device.type != "cpu":
        raise ValueError("norms run on cuda or cpu, not %s" % x.device)
    ref = _k.rms_norm_ref if kind == "rms" else _k.layer_norm_ref
    return ref(x, w, b, eps)


class _RowNorm(torch.autograd.Function):
    """Forward on the kernel (or the plain version on the CPU); backward
    is the vjp of the plain composition, recomputed from x, w, b (b may
    be None: RMSNorm without a bias)."""

    @staticmethod
    def forward(ctx, kind, eps, x, w, b):
        ctx.kind, ctx.eps = kind, eps
        ctx.save_for_backward(x, w, b)
        return _forward(kind, x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        ref = _k.rms_norm_ref if ctx.kind == "rms" else _k.layer_norm_ref
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors,
                                      ctx.needs_input_grad[2:])]
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(ref(*leaves, ctx.eps), wanted,
                                             g))
        return (None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in leaves)


def _norm(kind, x, w, b, eps):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _RowNorm.apply(kind, eps, x, w, b)
    return _forward(kind, x, w, b, eps)


def rms_norm(x, weight, bias=None, eps=1e-6):
    """RMSNorm over the last axis of ``x [..., d]`` (the JAX package's
    ``pallas/norms.rms_norm``): f32 statistics, output in x's type."""
    return _norm("rms", x, weight, bias, float(eps))


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis of ``x [..., d]`` (the JAX
    package's ``pallas/norms.layer_norm``)."""
    return _norm("ln", x, weight, bias, float(eps))


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, name=None):
    """The JAX package's ``fused_rms_norm``: ``bias`` is added to x
    first, then ``residual``; the sum is normalised over the axes from
    ``begin_norm_axis`` on, scaled by ``norm_weight`` and shifted by
    ``norm_bias``. Returns ``(out, x + bias + residual)`` when a
    residual is given, else ``out``. ``quant_scale`` and ``name`` are
    accepted and unused, as in the JAX package."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    ax = begin_norm_axis % x.dim()
    shape = x.shape
    flat = x.reshape(shape[:ax] + (-1,))
    d = flat.shape[-1]
    w = torch.ones(d, dtype=x.dtype, device=x.device) \
        if norm_weight is None else norm_weight.reshape(d)
    nb = None if norm_bias is None else norm_bias.reshape(d)
    out = rms_norm(flat, w, nb, epsilon).reshape(shape)
    if residual is not None:
        return out, x
    return out
