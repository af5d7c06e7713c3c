"""Row norms over the last axis, the fused RMSNorm / LayerNorm entries,
and rotary position embedding.

Port of the norm half and of ``fused_rotary_position_embedding`` of
``paddle_tpu/incubate/nn/functional/fused_ops.py``. :func:`rms_norm` and :func:`layer_norm` are the port's
one dispatching layer for the norms: a CUDA tensor goes through the
Hopper kernel (:mod:`..cuda.norms`, the counterpart of the TPU kernel
K7) and a CPU tensor through its plain version. :func:`fused_rms_norm`
and :func:`fused_layer_norm` add ``bias`` and then ``residual`` to x
and normalise the sum, in one launch of the same kernel on the card.
Either way the gradient is autograd through the plain composition (the
adds, then the norm), as the JAX package's ``_rms_bwd`` and ``_ln_bwd``
are the vjp of ``_rms_ref`` and ``_ln_ref``. The JAX package's TPU gate
(``_pallas_norm_ok``) is not carried over: every CUDA tensor the kernel
takes goes to it. :func:`fused_rotary_position_embedding` is plain,
differentiable PyTorch (the training path's RoPE; the serving steps
rotate with ``models/generation.py`` ``_rope``).
"""
from __future__ import annotations

import torch

from ..cuda import norms as _k

__all__ = ["rms_norm", "layer_norm", "fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding"]


def _forward(kind, x, w, b, eps, bias=None, residual=None):
    if x.is_cuda:
        kernel = _k.rms_norm if kind == "rms" else _k.layer_norm
        return kernel(x, w, b, eps, bias=bias, residual=residual)
    if x.device.type != "cpu":
        raise ValueError("norms run on cuda or cpu, not %s" % x.device)
    ref = _k.rms_norm_ref if kind == "rms" else _k.layer_norm_ref
    return ref(x, w, b, eps, bias=bias, residual=residual)


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


def _norm(kind, x, w, b, eps, bias=None, residual=None):
    """The norm of ``(x + bias) + residual`` (``(out, sum)`` with a
    residual): one kernel launch on the card, unless a gradient is
    wanted, when the adds are autograd's and the norm is
    :class:`_RowNorm`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, b, bias, residual)):
        s = _k._added(x, bias, residual)
        out = _RowNorm.apply(kind, eps, s, w, b)
        return out if residual is None else (out, s)
    return _forward(kind, x, w, b, eps, bias, residual)


def rms_norm(x, weight, bias=None, eps=1e-6):
    """RMSNorm over the last axis of ``x [..., d]`` (the JAX package's
    ``pallas/norms.rms_norm``): f32 statistics, output in x's type."""
    return _norm("rms", x, weight, bias, float(eps))


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis of ``x [..., d]`` (the JAX
    package's ``pallas/norms.layer_norm``)."""
    return _norm("ln", x, weight, bias, float(eps))


def _fused(kind, x, w, nb, eps, ax, bias, residual):
    """The norm over x's axes from ``ax`` on of ``(x + bias) +
    residual``; ``(out, sum)`` with a residual, else ``out``. One kernel
    launch when ``bias`` has the normalised axes' shape and ``residual``
    x's; another bias or residual is added first (PyTorch's broadcast),
    and the sum then normalised in the launch."""
    eps = float(eps)
    tail = x.shape[ax:]
    if bias is not None and bias.shape != tail:
        x, bias = x + bias, None
    if residual is not None and residual.shape != x.shape:
        s = x + residual
        return _fused(kind, s, w, nb, eps, ax, None, None), s
    if ax == x.dim() - 1 and w is not None and w.dim() == 1 and (
            nb.dim() == 1 if nb is not None else kind == "rms"):
        return _norm(kind, x, w, nb, eps, bias, residual)
    shape, d = x.shape, tail.numel()
    w = torch.ones(d, dtype=x.dtype, device=x.device) if w is None \
        else w.reshape(d)
    if nb is not None:
        nb = nb.reshape(d)
    elif kind == "ln":
        nb = torch.zeros(d, dtype=x.dtype, device=x.device)
    got = _norm(kind, x.reshape(-1, d), w, nb, eps,
                None if bias is None else bias.reshape(d),
                None if residual is None else residual.reshape(-1, d))
    if residual is None:
        return got.reshape(shape)
    return got[0].reshape(shape), got[1].reshape(shape)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, name=None):
    """The JAX package's ``fused_rms_norm``: ``bias`` is added to x
    first, then ``residual``; the sum is normalised over the axes from
    ``begin_norm_axis`` on, scaled by ``norm_weight`` and shifted by
    ``norm_bias``. Returns ``(out, x + bias + residual)`` when a
    residual is given, else ``out``; on the card, one K7 launch.
    ``quant_scale`` and ``name`` are accepted and unused, as in the JAX
    package."""
    return _fused("rms", x, norm_weight, norm_bias, epsilon,
                  begin_norm_axis % x.dim(), bias, residual)


def fused_layer_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     quant_scale=-1, name=None):
    """The JAX package's ``fused_layer_norm``: as :func:`fused_rms_norm`
    with LayerNorm, over the axes from ``begin_norm_axis`` on when it is
    not negative and over the last axis otherwise (as the JAX function
    reads it). A missing weight scales by 1, a missing norm bias shifts
    by 0."""
    ax = begin_norm_axis if begin_norm_axis >= 0 else x.dim() - 1
    return _fused("ln", x, norm_weight, norm_bias, epsilon, ax, bias,
                  residual)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate_pairwise(x):
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(
        x.shape)


def _rope_tables(seq_len, head_dim, base, position_ids, neox, device):
    """cos and sin of the f32 angles, ``[1 or b, s, 1, head_dim]``."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
        freqs = torch.outer(t, inv)[None]                 # [1, s, hd/2]
    else:
        # straight from the (possibly offset) positions: no table
        freqs = position_ids.to(device, torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1) if neox \
        else freqs.repeat_interleave(2, dim=-1)
    return torch.cos(emb)[:, :, None, :], torch.sin(emb)[:, :, None, :]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0, name=None):
    """RoPE over ``[batch, seq, heads, head_dim]`` tensors (the JAX
    package's ``fused_rotary_position_embedding``): each of q, k, v that
    is given is rotated in f32 and rounded back to its own type; returns
    the three (None where not given). The angles are ``position *
    base^(-2i / head_dim)`` in f32, positions ``0..s-1`` or
    ``position_ids [b, s]``. ``use_neox_rotary_style`` rotates the two
    halves of head_dim, else each (even, odd) pair. ``time_major`` and
    ``name`` are accepted and unused, as in the JAX package; precomputed
    ``sin`` / ``cos`` tables are not ported."""
    if sin is not None or cos is not None:
        raise NotImplementedError(
            "fused_rotary_position_embedding with sin / cos tables is not "
            "ported yet: see ROADMAP.md")
    first = next(t for t in (q, k, v) if t is not None)
    cos_t, sin_t = _rope_tables(first.shape[1], first.shape[-1],
                                rotary_emb_base, position_ids,
                                use_neox_rotary_style, first.device)
    rotate = _rotate_half if use_neox_rotary_style else _rotate_pairwise

    def apply_one(t):
        tf = t.float()
        return (tf * cos_t + rotate(tf) * sin_t).to(t.dtype)

    return tuple(None if t is None else apply_one(t) for t in (q, k, v))
