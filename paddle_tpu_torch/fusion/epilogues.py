"""Fused training epilogues: the residual add with the RMSNorm after it,
the SwiGLU gate, and the residual add with dropout.

Port of ``add_rms_norm``, ``swiglu_linear`` and ``dropout_add`` of
``paddle_tpu/fusion/epilogues.py``, the regions Llama's and GPT's blocks
run on the JAX package's default (fused) route. Each keeps the JAX region's
arithmetic: the residual add in the residual's type, then the norm with
f32 statistics rounded once (``fused_rms_norm``: one K7 launch under
``no_grad`` on the card; with a gradient the add is autograd's and the
norm K7's :class:`_RowNorm`); ``silu(x @ Wg) * (x @ Wu)``; ``residual +
dropout(y)``, the mask drawn by the one dropout draw of
:mod:`paddle_tpu_torch.nn.functional.common`.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..incubate.nn.functional import fused_rms_norm
from ..nn.functional import common

__all__ = ["add_rms_norm", "swiglu_linear", "dropout_add"]


def add_rms_norm(y, residual, weight, epsilon=1e-6):
    """``(rms_norm(residual + y), residual + y)`` (the JAX
    ``add_rms_norm``)."""
    return fused_rms_norm(y, weight, None, epsilon, residual=residual)


def swiglu_linear(x, gate_weight, up_weight, shard_axes=None,
                  quant_mode="off"):
    """``silu(x @ Wg) * (x @ Wu)`` with Paddle's ``[in, out]`` weights
    (the JAX ``swiglu_linear``). ``shard_axes`` is accepted and unused
    (one device); quantized modes are not ported."""
    if quant_mode != "off":
        raise NotImplementedError(
            "swiglu_linear(quant_mode=%r) is not ported yet: see "
            "ROADMAP.md" % (quant_mode,))
    return F.silu(x @ gate_weight) * (x @ up_weight)


def dropout_add(y, residual, p=0.0, training=True):
    """``residual + dropout(y, p)`` (the JAX ``dropout_add``): bitwise
    the unfused composition from the same generator state, the same mask
    draw, upscale and operand order; ``residual + y`` with ``p = 0`` or
    outside training."""
    return residual + common.dropout(y, p, training=training)
