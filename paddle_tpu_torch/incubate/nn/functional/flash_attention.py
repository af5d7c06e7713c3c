"""Flash attention and scaled-dot-product attention on ``[b, s, h, d]``.

Port of ``paddle_tpu/incubate/nn/functional/flash_attention.py`` (and of
``nn/functional/common.py``'s ``scaled_dot_product_attention``, which
calls it when there is no mask). CUDA tensors go through the Hopper
flash-attention kernels (:func:`..cuda.flash_attn.flash_attention`, K1
forward, K2/K3 backward) for every unmasked causal or full attention:
the JAX package's TPU gate (seq >= 1024, seq % 128 == 0) was a TPU tuning
choice and is not carried over. CPU tensors take the plain composition
the JAX package runs off the TPU, ``_xla_attention``
(:func:`..cuda.flash_attn.flash_attention_ref`).

Attention dropout drops the attention OUTPUT, after the kernel, as the
JAX package does (``flash_attention``: ``bernoulli`` over ``out``), not
the probabilities inside it: that is the reference's semantics, not a
choice of the port, and it keeps K1 / K2 on the path unchanged.

An explicit ``attn_mask`` takes the JAX package's masked composition
on every device (no kernel: the JAX package runs it outside Pallas):
scores in the inputs' type, a bool mask filling -1e9 where it is False,
a float mask added, the softmax in the inputs' type, and dropout, there,
over the PROBABILITIES, as the reference's masked path draws it.
"""
from __future__ import annotations

import torch

from ....nn.functional import common
from ..cuda.flash_attn import flash_attention as _flash_kernel
from ..cuda.flash_attn import flash_attention_ref

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _attention(q, k, v, causal):
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError("attention runs on cuda or cpu, not %s" % q.device)
    return flash_attention_ref(q, k, v, causal=causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    training=True):
    """Returns ``(out, None)`` like the JAX package (no softmax is
    returned). With ``dropout > 0`` in training, ``out`` (the kernel's
    output) goes through dropout, as in the JAX package."""
    out = _attention(query, key, value, causal)
    if dropout > 0.0 and training:
        out = common.dropout(out, dropout)
    return out, None


def _masked_attention(q, k, v, mask, dropout_p):
    """The JAX package's masked SDPA composition on ``[b, s, h, d]``
    tensors; ``mask`` broadcasts against the ``[b, h, sq, sk]`` scores.
    Dropout (``dropout_p > 0``) drops probabilities, upscaled by 1 / (1
    - p), with the keep mask of :func:`common.dropout_mask`."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [b, h, s, d]
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * qh.shape[-1] ** -0.5
    if mask.dtype == torch.bool:
        logits = torch.where(mask, logits, -1e9)
    else:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    if dropout_p:
        keep = common.dropout_mask(w.shape, dropout_p, w.device)
        w = torch.where(keep, w / (1.0 - dropout_p), 0.0).to(w.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """SDPA in the Paddle ``[b, s, h, d]`` layout: without a mask the
    flash path (K1 on the card), with one the masked composition (see
    the module's note; ``is_causal`` is then not read, as in the JAX
    package)."""
    if attn_mask is not None:
        return _masked_attention(query, key, value,
                                 attn_mask.to(query.device),
                                 dropout_p if training else 0.0)
    out, _ = flash_attention(query, key, value, dropout=dropout_p,
                             causal=is_causal, training=training)
    return out
