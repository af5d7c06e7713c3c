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
"""
from __future__ import annotations

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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """SDPA in the Paddle ``[b, s, h, d]`` layout. Only the unmasked
    path is ported (an explicit ``attn_mask``, which the JAX package
    runs as an XLA composition, is a later slice: ROADMAP.md)."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention with attn_mask is not ported "
            "yet: see ROADMAP.md")
    out, _ = flash_attention(query, key, value, dropout=dropout_p,
                             causal=is_causal, training=training)
    return out
