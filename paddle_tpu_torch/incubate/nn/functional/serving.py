"""Serving fused ops.

Port of ``paddle_tpu/incubate/nn/functional/serving.py`` (the counterpart
of PaddleNLP's serving operators), one operator so far: :func:`fused_moe`,
the one that reaches a TPU kernel (K8, through :func:`.moe_dispatch.
moe_ffn_sorted`). The module's other operators reach none and are ported
with the slices that need them.
"""
from __future__ import annotations

import torch

from .moe_dispatch import moe_ffn_sorted

__all__ = ["fused_moe"]


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """Fused top-k MoE FFN with SwiGLU experts, as the JAX package's
    ``fused_moe``. x [b, s, d]; ``gate_weight`` [d, E] (router logits are
    ``tokens @ gate_weight``), or, when it is not 2-D, the router logits
    themselves (reshaped to [-1, E]); ffn1 [E, d, 2*dff] (gate half
    first), ffn2 [E, dff, d]; biases [E, 2*dff] / [E, 1, 2*dff] and
    [E, d] / [E, 1, d]. Router softmax in f32; each token's top
    ``moe_topk`` experts, their probabilities renormalised when
    ``norm_topk_prob``. The scales belong to weight quantization, which
    raises ``NotImplementedError`` as in the JAX package. Weights in the
    JAX package's layouts load as they are: ``convert.
    params_from_paddle_tpu`` on a dict of its numpy arrays carries them
    over, bf16 bit for bit."""
    if quant_method not in ("None", "none", None):
        raise NotImplementedError(
            "weight-quant fused_moe is not ported: the experts compute in "
            "the weights' own type")
    bsz, s, dm = x.shape
    e = ffn1_weight.shape[0]
    toks = x.reshape(-1, dm)
    if gate_weight.dim() == 2:
        dt = torch.promote_types(toks.dtype, gate_weight.dtype)
        logits = toks.to(dt) @ gate_weight.to(dt)
    else:
        logits = gate_weight.reshape(-1, e)
    probs = torch.softmax(logits.float(), dim=-1)
    out = moe_ffn_sorted(toks, probs, ffn1_weight, ffn2_weight, k=moe_topk,
                         activation="swiglu", normalize=norm_topk_prob,
                         b1=ffn1_bias, b2=ffn2_bias)
    return out.reshape(bsz, s, dm)
