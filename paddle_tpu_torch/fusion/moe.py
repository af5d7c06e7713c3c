"""Top-2 GShard MoE FFN with scatter dispatch and gather combine.

Port of ``paddle_tpu/fusion/moe.py`` ``fused_moe_mlp``, the JAX
package's default route for ``GPTMoEMLP``. Routing works on ``[S, E]``
tensors only (f32 softmax, the first and second argmax, cumsum
positions, the capacity cut, gates normalised over the kept choices),
with the JAX region's arithmetic expression by expression
(``torch.argmax`` takes the first maximum on ties, as ``jnp.argmax``
does). Dispatch adds each kept token into its slot of an ``[E*cap + 1,
d]`` buffer whose last row collects the dropped ones; every kept slot
is written once, so the expert inputs equal the tokens bit for bit and
do not depend on the order of the adds. The experts are two batched
products over ``[E, cap, .]`` (plain ``torch.matmul``: the JAX package
computes them outside any Pallas kernel, and K8's row layout is
``sort_dispatch``'s, not these capacity slots). Combine gathers each
token's two slots (the trash row reads as zero) and weights them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fused_moe_mlp", "gshard_top2"]


def _cumsum_tokens(m):
    """``cumsum(m, 0)`` of a one-hot ``[S, E]``, scanned along the token
    axis as rows of an ``[E, S]`` copy: the same integers (exact in f32),
    without a scan of E columns over S serial steps."""
    return m.t().contiguous().cumsum(1).t()


def gshard_top2(logits, num_experts, capacity):
    """Top-2 GShard routing of ``S`` tokens from their router logits
    ``[S, E]``: ``(slot1, slot2, g1, g2, aux)``. A kept choice's slot is
    ``expert * capacity + position`` (positions count an expert's first
    choices in token order, then its second choices), a dropped one's
    ``E * capacity``; ``g1`` / ``g2`` (f32) are the two gates normalised
    over the kept choices (0 where dropped), ``aux`` the f32 load-balance
    loss. Differentiable in ``logits`` through the gates and aux."""
    E, cap = int(num_experts), int(capacity)
    gates = torch.softmax(logits.float(), dim=-1)
    idx1 = gates.argmax(-1)
    m1 = F.one_hot(idx1, E).float()
    g1 = (gates * m1).sum(-1)
    gates2 = gates * (1.0 - m1)
    idx2 = gates2.argmax(-1)
    m2 = F.one_hot(idx2, E).float()
    g2 = (gates2 * m2).sum(-1)
    aux = (m1.mean(0) * gates.mean(0)).sum() * E

    pos1 = _cumsum_tokens(m1) * m1 - m1
    pos2 = (_cumsum_tokens(m2) - 1.0 + m1.sum(0)[None]) * m2
    m1 = m1 * (pos1 < cap)
    m2 = m2 * (pos2 < cap)
    g1 = g1 * m1.sum(-1)
    g2 = g2 * m2.sum(-1)
    denom = torch.where(g1 + g2 > 0, g1 + g2, 1.0)
    g1, g2 = g1 / denom, g2 / denom
    slot1 = torch.where(m1.sum(-1) > 0, idx1 * cap + pos1.sum(-1).long(),
                        E * cap)
    slot2 = torch.where(m2.sum(-1) > 0, idx2 * cap + pos2.sum(-1).long(),
                        E * cap)
    return slot1, slot2, g1, g2, aux


def fused_moe_mlp(x, gate_weight, w1, b1, w2, b2, num_experts, capacity):
    """``(y [b, s, d], aux_loss f32 0-d)`` for tokens ``x [b, s, d]``,
    router ``gate_weight [d, E]``, experts ``w1 [E, d, ffn]``, ``b1 [E,
    ffn]``, ``w2 [E, ffn, d]``, ``b2 [E, d]`` (tanh-approximate gelu
    between), ``capacity`` slots an expert. Differentiable by autograd."""
    E, cap = int(num_experts), int(capacity)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    slot1, slot2, g1, g2, aux = gshard_top2(xf @ gate_weight, E, cap)

    # --- dispatch: kept tokens into [E*cap (+1 trash), d] slots
    buf = xf.new_zeros(E * cap + 1, d)
    for slot in (slot1, slot2):
        buf = buf.index_add(0, slot, torch.where((slot < E * cap)[:, None],
                                                 xf, 0))
    xe = buf[:E * cap].reshape(E, cap, d)

    # --- the experts
    h1 = F.gelu(torch.matmul(xe, w1) + b1[:, None, :], approximate="tanh")
    ye = torch.matmul(h1, w2) + b2[:, None, :]

    # --- combine: each token's two slots, weighted (index_select: its
    # backward adds each kept slot's one gradient row, no sort)
    yf = torch.cat([ye.reshape(E * cap, d), ye.new_zeros(1, d)])
    y = g1.to(xf.dtype)[:, None] * yf.index_select(0, slot1) \
        + g2.to(xf.dtype)[:, None] * yf.index_select(0, slot2)
    return y.reshape(b, s, d), aux
