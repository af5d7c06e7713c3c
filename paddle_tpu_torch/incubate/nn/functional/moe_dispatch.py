"""The sort-dispatched MoE FFN.

Port of ``moe_ffn_sorted`` in ``paddle_tpu/incubate/nn/pallas/
moe_dispatch.py``. :func:`grouped_matmul` is the port's one dispatching
layer for the grouped GEMM: a CUDA tensor goes through the Hopper kernel
(:mod:`..cuda.moe_dispatch`, the counterpart of the TPU kernel K8) and a
CPU tensor through its plain version. The gradient is autograd through
the plain version: on the CPU directly, on CUDA through a Function whose
forward launches K8 and whose backward is the vjp of the plain version
(the JAX package has no backward kernel for K8 either; off the TPU its
gradient is ``ragged_dot``'s).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..cuda import moe_dispatch as _k
from ..cuda.moe_dispatch import BM, block_rows, sort_dispatch

__all__ = ["grouped_matmul", "moe_ffn_sorted"]


class _GroupedMatmul(torch.autograd.Function):
    """Forward on K8; backward is the vjp of the plain version,
    recomputed from xp and w."""

    @staticmethod
    def forward(ctx, xp, w, block_gid, rows):
        ctx.save_for_backward(xp, w, block_gid, rows)
        return _k.grouped_matmul(xp, w, block_gid, rows=rows)

    @staticmethod
    def backward(ctx, g):
        xp, w, block_gid, rows = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((xp, w), ctx.needs_input_grad[:2])]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                _k.grouped_matmul_ref(*leaves, block_gid, rows=rows),
                wanted, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + (None, None)


def grouped_matmul(xp, w, block_gid, *, rows=None):
    """Row block i of ``xp [P, K]`` times ``w[block_gid[i]]`` (the JAX
    package's ``grouped_matmul``), differentiable in xp and w. With
    ``rows`` (int32 ``[P/128]``, :func:`block_rows` of a dispatch), rows
    of block i at or past ``rows[i]`` are zero and their work is
    skipped; the JAX function has no such argument."""
    if xp.device.type == "cuda":
        if torch.is_grad_enabled() and (xp.requires_grad or w.requires_grad):
            return _GroupedMatmul.apply(xp, w, block_gid, rows)
        return _k.grouped_matmul(xp, w, block_gid, rows=rows)
    if xp.device.type != "cpu":
        raise ValueError("the grouped GEMM runs on cuda or cpu, not %s"
                         % xp.device)
    return _k.grouped_matmul_ref(xp, w, block_gid, rows=rows)


def _add_per_block(h, b, block_gid):
    """``h + b.reshape(E, -1)[block_gid].repeat(128, 0)``, the JAX
    package's per-block bias, as a broadcast over each block's rows."""
    n = h.shape[-1]
    bb = b.reshape(b.shape[0], -1)[block_gid.long()]
    return (h.view(-1, BM, n) + bb[:, None, :]).view(-1, n)


def moe_ffn_sorted(x, probs, w1, w2, k=2, *, activation="swiglu",
                   normalize=True, b1=None, b2=None):
    """Sort-dispatched MoE FFN. x [S, M]; probs [S, E]; w1 [E, M, H]
    (H = 2 * dff for swiglu, gate half first); w2 [E, dff | H, M];
    biases [E, H] and [E, M] (or any shape with E rows). ``activation``
    is "swiglu", "gelu" (tanh approximation, ``jax.nn.gelu``'s default)
    or anything else for relu. Returns [S, M]: each token's top-k expert
    outputs weighted by its (normalised) router probabilities. Both
    products take the dispatch's row counts (:func:`block_rows`), so
    blocks of padding cost no weight reads; their rows never reach the
    combine, which gathers only ``dest`` rows."""
    d = sort_dispatch(x, probs, k, normalize=normalize)
    gid = d["block_gid"]
    rows = block_rows(gid, d["group_sizes"], d["padded_sizes"])
    h = grouped_matmul(d["xp"], w1, gid, rows=rows)
    if b1 is not None:
        h = _add_per_block(h, b1, gid)
    if activation == "swiglu":
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.clamp_min(h, 0)
    y = grouped_matmul(h.to(x.dtype), w2, gid, rows=rows)
    if b2 is not None:
        y = _add_per_block(y, b2, gid)
    s, m = x.shape
    # gather-only combine: dest is pair-major, so y[dest] is in (token, k)
    # order already
    pair_y = y[d["dest"]] * d["weight"][:, None].to(y.dtype)
    return pair_y.reshape(s, k, m).sum(1)
