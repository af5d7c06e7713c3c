"""Sequence parallelism: ring attention and Ulysses all-to-all attention.

Port of ``paddle_tpu/distributed/sequence_parallel.py``. Each rank of a
process group holds one contiguous part of the sequence, ``[b, s / P,
h, d]`` (rank r the positions ``r s / P ...``), as the JAX package lays
an ``sp`` axis out:

- :func:`ring_attention`: K / V parts travel around the group's ring
  while each rank attends its queries to the part it holds, through the
  flash-attention forward K1 (``incubate/nn/cuda/flash_attn.py``); the
  parts' outputs are merged by their logsumexp in f32 and cast once. The
  backward runs K2 (or K3, by ``flash_bwd``'s route) on each part from
  the MERGED output and logsumexp; dq sums on the rank, and each part's
  dk / dv accumulate in f32 in a buffer that travels with it and comes
  home after P hops. A rank keeps only its q, k, v, output and
  logsumexp: O(S / P) memory, as the JAX step's ``jax.checkpoint``
  keeps it. Each hop's send and receive (one ``batch_isend_irecv``) is
  posted before the current part's kernels, so the copy runs under
  them. Under ``causal`` a rank skips the parts after its own and its own
  part is causal; the JAX ring gives a skipped part exactly zero weight.
- :func:`ulysses_attention`: an all-to-all turns the sequence split into
  a head split, each rank runs flash attention (K1 forward, K2 / K3
  backward) over the whole sequence for h / P heads, and the reverse
  all-to-all restores the sequence split; each exchange's backward is
  the reverse exchange.

CPU tensors run the same loops over the kernels' plain versions
(``flash_fwd_ref`` / ``flash_bwd_ref``, and ``flash_attention_ref`` for
Ulysses); a CUDA tensor always launches the kernels. The ``*_sharded``
wrappers take the GLOBAL ``[b, s, h, d]`` tensors on every rank, run
this rank's part and return the global output (its gradient, like the
inputs', whole on every rank).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..incubate.nn.cuda import flash_attn as fa
from .collective import P2POp, batch_isend_irecv, irecv, isend

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_sharded",
           "ulysses_attention_sharded", "merge_parts"]


def _ring(group):
    """(size, this member's index, next member's and previous member's
    global ranks)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return (n, me, dist.get_global_rank(group, (me + 1) % n),
            dist.get_global_rank(group, (me - 1) % n))


def _pass_on(t: torch.Tensor, nxt: int, prv: int, group):
    """Start sending ``t`` to ``nxt`` and receiving its like from
    ``prv``: (the receive buffer, the requests)."""
    buf = torch.empty_like(t)
    reqs = batch_isend_irecv([P2POp(isend, t, nxt, group),
                              P2POp(irecv, buf, prv, group)])
    return buf, reqs


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _head_major(*ts):
    return [t.transpose(1, 2) for t in ts]


def _part_fwd(q, k, v, causal, scale):
    """K1 on one K / V part: (out [b, s, h, d], lse [b, h, s] f32)."""
    if q.device.type == "cuda":
        return fa.flash_fwd(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError("ring attention runs on cuda or cpu, not %s"
                         % q.device)
    out, lse = fa.flash_fwd_ref(*_head_major(q, k, v), causal, scale)
    return out.transpose(1, 2), lse[..., 0]


def _part_bwd(q, k, v, out, lse, do, causal, scale):
    """K2 / K3 on one K / V part from the merged ``out`` and ``lse``:
    (dq, dk, dv) in the input type."""
    if q.device.type == "cuda":
        return fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    grads = fa.flash_bwd_ref(*_head_major(q, k, v, out), lse[..., None],
                             do.transpose(1, 2), causal, scale)
    return [g.transpose(1, 2) for g in grads]


def merge_parts(out, lse, o_part, lse_part):
    """The f32 output and logsumexp of the parts seen so far (``out``
    [b, s, h, d], ``lse`` [b, h, s]; None before the first) and one more:
    each output weighted by exp(its lse - the merged lse)."""
    o_part = o_part.float()
    if out is None:
        return o_part, lse_part
    new = torch.logaddexp(lse, lse_part)

    def weight(x):                           # [b, h, s] -> [b, s, h, 1]
        return torch.exp(x - new).transpose(1, 2).unsqueeze(-1)

    return out * weight(lse) + o_part * weight(lse_part), new


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, me, nxt, prv = _ring(group)
        kv = torch.stack([k, v])                    # one message a hop
        cur, out, lse = kv, None, None
        for t in range(n):
            src = (me - t) % n
            if t < n - 1:
                nxt_kv, reqs = _pass_on(cur, nxt, prv, group)
            if not causal or src <= me:
                o_part, lse_part = _part_fwd(q, cur[0], cur[1],
                                             causal and src == me, scale)
                out, lse = merge_parts(out, lse, o_part, lse_part)
            if t < n - 1:
                _wait(reqs)
                cur = nxt_kv
        out = out.to(q.dtype)
        ctx.save_for_backward(q, kv, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, kv, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, me, nxt, prv = _ring(group)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        cur = kv
        for t in range(n):
            src = (me - t) % n
            if t < n - 1:
                nxt_kv, kv_reqs = _pass_on(cur, nxt, prv, group)
            grad = None
            if not causal or src <= me:
                dq_p, dk_p, dv_p = _part_bwd(q, cur[0], cur[1], out, lse, do,
                                             causal and src == me, scale)
                dq += dq_p
                grad = torch.stack([dk_p, dv_p]).float()
            # the part's dk / dv accumulator arrives from the previous
            # rank (sent at step t - 1) and goes on towards the part's
            # home: P hops in all, the last one bringing it there
            if t == 0:
                acc = grad
            else:
                _wait(acc_reqs)
                acc = acc_in if grad is None else acc_in + grad
            if n == 1:
                acc_in, acc_reqs = acc, ()
            else:
                acc_in, acc_reqs = _pass_on(acc, nxt, prv, group)
            if t < n - 1:
                _wait(kv_reqs)
                cur = nxt_kv
        _wait(acc_reqs)
        dk, dv = acc_in.to(kv.dtype)
        return dq.to(q.dtype), dk, dv, None, None, None


def ring_attention(q, k, v, group, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``group`` (see the module note). ``q``, ``k``,
    ``v``: this rank's sequence part ``[b, s / P, h, d]``, the same
    heads in each; returns this rank's output part, q's shape and
    type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring attention takes q, k, v of one shape, got "
                         "%s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    return _RingAttention.apply(q, k, v, group, bool(causal), float(scale))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Piece i of dim 0 to member i; piece i of the result from member
    i."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x, group):
    """[b, s / P, h, d] -> [b, s, h / P, d]: this member's heads of every
    member's sequence part, in member order."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    if h % n:
        raise ValueError("ulysses attention: %d heads do not split over %d "
                         "ranks" % (h, n))
    x = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    y = _all_to_all(x, group)                      # [P, b, s / P, h / P, d]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(y, group):
    """The inverse of :func:`_seq_to_heads`."""
    n = dist.get_world_size(group)
    b, s, h, d = y.shape
    y = y.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous()
    x = _all_to_all(y, group)                      # [P, b, s / P, h / P, d]
    return x.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group), None


class _HeadsToSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _heads_to_seq(y, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def _flash(q, k, v, causal, scale):
    """Flash attention on the whole sequence: K1, then K2 / K3 in the
    backward, on the card; the plain composition on the CPU."""
    if q.device.type == "cuda":
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError("ulysses attention runs on cuda or cpu, not %s"
                         % q.device)
    return fa.flash_attention_ref(q, k, v, causal=causal, scale=scale)


def ulysses_attention(q, k, v, group, causal: bool = True,
                      scale: Optional[float] = None,
                      attention_fn=None) -> torch.Tensor:
    """Ulysses attention over ``group`` (see the module note). ``q``,
    ``k``, ``v``: this rank's sequence part ``[b, s / P, h, d]``; the
    head counts must divide by P. ``attention_fn(q, k, v)`` replaces the
    flash attention on the ``[b, s, h / P, d]`` tensors. Returns this
    rank's output part."""
    qg, kg, vg = (_SeqToHeads.apply(x, group) for x in (q, k, v))
    if attention_fn is None:
        out = _flash(qg, kg, vg, causal, scale)
    else:
        out = attention_fn(qg, kg, vg)
    return _HeadsToSeq.apply(out, group)


# ------------------------------------------------------ global wrappers
class _Part(torch.autograd.Function):
    """This member's part of dim 1 of a tensor every member holds whole;
    the gradient comes back whole (every member's part gathered)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, me = dist.get_world_size(group), dist.get_rank(group)
        s = x.shape[1] // n
        return x[:, me * s:(me + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Whole.apply(g, ctx.group), None


class _Whole(torch.autograd.Function):
    """Every member's part of dim 1 put together; the gradient (the same
    on every member) cut back to this member's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        return _Part.apply(g, ctx.group), None


def _sharded(fn, q, k, v, group, **kw):
    if q.shape[1] % dist.get_world_size(group):
        raise ValueError("sequence of %d does not split over %d ranks"
                         % (q.shape[1], dist.get_world_size(group)))
    parts = (_Part.apply(x, group) for x in (q, k, v))
    return _Whole.apply(fn(*parts, group, **kw), group)


def ring_attention_sharded(q, k, v, group, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """:func:`ring_attention` on GLOBAL ``[b, s, h, d]`` tensors (the
    same on every rank of ``group``): this rank runs its sequence part;
    returns the global output."""
    return _sharded(ring_attention, q, k, v, group, causal=causal,
                    scale=scale)


def ulysses_attention_sharded(q, k, v, group, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """:func:`ulysses_attention` on GLOBAL ``[b, s, h, d]`` tensors:
    this rank runs its sequence part; returns the global output."""
    return _sharded(ulysses_attention, q, k, v, group, causal=causal,
                    scale=scale)
