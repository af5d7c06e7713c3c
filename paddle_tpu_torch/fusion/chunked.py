"""Chunked lm head + cross entropy.

Port of ``paddle_tpu/fusion/chunked.py`` ``lm_head_chunked_ce``: the
training loss of an LM head computed over equal token chunks, so that a
chunk's ``[T/C, vocab]`` logits exist only while that chunk is worked
on, in the forward and again in the backward, which recomputes them (the
JAX package runs each chunk under ``jax.checkpoint``). The forward keeps
only each token's logsumexp. Each token's NLL is ``lse - logit[label]``
from f32 logits, and the mean divides the one global sum by the count of
non-ignored tokens, so the loss does not depend on the chunk count.

On a mesh the weight holds this rank's slice of the vocabulary (``[V /
mp, h]`` tied, ``[h, V / mp]`` untied) and the tokens are this rank's
part of the global batch (its ``dp`` rows, and on a sequence-parallel
mesh its ``sp`` part of each row): each chunk's max, sum of exponentials
and target logit are all-reduced over ``mp_group``, the count of
non-ignored tokens over ``batch_group`` (the ``dp`` x ``sp`` ranks), and
the loss is the global mean (this rank's share, summed over
``batch_group`` forward; its gradient is the share's).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import reduce_from

__all__ = ["lm_head_chunked_ce"]


def _logits(x, w, transpose_weight):
    return (x @ w.t() if transpose_weight else x @ w).float()


class _ChunkedLMHeadCE(torch.autograd.Function):
    """This rank's share of the global mean: its tokens' sum over the
    count of every ``batch_group`` rank's non-ignored tokens. Without
    groups (``mp`` / ``batch`` None) the weight is the whole vocabulary
    and the share is the mean."""

    @staticmethod
    def forward(ctx, x, w, labels, chunks, transpose_weight, ignore_index,
                mp, batch):
        n = x.shape[0] // chunks
        vl = w.shape[0] if transpose_weight else w.shape[1]
        start = dist.get_rank(mp) * vl if mp is not None else 0
        valid = labels != ignore_index
        local = labels - start
        inside = valid & (local >= 0) & (local < vl)
        safe = torch.where(inside, local, 0)
        count = valid.sum().float()
        if batch is not None:
            dist.all_reduce(count, group=batch)
        count = count.clamp_min(1)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for c in range(chunks):
            rows = slice(c * n, (c + 1) * n)
            logits = _logits(x[rows], w, transpose_weight)
            m = logits.amax(dim=-1)
            if mp is not None:
                dist.all_reduce(m, dist.ReduceOp.MAX, group=mp)
            sums = torch.stack([
                torch.exp(logits - m[:, None]).sum(-1),
                torch.where(inside[rows], logits.gather(
                    1, safe[rows, None])[:, 0], 0.0)])
            if mp is not None:
                dist.all_reduce(sums, group=mp)
            lse[rows] = m + torch.log(sums[0])
            total += torch.where(valid[rows], lse[rows] - sums[1], 0.0).sum()
        ctx.save_for_backward(x, w, safe, valid, inside, lse, count)
        ctx.chunks, ctx.transpose_weight = chunks, transpose_weight
        return total / count

    @staticmethod
    def backward(ctx, grad):
        x, w, safe, valid, inside, lse, count = ctx.saved_tensors
        chunks, tw = ctx.chunks, ctx.transpose_weight
        n = x.shape[0] // chunks
        # this rank's vocabulary slice of (softmax - onehot(label)) *
        # grad / count on non-ignored tokens, dw summed over the chunks
        # in f32; on a mesh dx is partial over mp (the caller's copy_to
        # sums it)
        g = (grad.float() / count) * valid.float()
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for c in range(chunks):
            rows = slice(c * n, (c + 1) * n)
            dl = torch.exp(_logits(x[rows], w, tw) - lse[rows, None])
            dl.scatter_add_(1, safe[rows, None],
                            -inside[rows, None].to(dl.dtype))
            dl = (dl * g[rows, None]).to(x.dtype)
            if tw:                      # logits = x @ w.T, w [vocab, h]
                dx[rows] = dl @ w
                dw += (dl.t() @ x[rows]).float()
            else:                       # logits = x @ w, w [h, vocab]
                dx[rows] = dl @ w.t()
                dw += (x[rows].t() @ dl).float()
        return dx, dw.to(w.dtype), None, None, None, None, None, None


def lm_head_chunked_ce(x, weight, labels, chunks: int,
                       transpose_weight: bool, ignore_index: int = -100,
                       mp_group=None, batch_group=None):
    """Mean token cross entropy of ``x @ weight.T`` (tied embeddings,
    ``weight [vocab, h]``, ``transpose_weight=True``) or ``x @ weight``
    (``[h, vocab]``) against ``labels``, in ``chunks`` equal token
    chunks. ``x`` is ``[..., h]`` and ``labels`` has its leading shape;
    tokens labelled ``ignore_index`` do not count. ``chunks`` must divide
    the token count. With ``mp_group`` / ``batch_group`` (a mesh) the
    weight is this rank's vocabulary slice and the mean is over every
    ``batch_group`` rank's tokens (see the module note)."""
    h = x.shape[-1]
    xt = x.reshape(-1, h)
    lab = labels.reshape(-1).to(device=x.device, dtype=torch.long)
    if chunks < 1 or xt.shape[0] % chunks:
        raise ValueError("token count %d is not divisible by chunks=%d"
                         % (xt.shape[0], chunks))
    share = _ChunkedLMHeadCE.apply(xt, weight, lab, int(chunks),
                                   bool(transpose_weight), int(ignore_index),
                                   mp_group, batch_group)
    return reduce_from(share, batch_group)
