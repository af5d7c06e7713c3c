"""Chunked lm head + cross entropy.

Port of ``paddle_tpu/fusion/chunked.py`` ``lm_head_chunked_ce``: the
training loss of an LM head computed over equal token chunks, so that a
chunk's ``[T/C, vocab]`` logits exist only while that chunk is worked
on, in the forward and again in the backward, which recomputes them (the
JAX package runs each chunk under ``jax.checkpoint``). The forward keeps
only each token's logsumexp. Each token's NLL is ``lse - logit[label]``
from f32 logits, and the mean divides the one global sum by the count of
non-ignored tokens, so the loss does not depend on the chunk count.
"""
from __future__ import annotations

import torch

__all__ = ["lm_head_chunked_ce"]


def _logits(x, w, transpose_weight):
    return (x @ w.t() if transpose_weight else x @ w).float()


class _ChunkedLMHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunks, transpose_weight, ignore_index):
        n = x.shape[0] // chunks
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0)
        count = valid.sum().clamp_min(1).float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for c in range(chunks):
            rows = slice(c * n, (c + 1) * n)
            logits = _logits(x[rows], w, transpose_weight)
            lse[rows] = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, safe[rows, None])[:, 0]
            total += torch.where(valid[rows], lse[rows] - picked, 0.0).sum()
        ctx.save_for_backward(x, w, safe, valid, lse, count)
        ctx.chunks, ctx.transpose_weight = chunks, transpose_weight
        return total / count

    @staticmethod
    def backward(ctx, grad):
        x, w, safe, valid, lse, count = ctx.saved_tensors
        chunks, tw = ctx.chunks, ctx.transpose_weight
        n = x.shape[0] // chunks
        # d loss / d logit = (softmax - onehot(label)) * grad / count on
        # non-ignored tokens; dw summed over the chunks in f32
        g = (grad.float() / count) * valid.float()
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for c in range(chunks):
            rows = slice(c * n, (c + 1) * n)
            dl = torch.exp(_logits(x[rows], w, tw) - lse[rows, None])
            dl.scatter_add_(1, safe[rows, None], -torch.ones_like(dl[:, :1]))
            dl = (dl * g[rows, None]).to(x.dtype)
            if tw:                      # logits = x @ w.T, w [vocab, h]
                dx[rows] = dl @ w
                dw += (dl.t() @ x[rows]).float()
            else:                       # logits = x @ w, w [h, vocab]
                dx[rows] = dl @ w.t()
                dw += (x[rows].t() @ dl).float()
        return dx, dw.to(w.dtype), None, None, None, None


def lm_head_chunked_ce(x, weight, labels, chunks: int,
                       transpose_weight: bool, ignore_index: int = -100):
    """Mean token cross entropy of ``x @ weight.T`` (tied embeddings,
    ``weight [vocab, h]``, ``transpose_weight=True``) or ``x @ weight``
    (``[h, vocab]``) against ``labels``, in ``chunks`` equal token
    chunks. ``x`` is ``[..., h]`` and ``labels`` has its leading shape;
    tokens labelled ``ignore_index`` do not count. ``chunks`` must divide
    the token count."""
    h = x.shape[-1]
    xt = x.reshape(-1, h)
    lab = labels.reshape(-1).to(device=x.device, dtype=torch.long)
    if chunks < 1 or xt.shape[0] % chunks:
        raise ValueError("token count %d is not divisible by chunks=%d"
                         % (xt.shape[0], chunks))
    return _ChunkedLMHeadCE.apply(xt, weight, lab, int(chunks),
                                  bool(transpose_weight), int(ignore_index))
