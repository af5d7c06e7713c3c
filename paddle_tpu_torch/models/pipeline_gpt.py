"""The pure-function GPT that ``bench.py``'s multichip leg
(``_multichip_result``) trains through the compiled pipeline, in PyTorch.

The model is a list of stacked parameter leaves and three functions, the
shape :class:`~paddle_tpu_torch.distributed.pipeline.CompiledPipeline`
takes: :func:`weights` draws the blocks and the extra parameters as
``bench.py`` does, :func:`stack` lays the blocks out ``[S, B, ...]`` by
stage, and :func:`functions` gives ``stage_fn`` / ``pre_fn`` /
``loss_fn``. The leaves are numpy arrays, so the JAX package's pipeline
takes the same ones.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["weights", "stack", "functions"]


def weights(layers, hidden, vocab, seq, seed=0):
    """``bench.py`` _multichip_result's weights, drawn in its order from
    ``np.random.default_rng(seed)``: ``layers`` blocks of 12 leaves
    (LayerNorm, qkv, out projection, LayerNorm, MLP; 0.02 x N(0, 1)
    matrices, zero biases), then the embeddings, final norm and head.
    Returns the blocks, the extra params and the generator, from which
    ``bench.py`` then draws its batch."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    h4 = 4 * hidden
    ones = lambda n: np.ones(n, np.float32)      # noqa: E731
    zeros = lambda n: np.zeros(n, np.float32)    # noqa: E731
    blocks = [[ones(hidden), zeros(hidden), w(hidden, 3 * hidden),
               zeros(3 * hidden), w(hidden, hidden), zeros(hidden),
               ones(hidden), zeros(hidden), w(hidden, h4), zeros(h4),
               w(h4, hidden), zeros(hidden)] for _ in range(layers)]
    extra = {"wte": w(vocab, hidden), "wpe": w(seq, hidden),
             "lnfw": ones(hidden), "lnfb": zeros(hidden),
             "head": w(hidden, vocab)}
    return blocks, extra, rng


def stack(blocks, stages):
    """The 12 leaves ``[S, B, ...]``: stage s owns blocks [s B, (s+1) B)."""
    b = len(blocks) // stages
    return [np.stack([np.stack([blocks[s * b + j][i] for j in range(b)])
                      for s in range(stages)]) for i in range(12)]


def functions(heads):
    """``stage_fn`` (pre-LayerNorm blocks: causal softmax attention, gelu
    MLP with the tanh approximation as ``jax.nn.gelu``), ``pre_fn`` (token
    + position embedding) and ``loss_fn`` (final LayerNorm, head, mean
    NLL in f32)."""
    F = torch.nn.functional

    def ln(x, wt, bs):
        return F.layer_norm(x, x.shape[-1:], wt, bs, 1e-5)

    def blk(p, x):
        ln1w, ln1b, wqkv, bqkv, wo, bo, ln2w, ln2b, w1, b1, w2, b2 = p
        b, s, d = x.shape
        hd = d // heads
        q, k, v = (ln(x, ln1w, ln1b) @ wqkv + bqkv).split(d, -1)

        def sp(t):
            return t.reshape(b, s, heads, hd).transpose(1, 2)

        att = (sp(q) @ sp(k).transpose(-1, -2)) * (1.0 / float(np.sqrt(hd)))
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~keep, -1e9)
        o = (att.softmax(-1) @ sp(v)).transpose(1, 2).reshape(b, s, d)
        x = x + o @ wo + bo
        z = ln(x, ln2w, ln2b)
        return x + F.gelu(z @ w1 + b1, approximate="tanh") @ w2 + b2

    def stage_fn(params, x):
        for i in range(params[0].shape[0]):
            x = blk([a[i] for a in params], x)
        return x

    def pre_fn(ex, ids):
        return ex["wte"][ids] + ex["wpe"][None, :]

    def loss_fn(ex, hh, ym):
        z = ln(hh, ex["lnfw"], ex["lnfb"]) @ ex["head"]
        lp = torch.log_softmax(z.float(), -1)
        return -lp.gather(-1, ym[..., None]).mean()

    return stage_fn, pre_fn, loss_fn
