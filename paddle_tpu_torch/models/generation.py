"""The GPT and Llama serving steps over paged KV pools, and the sampler.

Port of the serving half of ``paddle_tpu/models/generation.py``: the
norms ``_ln`` and ``_rms`` and the residual updates fused with the norm
after them, ``_add_ln`` and ``_add_rms`` (on the card each one launch of
the Hopper row-norm kernel K7), ``_rope``, the fp ``_linear``,
``GPTDecodeAdapter`` and ``LlamaDecodeAdapter`` with their
``ragged_chunk`` (one ragged mixed prefill + decode step over fp or int8
pools, the engine's default layout) and ``paged_chunk`` (g tokens at
per-row positions: a decode batch or a prefill chunk of the engine's
two-program ``ragged="off"`` layout), ``_ragged_attn`` (K4 / K5 on the
card), ``_paged_attn_chunk`` (K6 on the card) and ``_sample``. PyTorch
runs eagerly, so there is no jit: the pools are written in place and a
step is a plain function of tensors. ``generate()``, beam search,
speculative decoding and weight quantization are later slices
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from ..incubate.nn.cuda.paged_attention import (
    kv_scatter, kv_write_slots, paged_attention, paged_attention_ref,
    pool_shape, ragged_paged_attention, ragged_paged_attention_ref)
from ..incubate.nn.functional.fused_ops import (
    fused_layer_norm, fused_rms_norm, layer_norm, rms_norm)

__all__ = ["GPTDecodeAdapter", "LlamaDecodeAdapter"]


def _ln(x, w, b, eps):
    """LayerNorm with f32 statistics (the JAX ``_ln``; K7 on the card)."""
    return layer_norm(x, w, b, eps)


def _rms(x, w, eps):
    """RMSNorm with f32 statistics (the JAX ``_rms``; K7 on the card)."""
    return rms_norm(x, w, None, eps)


def _add_ln(y, bias, res, w, b, eps):
    """A residual update and the LayerNorm after it: ``(_ln(s), s)``
    for ``s = res + (y + bias)``, rounded as those two adds round (the
    JAX ``fused_layer_norm`` with ``bias=`` and ``residual=``; one K7
    launch on the card)."""
    return fused_layer_norm(y, w, b, eps, bias=bias, residual=res)


def _add_rms(y, res, w, eps):
    """A residual update and the RMSNorm after it: ``(_rms(s), s)`` for
    ``s = res + y`` (the JAX ``fused_rms_norm`` with ``residual=``; one
    K7 launch on the card)."""
    return fused_rms_norm(y, w, None, eps, residual=res)


def _rope_angles(pos, head_dim, base):
    """cos and sin ``[T, 1, head_dim // 2]`` of the f32 angles ``pos *
    base^(-i/half)`` for positions ``pos [T]``: the same for every layer
    of a step, so a step computes them once."""
    half = head_dim // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=pos.device) / half)
    ang = pos.float()[:, None, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """Rotate ``x [T, nh, hd]`` by the angles of :func:`_rope_angles`:
    the half-split rotation in f32, rounded back to x's type (the JAX
    ``_rope``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _linear(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


class GPTDecodeAdapter:
    """Learned-position GPT decoder (gpt.py GPTForCausalLM): weights as
    a plain dict of tensors plus the pure step functions the serving
    engine calls."""

    def __init__(self, model):
        cfg = model.config
        self.num_layers = cfg.num_layers
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.layer_norm_eps
        self.vocab_size = cfg.vocab_size
        self.max_positions = cfg.max_position_embeddings
        g = model.gpt

        def opt(p):
            return None if p is None else p.detach()

        layers = []
        for blk in g.h:
            layers.append({
                "ln1_w": blk.ln_1.weight.detach(),
                "ln1_b": blk.ln_1.bias.detach(),
                "qkv_w": blk.attn.qkv_proj.weight.detach(),
                "qkv_b": opt(blk.attn.qkv_proj.bias),
                "out_w": blk.attn.out_proj.weight.detach(),
                "out_b": opt(blk.attn.out_proj.bias),
                "ln2_w": blk.ln_2.weight.detach(),
                "ln2_b": blk.ln_2.bias.detach(),
                "fc1_w": blk.mlp.fc1.weight.detach(),
                "fc1_b": opt(blk.mlp.fc1.bias),
                "fc2_w": blk.mlp.fc2.weight.detach(),
                "fc2_b": opt(blk.mlp.fc2.bias),
            })
        head = None if model.lm_head is None else \
            model.lm_head.weight.detach()
        self.weights = {
            "wte": g.wte.weight.detach(), "wpe": g.wpe.weight.detach(),
            "lnf_w": g.ln_f.weight.detach(), "lnf_b": g.ln_f.bias.detach(),
            "layers": layers, "lm_head": head,
        }
        self.dtype = self.weights["wte"].dtype

    def logits(self, w, x, h=None):
        """Logits of the residual stream ``x``; ``h`` is its final norm
        when the caller has it (fused into the last residual update)."""
        x = _ln(x, w["lnf_w"], w["lnf_b"], self.eps) if h is None else h
        head = w["lm_head"]
        if head is None:
            return x @ w["wte"].T
        return _linear(x, head)

    def _forward(self, w, toks, pos, kpages, vpages, rows, slots, attend):
        """The decoder over a flat token axis: ``toks``, ``pos [T]``
        (``pos < 0``: padding, embedded at position 0); each layer writes
        its k/v rows ``rows`` at the flat pool ``slots`` (in place), then
        ``attend(layer, q [T, nh, hd])`` returns the attention over the
        pools. Returns logits [T, V]."""
        nh, hd, dt = self.num_heads, self.head_dim, self.dtype
        T = toks.shape[0]
        x = (w["wte"][toks.long()]
             + w["wpe"][pos.clamp_min(0).long()]).to(dt)
        layers = w["layers"]
        # each residual update is fused with the norm after it: the next
        # layer's ln_1, or ln_f after the last layer
        h = _ln(x, layers[0]["ln1_w"], layers[0]["ln1_b"], self.eps) \
            if layers else None
        for i, W in enumerate(layers):
            qkv = _linear(h, W["qkv_w"], W["qkv_b"]).reshape(T, 3, nh, hd)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            kv_scatter(kpages[i], k, rows, slots)
            kv_scatter(vpages[i], v, rows, slots)
            att = attend(i, q)
            h, x = _add_ln(att.reshape(T, nh * hd) @ W["out_w"], W["out_b"],
                           x, W["ln2_w"], W["ln2_b"], self.eps)
            m = F.gelu(_linear(h, W["fc1_w"], W["fc1_b"]),
                       approximate="tanh")
            nw, nb = (layers[i + 1]["ln1_w"], layers[i + 1]["ln1_b"]) \
                if i + 1 < len(layers) else (w["lnf_w"], w["lnf_b"])
            h, x = _add_ln(m @ W["fc2_w"], W["fc2_b"], x, nw, nb, self.eps)
        return self.logits(w, x, h)

    @torch.no_grad()
    def ragged_chunk(self, w, toks, pos, row_of, q_starts, query_lens,
                     context_lens, kpages, vpages, block_tables,
                     attn: Optional[Callable] = None):
        """ONE ragged mixed prefill+decode step over paged pools. Flat
        token axis [T] packed row-major: row r owns tokens q_starts[r]
        .. q_starts[r]+query_lens[r], row_of [T] maps each token to its
        row (-1 = padding). pos [T] is each token's absolute position
        (< 0 = padding: write dropped, output ignored); block_tables
        [n_rows, P] is per ROW; context_lens[r] counts the row's KV
        INCLUDING this step's tokens. The per-layer pools are written IN
        PLACE; they may be fp tensors or int8 ``{"q8", "s"}`` dicts.
        ``attn`` replaces the attention function (default: the Hopper
        kernels' wrapper :func:`ragged_paged_attention` on the card, its
        plain version on the CPU; pass ``ragged_paged_attention_ref`` to
        run the plain version on the card). Returns (logits [T, V],
        kpages, vpages)."""
        rows, slots = _ragged_slots(kpages, block_tables, row_of, pos)
        lg = self._forward(
            w, toks, pos, kpages, vpages, rows, slots,
            lambda i, q: _ragged_attn(q, kpages[i], vpages[i], block_tables,
                                      context_lens, query_lens, q_starts,
                                      row_of, self.head_dim, attn))
        return lg, kpages, vpages

    @torch.no_grad()
    def paged_chunk(self, w, toks, pos, kpages, vpages, block_tables,
                    attn: Optional[Callable] = None):
        """g tokens at per-row positions over PAGED pools: a decode batch
        (g = 1) or a prefill chunk (b = 1) of the engine's two-program
        layout (the JAX adapter's ``paged_chunk``). toks/pos [b, g];
        ``pos < 0`` marks an inactive row or prefill padding: its write
        is dropped and its attention is zero. block_tables [b, P]. The
        pools are written IN PLACE as ``paged_kv_write_chunk`` writes
        them (its slots computed once for every layer); ``attn``
        replaces the attention as in :meth:`ragged_chunk` (default:
        :func:`paged_attention`, K6, on the card). Returns (logits
        [b, g, V], kpages, vpages)."""
        b, g = toks.shape
        rows, slots = _chunk_slots(kpages, block_tables, pos)
        lg = self._forward(
            w, toks.reshape(-1), pos.reshape(-1), kpages, vpages, rows,
            slots, _chunk_attend(kpages, vpages, block_tables, pos,
                                 self.head_dim, attn))
        return lg.reshape(b, g, -1), kpages, vpages


class LlamaDecodeAdapter:
    """RMSNorm + rope + GQA + SwiGLU decoder (llama.py LlamaForCausalLM):
    weights as a plain dict of tensors plus the step functions the
    serving engine calls."""

    def __init__(self, model):
        cfg = model.config
        self.num_layers = cfg.num_layers
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.rms_norm_eps
        self.rope_base = cfg.rope_base
        self.vocab_size = cfg.vocab_size
        self.max_positions = cfg.max_position_embeddings
        mdl = model.llama
        layers = []
        for blk in mdl.layers:
            att, mlp = blk.self_attn, blk.mlp
            layers.append({
                "in_ln": blk.input_layernorm.weight.detach(),
                "q_w": att.q_proj.weight.detach(),
                "k_w": att.k_proj.weight.detach(),
                "v_w": att.v_proj.weight.detach(),
                "o_w": att.o_proj.weight.detach(),
                "post_ln": blk.post_attention_layernorm.weight.detach(),
                "gate_w": mlp.gate_proj.weight.detach(),
                "up_w": mlp.up_proj.weight.detach(),
                "down_w": mlp.down_proj.weight.detach(),
            })
        head = None if model.lm_head is None else \
            model.lm_head.weight.detach()
        self.weights = {
            "wte": mdl.embed_tokens.weight.detach(),
            "norm": mdl.norm.weight.detach(),
            "layers": layers, "lm_head": head,
        }
        self.dtype = self.weights["wte"].dtype

    def logits(self, w, x, h=None):
        """Logits of the residual stream ``x``; ``h`` is its final norm
        when the caller has it (fused into the last residual update)."""
        x = _rms(x, w["norm"], self.eps) if h is None else h
        head = w["lm_head"]
        if head is None:
            return x @ w["wte"].T
        return _linear(x, head)

    def _qkv(self, W, h):
        """q [T, nh, hd], k and v [T, kvh, hd] from the layer's normed
        input h."""
        nh, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        T = h.shape[0]
        return (_linear(h, W["q_w"]).reshape(T, nh, hd),
                _linear(h, W["k_w"]).reshape(T, kvh, hd),
                _linear(h, W["v_w"]).reshape(T, kvh, hd))

    def _forward(self, w, toks, pos, kpages, vpages, rows, slots, attend):
        """The decoder over a flat token axis, as
        :meth:`GPTDecodeAdapter._forward`; rope rotates each token by its
        absolute position (padding tokens, pos < 0, by 0)."""
        nh, hd, dt = self.num_heads, self.head_dim, self.dtype
        T = toks.shape[0]
        x = w["wte"][toks.long()].to(dt)
        cos, sin = _rope_angles(pos.clamp_min(0), hd, self.rope_base)
        layers = w["layers"]
        # each residual update is fused with the norm after it: post_ln,
        # the next layer's in_ln, or the final norm after the last layer
        h = _rms(x, layers[0]["in_ln"], self.eps) if layers else None
        for i, W in enumerate(layers):
            q, k, v = self._qkv(W, h)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)
            kv_scatter(kpages[i], k, rows, slots)
            kv_scatter(vpages[i], v, rows, slots)
            att = attend(i, q)
            h, x = _add_rms(_linear(att.reshape(T, nh * hd), W["o_w"]), x,
                            W["post_ln"], self.eps)
            m = F.silu(_linear(h, W["gate_w"])) * _linear(h, W["up_w"])
            nw = layers[i + 1]["in_ln"] if i + 1 < len(layers) \
                else w["norm"]
            h, x = _add_rms(_linear(m, W["down_w"]), x, nw, self.eps)
        return self.logits(w, x, h)

    @torch.no_grad()
    def ragged_chunk(self, w, toks, pos, row_of, q_starts, query_lens,
                     context_lens, kpages, vpages, block_tables,
                     attn: Optional[Callable] = None):
        """ONE ragged mixed prefill+decode step over paged pools, as
        :meth:`GPTDecodeAdapter.ragged_chunk` (same arguments, same
        return). GQA pools carry ``num_kv_heads`` panels; rope rotates
        each token by its absolute position (padding tokens, pos < 0,
        by 0: their writes are dropped and their outputs ignored)."""
        rows, slots = _ragged_slots(kpages, block_tables, row_of, pos)
        lg = self._forward(
            w, toks, pos, kpages, vpages, rows, slots,
            lambda i, q: _ragged_attn(q, kpages[i], vpages[i], block_tables,
                                      context_lens, query_lens, q_starts,
                                      row_of, self.head_dim, attn))
        return lg, kpages, vpages

    @torch.no_grad()
    def paged_chunk(self, w, toks, pos, kpages, vpages, block_tables,
                    attn: Optional[Callable] = None):
        """g tokens at per-row positions over PAGED pools, as
        :meth:`GPTDecodeAdapter.paged_chunk` (same arguments, same
        return); GQA pools carry ``num_kv_heads`` panels and rope rotates
        by the per-row positions."""
        b, g = toks.shape
        rows, slots = _chunk_slots(kpages, block_tables, pos)
        lg = self._forward(
            w, toks.reshape(-1), pos.reshape(-1), kpages, vpages, rows,
            slots, _chunk_attend(kpages, vpages, block_tables, pos,
                                 self.head_dim, attn))
        return lg.reshape(b, g, -1), kpages, vpages


def _ragged_slots(kpages, block_tables, row_of, pos):
    """Where a ragged step's k/v rows land (:func:`kv_write_slots` over
    each token's row's block table): the same in every layer."""
    n_rows = block_tables.shape[0]
    _, total_pages, page, _ = pool_shape(kpages[0])
    bt_tok = block_tables[row_of.clamp(0, n_rows - 1).long()]
    return kv_write_slots(bt_tok, pos[:, None], page, total_pages)


def _chunk_slots(kpages, block_tables, pos):
    """Where a [b, g] chunk's k/v rows land: the same in every layer."""
    _, total_pages, page, _ = pool_shape(kpages[0])
    return kv_write_slots(block_tables, pos, page, total_pages)


def _chunk_attend(kpages, vpages, block_tables, pos, hd, attn):
    """``attend(layer, q [b*g, nh, hd])`` of a [b, g] chunk: its
    attention over the layer's pools by :func:`_paged_attn_chunk`."""
    b, g = pos.shape

    def attend(i, q):
        out = _paged_attn_chunk(q.reshape((b, g) + tuple(q.shape[1:])),
                                kpages[i], vpages[i], block_tables, pos, hd,
                                attn)
        return out.reshape(q.shape)

    return attend


def _ragged_attn(q, kpages, vpages, block_tables, context_lens,
                 query_lens, q_starts, row_of, hd, attn=None):
    """Ragged mixed prefill+decode attention over PAGED pools for the
    serving engine: q [T, nh, hd] flat token axis, per-row spans as in
    :func:`ragged_paged_attention`. On the card that launches the Hopper
    kernel (K4 over fp pools, K5 over int8 pools); CPU tensors take its
    plain version. ``attn`` replaces the function."""
    if attn is not None:
        fn = attn
    elif q.device.type == "cpu":
        fn = ragged_paged_attention_ref
    else:
        fn = ragged_paged_attention
    return fn(q.contiguous(), kpages, vpages, block_tables, context_lens,
              query_lens, q_starts=q_starts, row_of=row_of,
              scale=hd ** -0.5)


def _paged_attn_chunk(q, kpages, vpages, block_tables, pos, hd, attn=None):
    """Chunked causal attention over PAGED pools for the two-program
    serving layout (the JAX ``_paged_attn_chunk``): q [b, g, nh, hd] at
    per-row positions pos [b, g] attends to page slots 0..pos (the
    chunk's own rows were written before this call, so within-chunk
    causality falls out of each query's length). The b*g queries become
    rows of one :func:`paged_attention` call with ``lens = max(pos + 1,
    0)`` and the row's block table each; ``pos < 0`` rows (inactive
    slots, prefill padding) come back as zeros. On the card that
    launches K6 (over fp or int8 pools); CPU tensors take its plain
    version. ``attn`` replaces the function."""
    if attn is not None:
        fn = attn
    elif q.device.type == "cpu":
        fn = paged_attention_ref
    else:
        fn = paged_attention
    b, g, nh, _ = q.shape
    lens = (pos + 1).clamp_min(0).reshape(b * g).to(torch.int32)
    # each row's table once a query, as its own contiguous copy (K6 reads
    # the tables by raw pointer)
    bt = block_tables.repeat_interleave(g, dim=0)
    out = fn(q.reshape(b * g, nh, hd).contiguous(), kpages, vpages, bt,
             lens, scale=hd ** -0.5)
    return out.reshape(b, g, nh, hd)


Number = Union[int, float]


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: Union[Number, torch.Tensor],
            top_p: Union[Number, torch.Tensor, None]) -> torch.Tensor:
    """Greedy / temperature / nucleus sampling over [b, V] logits.

    ``temperature`` and ``top_p`` accept Python scalars (whole batch) OR
    per-row tensors [b] for mixed-request serving batches: each row
    scales by its own temperature, filters by its own nucleus
    (``top_p >= 1`` keeps the full distribution), and rows with
    ``temperature == 0`` take the greedy lane. Draws come from
    ``generator`` (the serving engine's), so a seeded engine is
    reproducible. Returns int32 token ids [b]."""
    per_row_t = isinstance(temperature, torch.Tensor)
    per_row_p = isinstance(top_p, torch.Tensor)
    if not per_row_t and temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if per_row_t:
        t = temperature.float().clamp_min(1e-6)
        lg = logits.float() / t[..., None]
    else:
        lg = logits.float() / max(temperature, 1e-6)
    if top_p is not None:
        probs = torch.softmax(lg, dim=-1)
        sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
        cum = torch.cumsum(sorted_p, dim=-1)
        tp = top_p.float()[..., None] if per_row_p else top_p
        keep = (cum - sorted_p) < tp
        filt = torch.where(keep, sorted_p, 0.0).clamp_min(1e-30)
        draw = torch.multinomial(filt, 1, generator=generator)
        sampled = torch.gather(sort_idx, -1, draw)[..., 0]
    else:
        sampled = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                    generator=generator)[..., 0]
    sampled = sampled.to(torch.int32)
    if per_row_t:
        greedy = logits.argmax(dim=-1).to(torch.int32)
        return torch.where(temperature == 0.0, greedy, sampled)
    return sampled
