"""Autoregressive decoding: whole generations, beam search, speculative
decoding, and the serving steps over paged KV pools.

Port of ``paddle_tpu/models/generation.py``. The model-generic engine:
each CausalLM's ``decode_adapter()`` gives a ``GPTDecodeAdapter`` or
``LlamaDecodeAdapter`` (the weights as a plain dict of tensors plus pure
step functions of tensors), and this module drives them:

* :func:`generate` (greedy / temperature / nucleus sampling),
  :func:`beam_search` (parent pointers resolved by a ``gather_tree``
  backtrace) and :func:`speculative_generate` (a draft model or the
  target's first layers propose, the target verifies a chunk in one pass,
  per-row acceptance), over a dense head-major KV cache ``[b, nh, total,
  hd]`` (int8 ``{"q8", "s"}`` with ``kv_cache_quant="int8"``) through the
  adapters' ``prefill``, ``step`` and ``chunk_step``;
* weight-only int8 (per channel) and int4 (group-wise, the codes kept as
  int8 values in [-7, 7]) through ``weight_quant``;
* the serving engine's ``ragged_chunk`` (one ragged mixed prefill +
  decode step over fp or int8 pools) and ``paged_chunk`` (g tokens at
  per-row positions: the engine's two-program ``ragged="off"`` layout).

On the card every norm is the Hopper row-norm kernel K7 (``_ln``,
``_rms``, and the residual updates fused with the norm after them,
``_add_ln`` / ``_add_rms``), a prefill's causal attention is the flash
kernel K1 (:func:`_causal_prefill_attn`), the serving steps' attention
K4 / K5 (``_ragged_attn``) or K6 (``_paged_attn_chunk``); the decode
step's and the chunk's attention over the dense cache (:func:`_masked_sdpa`,
:func:`_chunk_sdpa`) are plain PyTorch, as the JAX package computes them
outside any Pallas kernel. PyTorch runs eagerly, so there is no jit: the
caches and pools are written in place and the decode loop is a Python
loop whose per-token state (position, tokens, live rows) stays on the
device. CPU tensors take every kernel's plain version.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core import random as _random
from ..incubate.nn.cuda.moe_dispatch import _top_k
from ..incubate.nn.cuda.paged_attention import (
    _const, _quantize_rows, kv_scatter, kv_write_slots, paged_attention,
    paged_attention_ref, pool_shape, ragged_paged_attention,
    ragged_paged_attention_ref)
from ..incubate.nn.functional.flash_attention import \
    scaled_dot_product_attention
from ..incubate.nn.functional.fused_ops import (
    fused_layer_norm, fused_rms_norm, layer_norm, rms_norm)

__all__ = ["generate", "beam_search", "speculative_generate",
           "GPTDecodeAdapter", "LlamaDecodeAdapter"]


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


# ------------------------------------------------------------ weight quant
def _linear(x, w, b=None):
    """``x @ w (+ b)`` for an fp weight or a weight-only quantized one:
    int4 ``{"q4": [G, gs, out] codes, "s4": [G, out]}`` contracts each
    input group with its codes and then the groups with their scales;
    int8 ``{"q8": [in, out], "s": [1, out]}`` scales the product's
    columns. The codes are cast to x's type for the product (on the card
    a copy of the weight in x's type a call, where XLA fuses the convert
    into the operand read)."""
    if isinstance(w, dict) and "q4" in w:
        G, gs, _ = w["q4"].shape
        xg = x.reshape(x.shape[:-1] + (G, gs))
        z = torch.einsum("...gi,gio->...go", xg, w["q4"].to(x.dtype))
        # einsum's batched products may leave y in another layout; the
        # kernels after it (K1, K7) take contiguous rows
        y = torch.einsum("...go,go->...o", z,
                         w["s4"].to(x.dtype)).contiguous()
    elif isinstance(w, dict) and "q8" in w:
        y = (x @ w["q8"].to(x.dtype)) * w["s"].to(x.dtype)
    else:
        y = x @ w
    return y if b is None else y + b


def _quantize_w(w):
    """Per-output-channel symmetric int8 for a [in, out] matmul weight.
    The divisors are 0-d tensors on w's device (see
    :func:`_quantize_rows`), so the codes are the CPU's and JAX's."""
    wf = w.float()
    s = (wf.abs().amax(0, keepdim=True) / _const(127.0, w.device)) \
        .clamp_min(1e-8)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {"q8": q, "s": s}


def _quantize_w4(w, group=128):
    """Group-wise symmetric int4 for a [in, out] matmul weight: scales
    per (input group, output channel), computed in f32 and stored in
    bf16; the codes in [-7, 7] stored as int8 (the JAX ``q4i8`` layout).
    A ragged in-dim falls back to int8."""
    din, dout = w.shape
    if din % group != 0:
        return _quantize_w(w)
    wg = w.float().reshape(din // group, group, dout)
    s = (wg.abs().amax(1) / _const(7.0, w.device)).clamp_min(1e-8)
    q = torch.round(wg / s[:, None, :]).clamp(-7, 7).to(torch.int8)
    return {"q4i8": q, "s4": s.to(torch.bfloat16)}


def _activate_q4(w):
    """The tree with each stored ``q4i8`` leaf as the ``q4`` leaf that
    :func:`_linear` contracts (the JAX package converts the codes to
    ``jnp.int4`` here; the port keeps them as int8 values, which no
    kernel of the port reads packed yet)."""
    if isinstance(w, dict):
        if "q4i8" in w:
            return {"q4": w["q4i8"], "s4": w["s4"]}
        return {k: _activate_q4(v) for k, v in w.items()}
    if isinstance(w, list):
        return [_activate_q4(v) for v in w]
    return w


_QUANT_SKIP = {"wte", "wpe"}  # embedding gathers stay full precision


def _quantized_weights(model, w_now, bits=8):
    """Per-model cached quantized weight tree (shared by generate /
    speculative target / speculative draft / beam search). Re-quantize
    after a weight update by clearing ``model._gen_quant_w`` /
    ``_gen_quant_w4``."""
    attr = "_gen_quant_w" if bits == 8 else "_gen_quant_w4"
    qw = getattr(model, attr, None)
    if qw is None:
        if w_now.get("lm_head") is None:
            w_now = dict(w_now)
            w_now["lm_head"] = w_now["wte"].T
        qw = _quantize_tree(w_now, bits=bits)
        setattr(model, attr, qw)
    return qw


def _resolve_weight_quant(model, w_now, weight_quant):
    if weight_quant is None:
        return w_now
    if weight_quant == "int8":
        return _quantized_weights(model, w_now, bits=8)
    if weight_quant == "int4":
        return _quantized_weights(model, w_now, bits=4)
    raise ValueError("weight_quant must be None, 'int8' or 'int4'")


def _quantize_tree(w, min_dim=256, bits=8):
    """Walk an adapter weight tree, replacing 2-D matmul weights whose
    both dims are at least ``min_dim`` with int8 (or group-wise int4)
    quant dicts. In int4 mode the lm_head stays int8: the argmax over
    the vocab is the decode's most quantization-sensitive product."""
    if isinstance(w, dict):
        out = {}
        for k, v in w.items():
            if k in _QUANT_SKIP:
                out[k] = v
            elif isinstance(v, (dict, list)):
                out[k] = _quantize_tree(v, min_dim, bits)
            elif isinstance(v, torch.Tensor) and v.dim() == 2 \
                    and min(v.shape) >= min_dim:
                out[k] = _quantize_w4(v) if bits == 4 and k != "lm_head" \
                    else _quantize_w(v)
            else:
                out[k] = v
        return out
    if isinstance(w, list):
        return [_quantize_tree(v, min_dim, bits) for v in w]
    return w


# ------------------------------------------------------------ dense KV cache
# Head-major [b, nh, total, hd] (int8: codes [b, nh, total, hd], f32
# scales [b, nh, total]), written in place.

def _quantize_kv(k):
    """Per-(position, head) symmetric int8 for a [..., nh, hd] K or V
    slab: each row's scale rides with it, so the read side is exact."""
    q, s = _quantize_rows(k)
    return {"q8": q, "s": s}


def _kv_prefill_store(k, b, total, plen, dt, quant):
    """A [b, nh, total, hd] cache holding the prefill rows k [b, plen,
    nh, hd] at positions 0..plen-1 (zeros after)."""
    nh, hd = k.shape[-2], k.shape[-1]
    k = k.transpose(1, 2)                           # [b, nh, plen, hd]
    if not quant:
        cache = torch.zeros(b, nh, total, hd, dtype=dt, device=k.device)
        cache[:, :, :plen] = k
        return cache
    qk = _quantize_kv(k)
    cache = {"q8": torch.zeros(b, nh, total, hd, dtype=torch.int8,
                               device=k.device),
             "s": torch.zeros(b, nh, total, dtype=torch.float32,
                              device=k.device)}
    cache["q8"][:, :, :plen] = qk["q8"]
    cache["s"][:, :, :plen] = qk["s"]
    return cache


def _kv_write(cache, k, pos):
    """Write one decode row k [b, nh, hd] at position ``pos`` (a 0-d
    int64 tensor), in place."""
    at = pos.reshape(1)
    if not isinstance(cache, dict):
        cache.index_copy_(2, at, k[:, :, None].to(cache.dtype))
        return cache
    qk = _quantize_kv(k)
    cache["q8"].index_copy_(2, at, qk["q8"][:, :, None])
    cache["s"].index_copy_(2, at, qk["s"][:, :, None])
    return cache


def _drop_plan(pos, T):
    """Where a [b, g] write at positions ``pos`` lands in T slots,
    dropping the positions at or past T as the JAX scatter's
    ``mode="drop"`` does, with no read on the host: ``(bidx, at, src,
    any_kept)``. A dropped entry writes again one kept entry of its row
    (the same slot, the same value: ``src`` names it), and a row with
    none kept (``any_kept`` False) writes slot T - 1's own value back.
    The same for every layer and leaf of a step."""
    b, g = pos.shape
    keep = pos < T
    col = torch.arange(g, device=pos.device).expand(b, g)
    last = torch.where(keep, col, -1).amax(1, keepdim=True)     # [b, 1]
    src = torch.where(keep, col, last.clamp_min(0))
    any_kept = last >= 0
    at = torch.where(any_kept, pos.gather(1, src), T - 1).long()
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, g)
    return bidx, at, src, any_kept


def _put_rows(dst, rows, plan):
    """``dst[r, :, pos[r, j]] = rows[r, j]`` for dst ``[b, nh, T, ...]``
    and rows ``[b, g, nh, ...]``, by the :func:`_drop_plan` of ``pos``."""
    bidx, at, src, any_kept = plan
    b, g = src.shape
    ones = (1,) * (rows.dim() - 2)
    vals = torch.take_along_dim(rows, src.reshape((b, g) + ones), dim=1)
    vals = torch.where(any_kept.reshape((b, 1) + ones), vals,
                       dst[:, :, -1][:, None])
    dst[bidx, :, at] = vals.to(dst.dtype)


def _kv_write_rows(cache, k, pos, plan=None):
    """Write g rows k [b, g, nh, hd] at per-row positions pos [b, g]
    (speculative verify writes land at different offsets per sequence),
    in place. Positions at or past the cache's end (finished rows still
    looping) are dropped; ``plan``, the :func:`_drop_plan` of ``pos``,
    may be given (a step computes it once for every layer)."""
    leaf = cache["q8"] if isinstance(cache, dict) else cache
    if plan is None:
        plan = _drop_plan(pos, leaf.shape[2])
    if not isinstance(cache, dict):
        _put_rows(cache, k, plan)
        return cache
    qk = _quantize_kv(k)
    _put_rows(cache["q8"], qk["q8"], plan)
    _put_rows(cache["s"], qk["s"], plan)
    return cache


def _kv_repeat(cache, rep):
    """GQA head replication for either cache representation."""
    if rep <= 1:
        return cache
    if not isinstance(cache, dict):
        return cache.repeat_interleave(rep, dim=1)
    return {"q8": cache["q8"].repeat_interleave(rep, dim=1),
            "s": cache["s"].repeat_interleave(rep, dim=1)}


# ------------------------------------------------------------ adapters
class GPTDecodeAdapter:
    """Learned-position GPT decoder (gpt.py GPTForCausalLM): weights as
    a plain dict of tensors plus the pure step functions that
    :func:`generate`, :func:`beam_search`, :func:`speculative_generate`
    and the serving engine call."""

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
        """Logits of the residual stream ``x`` (a view such as the
        prefill's last row too); ``h`` is its final norm when the caller
        has it (fused into the last residual update)."""
        x = _ln(x.contiguous(), w["lnf_w"], w["lnf_b"], self.eps) \
            if h is None else h
        head = w["lm_head"]
        if head is None:
            return x @ w["wte"].T
        return _linear(x, head)

    def _forward(self, w, toks, pos, attend, final=True):
        """The decoder over a flat token axis: ``toks``, ``pos [T]``
        (``pos < 0``: padding, embedded at position 0); each layer hands
        its q [T, nh, hd], k and v to ``attend(layer, q, k, v)``, which
        writes k / v where they belong and returns the attention (any
        shape of T * nh * hd elements). Returns ``(x, h)``: the residual
        stream and, with ``final``, its final norm (fused into the last
        residual update; else None and the last update is two adds)."""
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
            att = attend(i, qkv[:, 0], qkv[:, 1], qkv[:, 2])
            h, x = _add_ln(_linear(att.reshape(T, nh * hd), W["out_w"]),
                           W["out_b"], x, W["ln2_w"], W["ln2_b"], self.eps)
            m = F.gelu(_linear(h, W["fc1_w"], W["fc1_b"]),
                       approximate="tanh")
            y = _linear(m, W["fc2_w"])
            if i + 1 < len(layers) or final:
                nw, nb = (layers[i + 1]["ln1_w"], layers[i + 1]["ln1_b"]) \
                    if i + 1 < len(layers) else (w["lnf_w"], w["lnf_b"])
                h, x = _add_ln(y, W["fc2_b"], x, nw, nb, self.eps)
            else:
                h, x = None, x + (y if W["fc2_b"] is None
                                  else y + W["fc2_b"])
        return x, h

    @torch.no_grad()
    def prefill(self, w, ids, total, kv_quant=False):
        """The prompt ``ids [b, plen]`` through every layer, causal
        attention through :func:`_causal_prefill_attn` (K1 on the card).
        Returns ``(x [b, plen, h], ck, cv)``: the residual stream (before
        the final norm) and per-layer caches of ``total`` positions."""
        b, plen = ids.shape
        pos = torch.arange(plen, device=ids.device).repeat(b)
        ck, cv = [], []

        def attend(i, q, k, v):
            q, k, v = (t.reshape((b, plen) + t.shape[1:]) for t in (q, k, v))
            ck.append(_kv_prefill_store(k, b, total, plen, self.dtype,
                                        kv_quant))
            cv.append(_kv_prefill_store(v, b, total, plen, self.dtype,
                                        kv_quant))
            return _causal_prefill_attn(q, k, v, self.head_dim)

        x, _ = self._forward(w, ids.reshape(-1), pos, attend, final=False)
        return x.reshape(b, plen, -1), tuple(ck), tuple(cv)

    @torch.no_grad()
    def step(self, w, tok, pos, ck, cv, t_mask):
        """One token a row, ``tok [b]``, at position ``pos`` (an int or a
        0-d int64 tensor) over the caches (written in place), attending
        to the slots ``t_mask [total]`` allows. Returns (logits [b, V],
        ck, cv)."""
        b = tok.shape[0]
        pos = torch.as_tensor(pos, device=tok.device)
        lg = self._decode(w, tok, pos.expand(b), ck, cv,
                          lambda q, kc, vc: _masked_sdpa(
                              q, kc, vc, t_mask, self.head_dim),
                          lambda c, k: _kv_write(c, k, pos))
        return lg, ck, cv

    @torch.no_grad()
    def chunk_step(self, w, toks, pos, ck, cv):
        """g tokens at per-row positions in one pass (speculative draft
        and verify). toks, pos [b, g]; returns (logits [b, g, V], ck, cv)
        where slot j reflects the prefix through toks[:, j]."""
        b, g = toks.shape

        def attn(q, kc, vc):
            out = _chunk_sdpa(q.reshape((b, g) + q.shape[1:]), kc, vc, pos,
                              self.head_dim)
            return out.reshape(q.shape)

        leaf = ck[0]["q8"] if isinstance(ck[0], dict) else ck[0]
        plan = _drop_plan(pos, leaf.shape[2])

        def write(c, k):
            return _kv_write_rows(c, k.reshape((b, g) + k.shape[1:]), pos,
                                  plan)

        lg = self._decode(w, toks.reshape(-1), pos.reshape(-1), ck, cv,
                          attn, write)
        return lg.reshape(b, g, -1), ck, cv

    def _decode(self, w, toks, pos, ck, cv, attn, write):
        """Logits of a decode pass over the dense caches: each layer
        writes its k / v rows by ``write(cache, rows)``, then ``attn(q,
        k cache, v cache)`` over the caches, GQA heads repeated."""
        rep = self.num_heads // self.num_kv_heads

        def attend(i, q, k, v):
            write(ck[i], k)
            write(cv[i], v)
            return attn(q, _kv_repeat(ck[i], rep), _kv_repeat(cv[i], rep))

        return self.logits(w, *self._forward(w, toks, pos, attend))

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
        lg = self.logits(w, *self._forward(
            w, toks, pos, _paged_attend(
                kpages, vpages, rows, slots,
                lambda i, q: _ragged_attn(q, kpages[i], vpages[i],
                                          block_tables, context_lens,
                                          query_lens, q_starts, row_of,
                                          self.head_dim, attn))))
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
        lg = self.logits(w, *self._forward(
            w, toks.reshape(-1), pos.reshape(-1), _paged_attend(
                kpages, vpages, rows, slots,
                _chunk_attend(kpages, vpages, block_tables, pos,
                              self.head_dim, attn))))
        return lg.reshape(b, g, -1), kpages, vpages


class LlamaDecodeAdapter(GPTDecodeAdapter):
    """RMSNorm + rope + GQA + SwiGLU decoder (llama.py LlamaForCausalLM):
    weights as a plain dict of tensors plus the same step functions as
    :class:`GPTDecodeAdapter` (rope rotates each token by its absolute
    position; GQA caches and pools carry ``num_kv_heads`` panels)."""

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
        """Logits of the residual stream ``x`` (a view such as the
        prefill's last row too); ``h`` is its final norm when the caller
        has it (fused into the last residual update)."""
        x = _rms(x.contiguous(), w["norm"], self.eps) if h is None else h
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

    def _forward(self, w, toks, pos, attend, final=True):
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
            att = attend(i, _rope(q, cos, sin), _rope(k, cos, sin), v)
            h, x = _add_rms(_linear(att.reshape(T, nh * hd), W["o_w"]), x,
                            W["post_ln"], self.eps)
            m = F.silu(_linear(h, W["gate_w"])) * _linear(h, W["up_w"])
            y = _linear(m, W["down_w"])
            if i + 1 < len(layers) or final:
                nw = layers[i + 1]["in_ln"] if i + 1 < len(layers) \
                    else w["norm"]
                h, x = _add_rms(y, x, nw, self.eps)
            else:
                h, x = None, x + y
        return x, h


def _paged_attend(kpages, vpages, rows, slots, attend):
    """``attend(layer, q, k, v)`` of a serving step: the layer's k / v
    rows ``rows`` into its pools at the flat ``slots`` (in place), then
    ``attend(layer, q)`` over the pools."""
    def fn(i, q, k, v):
        kv_scatter(kpages[i], k, rows, slots)
        kv_scatter(vpages[i], v, rows, slots)
        return attend(i, q)
    return fn


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


# ------------------------------------------------------------ dense attention
def _chunk_sdpa(q, ck, cv, pos, hd):
    """Chunked causal attention over the cache for speculative verify:
    q [b, g, nh, hd] at per-row positions pos [b, g] attends to every
    cache slot t <= pos[b, g] (the chunk's own k/v were written before
    this call, so within-chunk causality falls out of the position
    mask). f32 scores; int8 caches as in :func:`_masked_sdpa`."""
    T = ck["q8"].shape[2] if isinstance(ck, dict) else ck.shape[2]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]                      # [b,1,g,T]
    if isinstance(ck, dict):
        sc = torch.einsum("bghd,bhtd->bhgt", q.float(), ck["q8"].float())
        sc = sc * ck["s"][:, :, None, :] * (hd ** -0.5)
        sc = torch.where(mask, sc, -1e30)
        w = torch.softmax(sc, dim=-1)
        wv = (w * cv["s"][:, :, None, :]).to(q.dtype)
        return torch.einsum("bhgt,bhtd->bghd", wv, cv["q8"].to(q.dtype))
    sc = torch.einsum("bghd,bhtd->bhgt", q.float(), ck.float()) \
        * (hd ** -0.5)
    sc = torch.where(mask, sc, -1e30)
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhgt,bhtd->bghd", w, cv)


def _causal_prefill_attn(q, k, v, hd):
    """Full-prompt causal attention shared by the adapters' prefill: q
    [b, plen, nh, hd], k / v [b, plen, kvh, hd] -> [b, plen, nh * hd].
    The JAX composition (f32 scores, the causal mask, softmax cast to the
    value type) is the function of the functional layer's causal
    attention: K1 on the card, that composition on the CPU."""
    b, plen = q.shape[0], q.shape[1]
    out = scaled_dot_product_attention(q, k, v, is_causal=True,
                                       training=False)
    return out.reshape(b, plen, -1)


def _masked_sdpa(q, ck, cv, t_mask, hd):
    """Masked single-query attention over the cache (the
    masked_multihead_attention analog): q [b, nh, hd] against the whole
    cache [b, nh, T, hd], slots outside ``t_mask [T]`` masked; f32
    scores.

    int8 caches arrive as {"q8": [b,nh,T,hd] int8, "s": [b,nh,T] f32};
    the per-row scales, constant over the head dim, are applied on the
    score side (exact: scores_bht = s_bht * <q, q8>) and folded into the
    softmax weights for the V contraction."""
    if isinstance(ck, dict):
        scores = torch.einsum("bhd,bhtd->bht", q.float(), ck["q8"].float())
        scores = scores * ck["s"] * (hd ** -0.5)
        scores = torch.where(t_mask[None, None, :], scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        wv = (w * cv["s"]).to(q.dtype)
        return torch.einsum("bht,bhtd->bhd", wv, cv["q8"].to(q.dtype))
    scores = torch.einsum("bhd,bhtd->bht", q.float(), ck.float()) \
        * (hd ** -0.5)
    scores = torch.where(t_mask[None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bht,bhtd->bhd", w, cv)


# ------------------------------------------------------------ sampling
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
    ``generator`` (the serving engine's, or the device's generator of
    :mod:`paddle_tpu_torch.core.random` in :func:`generate`), so a seeded
    run is reproducible. Returns int32 token ids [b]."""
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


# ------------------------------------------------------------ entry points
def _check_window(ad, plen, max_new_tokens):
    total = plen + max_new_tokens
    if ad.max_positions is not None and total > ad.max_positions:
        raise ValueError(
            f"prompt length {plen} + max_new_tokens {max_new_tokens} = "
            f"{total} exceeds max_position_embeddings {ad.max_positions}; "
            "XLA would silently clamp position gathers past the window")
    return total


def _as_ids(input_ids, device):
    """int32 ids [b, plen] on ``device`` from a tensor or anything numpy
    reads."""
    ids = input_ids if isinstance(input_ids, torch.Tensor) else \
        torch.as_tensor(np.asarray(input_ids))
    return ids.to(device=device, dtype=torch.int32)


def _prepare(model, input_ids, window, weight_quant):
    """``(adapter, ids, total, weights)`` of a generation over ``window``
    positions past the prompt: the weights quantized as asked (cached on
    the model) with their int4 leaves activated."""
    ad = model.decode_adapter()
    # the model's device: where its generation runs
    ids = _as_ids(input_ids, next(model.parameters()).device)
    total = _check_window(ad, ids.shape[1], window)
    w = _resolve_weight_quant(model, ad.weights, weight_quant)
    return ad, ids, total, _activate_q4(w)


def _check_kv_quant(kv_cache_quant):
    if kv_cache_quant not in (None, "int8"):
        raise ValueError("kv_cache_quant must be None or 'int8'")
    return kv_cache_quant == "int8"


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, weight_quant=None,
             kv_cache_quant=None, name=None):
    """Greedy / temperature / nucleus decoding for any model exposing
    ``decode_adapter()``, on the model's device.

    Returns the generated token ids [batch, max_new_tokens] (int32,
    prompt not included): the prefill's token, then ``max_new_tokens -
    1`` decode steps, every one run (no early exit: tokens after
    ``eos_token_id`` are clamped to eos). ``temperature=0`` is greedy;
    draws come from the device's generator of
    :mod:`paddle_tpu_torch.core.random` (``paddle_tpu_torch.seed(n)``).
    ``weight_quant="int8"`` serves per-channel int8 weights; ``"int4"``
    group-wise int4 with an int8 lm_head. Quantized copies are cached on
    the model: re-quantize by clearing ``model._gen_quant_w`` /
    ``_gen_quant_w4`` after a weight update. ``kv_cache_quant="int8"``
    stores the KV cache as int8 with per-(position, head) scales
    computed at write time. The loop reads nothing back from the device
    (the position and the live rows stay there)."""
    kv_quant = _check_kv_quant(kv_cache_quant)
    ad, ids, total, w = _prepare(model, input_ids, max_new_tokens,
                                 weight_quant)
    b, plen = ids.shape
    dev = ids.device
    gen = _random.generator(dev)
    x, ck, cv = ad.prefill(w, ids, total, kv_quant=kv_quant)
    tok = _sample(ad.logits(w, x[:, -1]), gen, temperature, top_p)
    out = torch.empty(b, max_new_tokens, dtype=torch.int32, device=dev)
    out[:, 0] = tok
    alive = None if eos_token_id is None else tok != eos_token_id
    pos = torch.full((), plen, dtype=torch.int64, device=dev)
    slots = torch.arange(total, device=dev)
    for i in range(1, max_new_tokens):
        lg, ck, cv = ad.step(w, tok, pos, ck, cv, slots <= pos)
        tok = _sample(lg, gen, temperature, top_p)
        if eos_token_id is not None:
            tok = torch.where(alive, tok, eos_token_id)
            alive = alive & (tok != eos_token_id)
        out[:, i] = tok
        pos = pos + 1
    return out


@torch.no_grad()
def speculative_generate(model, input_ids, max_new_tokens: int = 32,
                         gamma: int = 4, draft_model=None,
                         draft_layers: Optional[int] = None,
                         eos_token_id: Optional[int] = None,
                         weight_quant=None, kv_cache_quant=None,
                         return_stats: bool = False):
    """Speculative greedy decoding.

    A cheap draft proposes ``gamma`` tokens autoregressively; the target
    verifies all of them in ONE chunked forward pass (one weight read
    for up to gamma+1 emitted tokens). Greedy acceptance makes the output
    the tokens of ``generate(..., temperature=0)``: a proposal is
    accepted iff it equals the target's argmax given the accepted prefix,
    and the first mismatch is replaced by the target's own token.
    Acceptance is tracked PER ROW: batch rows advance at their own rate
    through per-row cache and output pointers.

    Draft choices: ``draft_model`` (a smaller CausalLM sharing the
    vocab) or ``draft_layers=k`` (self-speculative early exit: the
    target's first k blocks + its final norm and head, no extra weights).
    With ``return_stats`` also returns ``{"iterations", "mean_accepted",
    "tokens_per_target_pass"}`` over the (row, iteration) pairs of rows
    still producing tokens."""
    if (draft_model is None) == (draft_layers is None):
        raise ValueError("pass exactly one of draft_model / draft_layers")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    kv_quant = _check_kv_quant(kv_cache_quant)
    # window slack: verify writes run up to gamma past the last commit
    window = max_new_tokens + 2 * gamma + 2
    ad, ids, total, w = _prepare(model, input_ids, window, weight_quant)
    b, plen = ids.shape
    dev = ids.device
    if draft_model is not None:
        dad = draft_model.decode_adapter()
        if dad.vocab_size != ad.vocab_size:
            raise ValueError("draft vocab must match the target's")
        # the draft decodes over the same window: a shorter draft
        # position range would silently clamp wpe/rope gathers and
        # quietly zero the acceptance rate
        _check_window(dad, plen, window)
        dw = _activate_q4(_resolve_weight_quant(draft_model, dad.weights,
                                                weight_quant))
    else:
        if not 0 < draft_layers < ad.num_layers:
            raise ValueError("draft_layers must be in (0, num_layers)")
        dad = ad
        dw = dict(w)
        dw["layers"] = list(w["layers"])[:draft_layers]

    W_out = max_new_tokens + gamma + 1
    x, ck, cv = ad.prefill(w, ids, total, kv_quant=kv_quant)
    _, dck, dcv = dad.prefill(dw, ids, total, kv_quant=kv_quant)
    cur = ad.logits(w, x[:, -1]).argmax(-1).to(torch.int32)      # [b]
    ptr = torch.zeros(b, dtype=torch.int64, device=dev)  # tokens committed
    ln = torch.full((b,), plen, dtype=torch.int64, device=dev)  # cache len
    out = torch.zeros(b, W_out, dtype=torch.int32, device=dev)
    n_iter = torch.zeros((), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.arange(gamma + 1, device=dev)
    # the loop's condition is one read of the device a round (the JAX
    # package keeps the whole loop on the device in a while_loop)
    while int(ptr.min()) < max_new_tokens:
        # the draft proposes gamma tokens (one-token chunk steps)
        tok, props = cur, []
        for j in range(gamma):
            lg, dck, dcv = dad.chunk_step(dw, tok[:, None],
                                          (ln + j)[:, None], dck, dcv)
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            props.append(tok)
        props = torch.stack(props, 1)                            # [b, g]
        # write the final proposal's kv so the draft cache stays complete
        # when every proposal is accepted
        _, dck, dcv = dad.chunk_step(dw, tok[:, None],
                                     (ln + gamma)[:, None], dck, dcv)
        # the target verifies the whole chunk in one pass
        chunk = torch.cat([cur[:, None], props], 1)
        lg, ck, cv = ad.chunk_step(w, chunk, ln[:, None] + steps, ck, cv)
        tgt = lg.argmax(-1).to(torch.int32)                      # [b, g+1]
        # longest accepted prefix: props[:, j] must equal the target
        # token after chunk[:, :j+1]
        match = (props == tgt[:, :gamma]).to(torch.int64)
        acc = torch.cumprod(match, 1).sum(1)                     # [b]
        # commit [cur, accepted...]: unaccepted tail slots are written
        # over next round (ptr advances 1 + acc); slots at or past W_out
        # (finished rows) are dropped
        _put_rows(out[:, None, :, None], chunk[:, :, None, None],
                  _drop_plan(ptr[:, None] + steps, W_out))
        # stats count only rows still producing real tokens: finished
        # rows loop on a frozen cache and would skew the mean
        active = (ptr < max_new_tokens).to(torch.int64)
        n_iter += active.sum()
        n_acc += (acc * active).sum()
        cur = tgt.gather(1, acc[:, None])[:, 0]
        ptr = ptr + 1 + acc
        ln = ln + 1 + acc
    toks = out[:, :max_new_tokens]
    if eos_token_id is not None:
        hit = (toks == eos_token_id).to(torch.int32)
        seen = torch.cumsum(hit, 1) - hit
        toks = torch.where(seen > 0, eos_token_id, toks)
    if return_stats:
        it, acc_sum = int(n_iter), int(n_acc)
        stats = {"iterations": it,
                 "mean_accepted": acc_sum / max(it, 1),
                 "tokens_per_target_pass": 1.0 + acc_sum / max(it, 1)}
        return toks, stats
    return toks


def _kv_rows(cache, idx_or_reps, gather):
    """Beam bookkeeping on either cache representation (every leaf is
    batch-major): a batch-axis gather (the parent-beam reorder) or a
    repeat (beam expansion)."""
    if isinstance(cache, dict):
        return {k: _kv_rows(v, idx_or_reps, gather) for k, v in cache.items()}
    if gather:
        return cache.index_select(0, idx_or_reps)
    return cache.repeat_interleave(idx_or_reps, dim=0)


def _gather_tree(ids, parents):
    """The beam-search backtrace (the JAX ``gather_tree``): ids / parents
    ``[T, b, K]`` -> each final beam's tokens ``[T, b, K]``, walking the
    parent pointers back from the last step."""
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(ids[t].gather(1, beams))
        beams = parents[t].gather(1, beams).long()
    return torch.stack(out[::-1])


@torch.no_grad()
def beam_search(model, input_ids, max_new_tokens: int = 32,
                num_beams: int = 4, length_penalty: float = 0.0,
                eos_token_id: Optional[int] = None, weight_quant=None,
                kv_cache_quant=None):
    """Beam search over the decode path, beams resolved by a
    ``gather_tree`` backtrace at the end; the same quant tiers as
    :func:`generate`. ``length_penalty`` divides each beam's score by
    its own length (frozen at eos) to that power. Returns the best
    beam's token ids [batch, max_new_tokens] (int32)."""
    kv_quant = _check_kv_quant(kv_cache_quant)
    ad, ids, total, w = _prepare(model, input_ids, max_new_tokens,
                                 weight_quant)
    b, plen = ids.shape
    dev = ids.device
    K, V = num_beams, ad.vocab_size
    x, ck, cv = ad.prefill(w, ids, total, kv_quant=kv_quant)
    lg0 = torch.log_softmax(ad.logits(w, x[:, -1]).float(), dim=-1)
    # seed the beams with the prompt's top-K continuations
    scores, tok = _top_k(lg0, K)                                 # [b, K]
    tok = tok.to(torch.int32)
    # one cache row per beam
    ck = [_kv_rows(c, K, gather=False) for c in ck]
    cv = [_kv_rows(c, K, gather=False) for c in cv]
    alive = torch.ones(b, K, dtype=torch.bool, device=dev) \
        if eos_token_id is None else tok != eos_token_id
    lens = torch.ones(b, K, dtype=torch.float32, device=dev)
    if eos_token_id is not None:
        eos_only = torch.full((V,), float("-inf"), device=dev)
        eos_only[eos_token_id] = 0.0
    toks = [tok]
    parents = [torch.arange(K, dtype=torch.int32, device=dev).expand(b, K)]
    pos = torch.full((), plen, dtype=torch.int64, device=dev)
    slots = torch.arange(total, device=dev)
    row0 = torch.arange(b, device=dev)[:, None] * K
    for _ in range(max_new_tokens - 1):
        lg, ck, cv = ad.step(w, tok.reshape(b * K), pos, ck, cv,
                             slots <= pos)
        logp = torch.log_softmax(lg.float(), dim=-1).reshape(b, K, V)
        # finished beams only extend with eos at zero cost
        if eos_token_id is not None:
            logp = torch.where(alive[..., None], logp, eos_only)
        cand = scores[..., None] + logp                          # [b, K, V]
        scores, idx = _top_k(cand.reshape(b, K * V), K)
        parent = idx // V
        tok = (idx % V).to(torch.int32)
        # reorder the caches by parent beam (per batch row)
        gidx = (row0 + parent).reshape(b * K)
        ck = [_kv_rows(c, gidx, gather=True) for c in ck]
        cv = [_kv_rows(c, gidx, gather=True) for c in cv]
        alive = alive.gather(1, parent)
        # a live beam grows by its new token (a fresh eos included)
        lens = lens.gather(1, parent) + alive.float()
        if eos_token_id is not None:
            alive = alive & (tok != eos_token_id)
        toks.append(tok)
        parents.append(parent.to(torch.int32))
        pos = pos + 1
    seqs = _gather_tree(torch.stack(toks), torch.stack(parents))  # [T,b,K]
    if length_penalty:
        # GNMT-style: each beam normalised by ITS OWN finished length
        scores = scores / (lens ** length_penalty)
    best = scores.argmax(1)                                      # [b]
    return seqs[:, torch.arange(b, device=dev), best].T.contiguous()
