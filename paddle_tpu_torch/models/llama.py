"""Llama-2 family decoder-only LM (GQA, RoPE, SwiGLU, RMSNorm), as
PyTorch modules.

Port of ``paddle_tpu/models/llama.py``. Parameters carry the JAX
package's names (``llama.layers.{i}.self_attn.q_proj.weight``, ...) and
keep Paddle's ``[in, out]`` linear layout, so a JAX model's
``state_dict`` maps onto this one by copy
(:func:`paddle_tpu_torch.convert.params_from_paddle_tpu`). Two paths:
the full-sequence ``forward`` (training: RMSNorm through the row-norm
kernel K7, RoPE, causal GQA attention through the flash-attention
kernels K1-K3, the JAX package's fused route for the residual add +
RMSNorm and the SwiGLU gate, an untied lm head and cross entropy,
chunked when ``lm_ce_chunks > 1``; with ``recompute`` every block runs
under ``torch.utils.checkpoint``; with ``caches`` from
:meth:`~LlamaForCausalLM.init_caches`, the incremental form, RoPE at each
token's absolute position), and decoding through
:meth:`LlamaForCausalLM.decode_adapter` (:meth:`~LlamaForCausalLM.generate`,
:meth:`~LlamaForCausalLM.beam_search`, the serving engine).

On a mesh (``jit.TrainStep(..., mesh=...)``) the layers are
tensor-parallel over ``mp``, to the JAX annotations: ``q/k/v`` and
``gate/up`` column-parallel, ``o_proj`` and ``down_proj`` row-parallel
(an all-reduce), ``embed_tokens`` vocab-parallel and the untied
``lm_head`` column-parallel over the vocabulary (the loss over logits
split over it, as GPT's). ``num_heads`` and ``num_kv_heads`` must divide
by ``mp``; head counts come from the local weights' shapes. On a mesh
with an ``sp`` axis, as GPT's: RoPE at global positions, attention by
``sequence_parallel_mode`` (ring and ulysses on K / V repeated to the
query heads first, as the JAX model repeats them; the gspmd gather on
the unrepeated ones), the loss over every ``dp`` and ``sp`` rank's
tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..distributed.auto_parallel.constraint import annotate_param
from ..distributed.sharding import copy_to, vocab_parallel_embedding
from ..fusion.chunked import lm_head_chunked_ce
from ..fusion.epilogues import add_rms_norm, swiglu_linear
from ..incubate.nn.functional import (fused_rotary_position_embedding,
                                      rms_norm, scaled_dot_product_attention)
from ._sp_attention import on_sp, sp_positions
from .gpt import Linear, head_chunks

__all__ = ["LlamaConfig", "LlamaForCausalLM", "cross_entropy", "llama_tiny",
           "llama2_7B"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    intermediate_size: Optional[int] = None  # None -> llama 8/3 rule
    max_position_embeddings: int = 4096
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # every block keeps only its input and runs its forward again in the
    # backward (torch.utils.checkpoint)
    recompute: bool = False
    # > 1: the lm head + cross entropy run in this many token chunks
    # (fusion/chunked.py)
    lm_ce_chunks: int = 0
    # "gspmd" | "ring" | "ulysses": attention over a mesh's sp axis
    # (models/_sp_attention.py)
    sequence_parallel_mode: str = "gspmd"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            m = int(8 * self.hidden_size / 3)
            self.intermediate_size = 256 * ((m + 255) // 256)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama_tiny(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=2,
                       max_position_embeddings=256, **kw)


def llama2_7B(**kw) -> LlamaConfig:
    return LlamaConfig(hidden_size=4096, num_layers=32, num_heads=32,
                       intermediate_size=11008, **kw)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis: f32 statistics, the result in x's
    type (K7 on the card; its backward is the plain version's vjp)."""

    def __init__(self, d: int, eps: float = 1e-6, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, **factory))

    def forward(self, x):
        return rms_norm(x, self.weight, None, self.eps)


class LlamaAttention(nn.Module):
    """The q/k/v/o projections (no biases), RoPE on q and k, causal
    attention; k and v have ``num_kv_heads`` heads, repeated over each
    group of query heads inside the attention (GQA). ``sp_group`` (on a
    mesh with an ``sp`` axis): see the module note."""

    mp_group = sp_group = None

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.q_proj = Linear(h, config.num_heads * hd, False, **factory)
        self.k_proj = Linear(h, config.num_kv_heads * hd, False, **factory)
        self.v_proj = Linear(h, config.num_kv_heads * hd, False, **factory)
        self.o_proj = Linear(config.num_heads * hd, h, False,
                             row_parallel=True, **factory)
        for lin in (self.q_proj, self.k_proj, self.v_proj):
            annotate_param(lin.weight, (None, "mp"))
        annotate_param(self.o_proj.weight, ("mp", None))

    def forward(self, x, position_ids=None, cache=None):
        cfg = self.config
        b, s, d = x.shape[0], x.shape[1], cfg.head_dim
        x = copy_to(x, self.mp_group)
        heads = self.q_proj.weight.shape[1] // d
        q = self.q_proj(x).reshape(b, s, heads, d)
        k = self.k_proj(x).reshape(b, s, -1, d)
        v = self.v_proj(x).reshape(b, s, -1, d)
        past = 0 if cache is None else cache[0].shape[1]
        if position_ids is None and past:
            # incremental decode: rotate by absolute position, not 0 (one
            # row of positions for the batch, as without a cache: its
            # tables broadcast, and q / k keep the layout K1 takes)
            position_ids = torch.arange(past, past + s,
                                        device=x.device)[None]
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, position_ids=position_ids,
            rotary_emb_base=cfg.rope_base)
        if cache is not None:
            k = torch.cat([cache[0], k], 1)
            v = torch.cat([cache[1], v], 1)
            cache = (k, v)
        out = None
        if cache is None and s > 1 and self.sp_group is not None:
            out, k, v = on_sp(q, k, v, cfg.sequence_parallel_mode,
                              self.sp_group)
        if out is None:
            # causal is bottom-right aligned: with a cache of `past` keys
            # (or the sp ranks' keys before this one's), query t sees keys
            # <= past + t (the JAX _offset_causal_mask)
            out = scaled_dot_product_attention(q, k, v, is_causal=s > 1,
                                               training=self.training)
        out = self.o_proj(out.reshape(b, s, heads * d))
        return out if cache is None else (out, cache)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    mp_group = None

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, ffn, False, **factory)
        self.up_proj = Linear(h, ffn, False, **factory)
        self.down_proj = Linear(ffn, h, False, row_parallel=True, **factory)
        annotate_param(self.gate_proj.weight, (None, "mp"))
        annotate_param(self.up_proj.weight, (None, "mp"))
        annotate_param(self.down_proj.weight, ("mp", None))

    def forward(self, x):
        x = copy_to(x, self.mp_group)
        return self.down_proj(swiglu_linear(x, self.gate_proj.weight,
                                            self.up_proj.weight))


class LlamaBlock(nn.Module):
    """x + attn(input_layernorm(x)), then the residual add and the
    post-attention RMSNorm as one region, then + mlp(.). On a mesh with
    FSDP, ``fsdp`` is the block's
    :class:`~..distributed.sharding.FSDPUnit`."""

    fsdp = None

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, eps = config.hidden_size, config.rms_norm_eps
        self.input_layernorm = RMSNorm(h, eps, **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(h, eps, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.recompute = bool(config.recompute)

    def _body(self, x, position_ids=None, cache=None):
        a = self.self_attn(self.input_layernorm(x), position_ids, cache)
        a, cache = (a, None) if cache is None else a
        ln = self.post_attention_layernorm
        h, x = add_rms_norm(a, x, ln.weight, ln.eps)
        x = x + self.mlp(h)
        return x if cache is None else (x, cache)

    def forward(self, x, position_ids=None, cache=None):
        """``x``; with a ``cache``, ``(x, cache)``."""
        if cache is not None:
            return self._body(x, position_ids, cache)
        body = self._body
        if self.fsdp is not None:
            # gathers inside the checkpoint: a recompute gathers again
            body = self.fsdp.wrap(body)
        if self.recompute and self.training:
            # non-reentrant: TrainStep takes its grads with
            # torch.autograd.grad, which the reentrant form refuses. K1/K2
            # and K7 run inside the checkpoint (the JAX package sends
            # attention in a rematerialised block to its XLA composition,
            # a limit of Pallas under jax.checkpoint that does not apply)
            return checkpoint(body, x, position_ids, use_reentrant=False)
        return body(x, position_ids)


class LlamaModel(nn.Module):
    """Embedding + N blocks + final RMSNorm."""

    mp_group = sp_group = None

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h = config.hidden_size
        # _weight skips Embedding's own init (and the global RNG draw):
        # LlamaForCausalLM draws every weight from its generator
        self.embed_tokens = nn.Embedding(
            config.vocab_size, h,
            _weight=torch.empty(config.vocab_size, h, **factory))
        self.layers = nn.ModuleList([LlamaBlock(config, **factory)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(h, config.rms_norm_eps, **factory)
        annotate_param(self.embed_tokens.weight, ("mp", None))

    def forward(self, input_ids, position_ids=None, caches=None):
        """Final hidden states; with ``caches`` (a ``(k, v)`` pair a
        layer) also the caches with this call's keys and values
        appended."""
        x = vocab_parallel_embedding(input_ids, self.embed_tokens.weight,
                                     self.mp_group)
        if caches is None:
            if position_ids is None:
                position_ids = sp_positions(self.sp_group, input_ids.shape[1],
                                            input_ids.device)
            for block in self.layers:
                x = block(x, position_ids)
            return self.norm(x)
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, cache = block(x, position_ids, cache)
            new_caches.append(cache)
        return self.norm(x), new_caches


def cross_entropy(logits, labels, ignore_index: int = -100):
    """Mean token cross entropy over the non-ignored labels (the JAX
    ``F.cross_entropy(..., reduction="mean")`` on integer labels):
    log-softmax in the logits' own type, the sum divided by max(count,
    1)."""
    logp = torch.log_softmax(logits, dim=-1)
    lab = labels.reshape(-1).to(device=logits.device, dtype=torch.long)
    valid = lab != ignore_index
    picked = logp.gather(-1, torch.where(valid, lab, 0)[:, None])[:, 0]
    out = -torch.where(valid, picked, 0.0)
    return out.sum() / valid.to(out.dtype).sum().clamp_min(1.0)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM holding the JAX package's parameter tree.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for);
    weights are drawn on that device from ``generator`` (default: a
    generator there seeded with ``seed``), as the port's GPT draws them:
    normal(0, initializer_range), and initializer_range / sqrt(2 L) for
    the residual-branch outputs ``o_proj`` and ``down_proj``; RMSNorm
    weights one."""

    mp_group = batch_group = None

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = {"device": dev, "dtype": dtype}
        self.llama = LlamaModel(config, **factory)
        self.lm_head = None if config.tie_word_embeddings else \
            Linear(config.hidden_size, config.vocab_size, False, **factory)
        if self.lm_head is not None:
            annotate_param(self.lm_head.weight, (None, "mp"))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        cfg = self.config
        std = cfg.initializer_range
        std_out = std / math.sqrt(2 * cfg.num_layers)
        self.llama.embed_tokens.weight.normal_(0.0, std, generator=g)
        for blk in self.llama.layers:
            att, mlp = blk.self_attn, blk.mlp
            for lin in (att.q_proj, att.k_proj, att.v_proj, mlp.gate_proj,
                        mlp.up_proj):
                lin.weight.normal_(0.0, std, generator=g)
            att.o_proj.weight.normal_(0.0, std_out, generator=g)
            mlp.down_proj.weight.normal_(0.0, std_out, generator=g)
        if self.lm_head is not None:
            self.lm_head.weight.normal_(0.0, std, generator=g)

    def forward(self, input_ids, position_ids=None, labels=None,
                caches=None):
        """Full-sequence forward. ``input_ids`` [b, s] (int); with
        ``labels`` [b, s] (already shifted; -100 = ignored) returns the
        mean token cross entropy, else the logits [b, s, vocab]. With
        ``lm_ce_chunks > 1`` (and b*s divisible by it) the loss is the
        chunked lm head + cross entropy, whose logits never exist in
        full. With ``caches`` (:meth:`init_caches`, or the caches a
        previous call returned) the tokens continue the cached ones and,
        without labels, ``(logits, caches)`` comes back."""
        if caches is None:
            x = self.llama(input_ids, position_ids)
        else:
            x, caches = self.llama(input_ids, position_ids, caches)
        tied = self.lm_head is None
        w = self.llama.embed_tokens.weight if tied else self.lm_head.weight
        chunks = head_chunks(self, x, labels)
        if chunks:
            return lm_head_chunked_ce(
                copy_to(x, self.mp_group), w, labels, chunks,
                transpose_weight=tied, mp_group=self.mp_group,
                batch_group=self.batch_group)
        logits = x @ w.t() if tied else x @ w
        if labels is None:
            return logits if caches is None else (logits, caches)
        return cross_entropy(logits.reshape(-1, logits.shape[-1]), labels)

    def init_caches(self, batch_size: int):
        """Empty ``(k, v)`` caches ``[batch_size, 0, kv_heads, head_dim]``
        a layer, on the model's device and in its type."""
        cfg = self.config
        w = self.llama.embed_tokens.weight
        return [tuple(w.new_zeros(batch_size, 0, cfg.num_kv_heads,
                                  cfg.head_dim) for _ in range(2))
                for _ in range(cfg.num_layers)]

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_p=None, eos_token_id=None, weight_quant=None,
                 kv_cache_quant=None):
        """Autoregressive decoding (:func:`.generation.generate`).
        Returns new token ids [b, max_new_tokens]."""
        from .generation import generate as _gen

        return _gen(self, input_ids, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_p=top_p,
                    eos_token_id=eos_token_id, weight_quant=weight_quant,
                    kv_cache_quant=kv_cache_quant)

    def beam_search(self, input_ids, max_new_tokens=32, num_beams=4,
                    length_penalty=0.0, eos_token_id=None,
                    weight_quant=None, kv_cache_quant=None):
        """Beam search (:func:`.generation.beam_search`). Returns the
        best beam's ids [b, max_new_tokens]."""
        from .generation import beam_search as _beam

        return _beam(self, input_ids, max_new_tokens=max_new_tokens,
                     num_beams=num_beams, length_penalty=length_penalty,
                     eos_token_id=eos_token_id, weight_quant=weight_quant,
                     kv_cache_quant=kv_cache_quant)

    def decode_adapter(self):
        """Weight-extraction protocol of the decode engine and the
        serving engine (models/generation.py)."""
        from .generation import LlamaDecodeAdapter

        return LlamaDecodeAdapter(self)
