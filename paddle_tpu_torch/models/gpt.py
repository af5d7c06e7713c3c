"""GPT-3 family decoder-only LM, as PyTorch modules.

Port of ``paddle_tpu/models/gpt.py``. Parameters carry the JAX package's
names (``gpt.h.{i}.attn.qkv_proj.weight``, ...) and keep Paddle's
``[in, out]`` linear layout, so a JAX model's ``state_dict`` maps onto
this one by copy (:func:`paddle_tpu_torch.convert.params_from_paddle_tpu`).

Two paths: the full-sequence ``forward`` (training: pre-LN blocks,
causal attention through the flash-attention kernels K1-K3, a dense MLP
or, with ``moe_num_experts > 0``, a top-2 GShard mixture of experts
(:func:`..fusion.fused_moe_mlp`) whose aux loss joins the LM loss, tied
lm head, cross entropy, chunked when ``lm_ce_chunks > 1``; with
``recompute`` the blocks ``recompute_interval`` selects run under
``torch.utils.checkpoint``; with ``caches`` from :meth:`init_caches`,
the incremental form that appends each call's keys and values), and
decoding through :meth:`GPTForCausalLM.decode_adapter`
(:meth:`~GPTForCausalLM.generate`, :meth:`~GPTForCausalLM.beam_search`,
the serving engine). In training, ``dropout`` drops the
embeddings' sum and each block's two residual branches
(``fusion.dropout_add``), ``attention_dropout`` the attention output
(as in the JAX package); the masks come from the random streams of
:mod:`paddle_tpu_torch.core.random` and a recomputed block replays its
forward's.

On a mesh (``jit.TrainStep(..., mesh=...)``, which slices the
parameters by their annotations, those of the JAX model) the layers are
tensor-parallel over ``mp``: ``qkv_proj`` and ``fc1`` column-parallel
(``qkv_proj`` split head by head in each of q, k and v), ``out_proj`` and
``fc2`` row-parallel (an all-reduce, then the bias once), ``wte``
vocab-parallel (a masked lookup and an all-reduce; the tied head gives
logits split over the vocabulary, and the loss is
:func:`..fusion.lm_head_chunked_ce` over them). Head counts and widths
come from the local weights' shapes. On a mesh with an ``sp`` axis each
rank holds one contiguous part of every sequence: positions are global
(``wpe`` sees ``r s / sp ...`` on sp rank r), attention follows
``sequence_parallel_mode`` (:mod:`._sp_attention`: the gspmd gather of
K and V, or ring / ulysses), and the loss is the mean over every ``dp``
and ``sp`` rank's tokens. Without an ``sp`` group the ring and ulysses
modes are the gspmd model, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import random as _random
from ..device import DeviceLike, resolve_device
from ..distributed.auto_parallel.constraint import annotate_param
from ..distributed.sharding import (copy_to, reduce_from,
                                    vocab_parallel_embedding)
from ..fusion.chunked import lm_head_chunked_ce
from ..fusion.epilogues import dropout_add
from ..fusion.moe import fused_moe_mlp
from ..incubate.nn.functional import scaled_dot_product_attention
from ..nn.functional import dropout
from ._sp_attention import on_sp, sp_positions

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTMoEMLP",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt3_125M", "gpt3_1p3B",
           "gpt3_6p7B", "gpt3_13B"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 2048
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_bias: bool = True
    # recompute: the selected blocks keep only their input and run their
    # forward again in the backward (torch.utils.checkpoint). With
    # recompute_interval k > 0 every k-th block is skipped (its
    # activations saved; 1 selects every block), with k < 0 only every
    # (-k)-th block is recomputed
    recompute: bool = False
    recompute_interval: int = 1
    # > 1: the lm head + cross entropy run in this many token chunks, so
    # the [tokens, vocab] logits never exist in full (fusion/chunked.py)
    lm_ce_chunks: int = 0
    # "gspmd" | "ring" | "ulysses": attention over a mesh's sp axis
    # (models/_sp_attention.py)
    sequence_parallel_mode: str = "gspmd"
    # > 0: every block's MLP is a top-2 GShard mixture of this many
    # experts, each holding capacity_factor * tokens * 2 / E slots; the
    # load-balance aux loss, times moe_aux_weight, joins the LM loss
    moe_num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_position_embeddings=256, **kw)


def gpt3_125M(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt3_1p3B(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16, **kw)


def gpt3_6p7B(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)


def gpt3_13B(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40, **kw)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with Paddle's ``[in, out]`` weight (one
    GEMM with the bias in its epilogue). A ``row_parallel`` linear whose
    ``mp_group`` is set (on a mesh) holds rows of the weight: its
    products are summed over the group, then the bias is added once."""

    mp_group = None

    def __init__(self, d_in: int, d_out: int, bias: bool,
                 row_parallel: bool = False, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, **factory))
        self.bias = nn.Parameter(torch.zeros(d_out, **factory)) \
            if bias else None
        self.row_parallel = row_parallel

    def forward(self, x):
        if self.row_parallel and self.mp_group is not None:
            y = reduce_from(F.linear(x, self.weight.t()), self.mp_group)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight.t(), self.bias)


class GPTAttention(nn.Module):
    """Causal self-attention: fused qkv projection, flash attention on
    the ``[b, s, heads, head_dim]`` slices of it, output projection. With
    a ``cache`` ``(k, v)`` of ``[b, past, heads, head_dim]`` the call's
    keys and values are appended to it and returned with the output.
    ``sp_group`` (on a mesh with an ``sp`` axis): see the module note."""

    mp_group = sp_group = None

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.qkv_proj = Linear(h, 3 * h, config.use_bias, **factory)
        self.out_proj = Linear(h, h, config.use_bias, row_parallel=True,
                               **factory)
        # the JAX annotations; qkv's columns are [q | k | v], each split
        # on its own so that a rank holds whole heads of each
        annotate_param(self.qkv_proj.weight, (None, "mp"), parts=(1, 3))
        annotate_param(self.out_proj.weight, ("mp", None))
        if config.use_bias:
            annotate_param(self.qkv_proj.bias, ("mp",), parts=(3,))
            annotate_param(self.out_proj.bias, (None,))

    def forward(self, x, cache=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        x = copy_to(x, self.mp_group)
        heads = self.qkv_proj.weight.shape[1] // (3 * cfg.head_dim)
        qkv = self.qkv_proj(x).reshape(b, s, 3, heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            k = torch.cat([cache[0], k], 1)
            v = torch.cat([cache[1], v], 1)
            cache = (k, v)
        dropout_p = cfg.attention_dropout if self.training else 0.0
        out = None
        if cache is None and s > 1 and self.sp_group is not None:
            out, k, v = on_sp(q, k, v, cfg.sequence_parallel_mode,
                              self.sp_group)
        if out is None:
            # causal is bottom-right aligned: with a cache of `past` keys
            # (or the sp ranks' keys before this one's), query t sees keys
            # <= past + t, the JAX package's _offset_causal_mask(s, past)
            # (one token sees every key)
            out = scaled_dot_product_attention(
                q, k, v, is_causal=s > 1, dropout_p=dropout_p,
                training=self.training)
        out = self.out_proj(out.reshape(b, s, heads * cfg.head_dim))
        return out if cache is None else (out, cache)


class GPTMLP(nn.Module):
    """fc1 + bias + tanh-approximate gelu (the JAX ``linear_gelu``,
    approximate=True), then fc2."""

    mp_group = None

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.fc1 = Linear(h, ffn, config.use_bias, **factory)
        self.fc2 = Linear(ffn, h, config.use_bias, row_parallel=True,
                          **factory)
        annotate_param(self.fc1.weight, (None, "mp"))
        annotate_param(self.fc2.weight, ("mp", None))
        if config.use_bias:
            annotate_param(self.fc1.bias, ("mp",))
            annotate_param(self.fc2.bias, (None,))

    def forward(self, x):
        x = copy_to(x, self.mp_group)
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTMoEMLP(nn.Module):
    """Top-2 GShard mixture of gelu experts (the JAX ``GPTMoEMLP`` on its
    default route, :func:`..fusion.fused_moe_mlp`): router
    ``gate_weight [h, E]``, experts ``w1 [E, h, ffn]``, ``b1 [E, ffn]``,
    ``w2 [E, ffn, h]``, ``b2 [E, h]``, ``max(4, int(capacity_factor * b
    * s * 2 / E))`` slots an expert. ``forward`` returns ``(y, aux)``."""

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.config = config
        h, ffn = config.hidden_size, config.intermediate_size
        E = self.num_experts = config.moe_num_experts
        self.gate_weight = nn.Parameter(torch.empty(h, E, **factory))
        self.w1 = nn.Parameter(torch.empty(E, h, ffn, **factory))
        self.b1 = nn.Parameter(torch.zeros(E, ffn, **factory))
        self.w2 = nn.Parameter(torch.empty(E, ffn, h, **factory))
        self.b2 = nn.Parameter(torch.zeros(E, h, **factory))

    def forward(self, x):
        E = self.num_experts
        cap = max(4, int(self.config.moe_capacity_factor * x.shape[0]
                         * x.shape[1] * 2 / E))
        return fused_moe_mlp(x, self.gate_weight, self.w1, self.b1, self.w2,
                             self.b2, E, cap)


def _recomputes(config: GPTConfig, layer_idx: int) -> bool:
    """Whether block ``layer_idx`` runs under checkpoint (the JAX
    ``GPTBlock``'s selection by ``recompute_interval``)."""
    interval = int(config.recompute_interval) or 1
    if interval > 0:
        chosen = interval == 1 or layer_idx % interval != interval - 1
    else:
        chosen = layer_idx % (-interval) == 0
    return bool(config.recompute) and chosen


class GPTBlock(nn.Module):
    """Pre-LN block: x + dropout(attn(ln_1(x))), then + dropout(mlp(ln_2(
    .))). ``forward`` returns ``(x, aux)``, aux the MoE aux loss (None
    for a dense MLP). On a mesh with FSDP, ``fsdp`` is the block's
    :class:`~..distributed.sharding.FSDPUnit`."""

    fsdp = None

    def __init__(self, config: GPTConfig, layer_idx: int = 0, **factory):
        super().__init__()
        eps = config.layer_norm_eps
        self.ln_1 = nn.LayerNorm(config.hidden_size, eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln_2 = nn.LayerNorm(config.hidden_size, eps, **factory)
        self.moe = config.moe_num_experts > 0
        self.mlp = (GPTMoEMLP if self.moe else GPTMLP)(config, **factory)
        self.recompute = _recomputes(config, layer_idx)
        self.dropout = config.dropout
        self.draws = bool(config.dropout or config.attention_dropout)

    def _body(self, x, cache=None):
        p = self.dropout
        a = self.attn(self.ln_1(x), cache)
        a, cache = (a, None) if cache is None else a
        x = dropout_add(a, x, p, self.training)
        m = self.mlp(self.ln_2(x))
        m, aux = m if self.moe else (m, None)
        x = dropout_add(m, x, p, self.training)
        return (x, aux) if cache is None else (x, aux, cache)

    def _replaying(self, device):
        """``_body`` whose calls after the first draw the first call's
        dropout masks again. torch.utils.checkpoint stashes and restores
        only the global CPU and CUDA RNGs, not the explicit generator
        dropout draws from: the recompute would draw new masks and give
        wrong gradients. So the generator's state is taken before the
        checkpoint; the forward draws from it as usual, and a recompute
        runs from that state and then puts back the generator's state of
        the moment, so the draws after the block see the same stream
        with recompute on or off. The recompute runs where the backward
        runs (a thread of the autograd engine for CUDA tensors), so it
        installs the generator itself."""
        gen = _random.generator(device)
        start = gen.get_state()
        first = True

        def body(x):
            nonlocal first
            if first:
                first = False
                return self._body(x)
            now = gen.get_state()
            gen.set_state(start)
            try:
                with _random.rng_guard(gen):
                    return self._body(x)
            finally:
                gen.set_state(now)
        return body

    def forward(self, x, cache=None):
        """``(x, aux)``; with a ``cache``, ``(x, aux, cache)``."""
        if cache is not None:
            return self._body(x, cache)
        body = self._body
        if self.fsdp is not None:
            # gathers inside the checkpoint: a recompute gathers again
            body = self.fsdp.wrap(body)
        if self.recompute and self.training:
            # non-reentrant: TrainStep takes its grads with
            # torch.autograd.grad, which the reentrant form refuses. The
            # aux loss leaves the checkpointed function as an output; the
            # flash kernels run inside it (the JAX package sends
            # attention in a rematerialised block to its XLA composition,
            # a limit of Pallas under jax.checkpoint that does not apply)
            if self.draws:
                body = self._replaying(x.device)
            return checkpoint(body, x, use_reentrant=False)
        return body(x)


class GPTModel(nn.Module):
    """Embeddings + N blocks + final LN."""

    mp_group = sp_group = None

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        h = config.hidden_size
        # _weight skips Embedding's own init (and the global RNG draw):
        # GPTForCausalLM draws every weight from its generator
        self.wte = nn.Embedding(
            config.vocab_size, h,
            _weight=torch.empty(config.vocab_size, h, **factory))
        self.wpe = nn.Embedding(
            config.max_position_embeddings, h,
            _weight=torch.empty(config.max_position_embeddings, h,
                                **factory))
        self.h = nn.ModuleList([GPTBlock(config, i, **factory)
                                for i in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(h, config.layer_norm_eps, **factory)
        self.dropout = config.dropout
        annotate_param(self.wte.weight, ("mp", None))
        annotate_param(self.wpe.weight, (None, None))

    def forward(self, input_ids, position_ids=None):
        return self.hidden_and_aux(input_ids, position_ids)[0]

    def hidden_and_aux(self, input_ids, position_ids=None, caches=None):
        """``(final hidden states, [each MoE block's aux loss])``; with
        ``caches`` (a ``(k, v)`` pair a layer) also the caches with this
        call's keys and values appended, and positions by default from
        the cache's length on (on an sp mesh, from this rank's part's
        start)."""
        past = 0 if caches is None else caches[0][0].shape[1]
        if position_ids is None and caches is None:
            position_ids = sp_positions(self.sp_group, input_ids.shape[1],
                                        input_ids.device)
        if position_ids is None:
            position_ids = torch.arange(past, past + input_ids.shape[1],
                                        device=input_ids.device)[None]
        x = dropout(vocab_parallel_embedding(
            input_ids, self.wte.weight, self.mp_group)
            + self.wpe(position_ids), self.dropout, training=self.training)
        auxes, new_caches = [], []
        for i, block in enumerate(self.h):
            if caches is None:
                x, aux = block(x)
            else:
                x, aux, c = block(x, caches[i])
                new_caches.append(c)
            if aux is not None:
                auxes.append(aux)
        if caches is None:
            return self.ln_f(x), auxes
        return self.ln_f(x), auxes, new_caches


class GPTForCausalLM(nn.Module):
    """GPT causal LM holding the JAX package's parameter tree.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for);
    weights are drawn from ``generator`` (default: a generator on the
    device seeded with ``seed``) with the JAX package's initializer:
    normal(0, initializer_range), and initializer_range / sqrt(2 L) for
    the residual-branch outputs ``out_proj`` and ``fc2`` (MoE: ``w2``;
    ``gate_weight`` and ``w1`` at initializer_range); biases zero,
    LayerNorm weights one."""

    mp_group = batch_group = None

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        factory = {"device": dev, "dtype": dtype}
        self.gpt = GPTModel(config, **factory)
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
        self.gpt.wte.weight.normal_(0.0, std, generator=g)
        self.gpt.wpe.weight.normal_(0.0, std, generator=g)
        for blk in self.gpt.h:
            blk.attn.qkv_proj.weight.normal_(0.0, std, generator=g)
            blk.attn.out_proj.weight.normal_(0.0, std_out, generator=g)
            if blk.moe:
                blk.mlp.gate_weight.normal_(0.0, std, generator=g)
                blk.mlp.w1.normal_(0.0, std, generator=g)
                blk.mlp.w2.normal_(0.0, std_out, generator=g)
            else:
                blk.mlp.fc1.weight.normal_(0.0, std, generator=g)
                blk.mlp.fc2.weight.normal_(0.0, std_out, generator=g)
        if self.lm_head is not None:
            self.lm_head.weight.normal_(0.0, std, generator=g)

    def forward(self, input_ids, position_ids=None, labels=None,
                caches=None):
        """Full-sequence forward. ``input_ids`` [b, s] (int); with
        ``labels`` [b, s] (already shifted; -100 = ignored) returns the
        mean token cross entropy, plus each MoE block's aux loss times
        ``moe_aux_weight``, else the logits [b, s, vocab]. With
        ``lm_ce_chunks > 1`` (and b*s divisible by it) the loss is the
        chunked lm head + cross entropy, whose logits never exist in
        full. With ``caches`` (:meth:`init_caches`, or the caches a
        previous call returned) the tokens continue the cached ones and,
        without labels, ``(logits, caches)`` comes back, each layer's
        cache grown by this call's keys and values."""
        if caches is None:
            x, auxes = self.gpt.hidden_and_aux(input_ids, position_ids)
        else:
            x, auxes, caches = self.gpt.hidden_and_aux(
                input_ids, position_ids, caches)
        tied = self.lm_head is None
        w = self.gpt.wte.weight if tied else self.lm_head.weight
        chunks = head_chunks(self, x, labels)
        if chunks:
            loss = lm_head_chunked_ce(
                copy_to(x, self.mp_group), w, labels, chunks,
                transpose_weight=tied, mp_group=self.mp_group,
                batch_group=self.batch_group)
        else:
            logits = x @ w.t() if tied else x @ w
            if labels is None:
                return logits if caches is None else (logits, caches)
            loss = GPTPretrainingCriterion()(logits, labels)
        for aux in auxes:
            loss = loss + aux * self.config.moe_aux_weight
        return loss

    def init_caches(self, batch_size: int):
        """Empty ``(k, v)`` caches ``[batch_size, 0, heads, head_dim]``
        a layer, on the model's device and in its type."""
        cfg = self.config
        w = self.gpt.wte.weight
        return [tuple(w.new_zeros(batch_size, 0, cfg.num_heads,
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
        from .generation import GPTDecodeAdapter

        return GPTDecodeAdapter(self)


def head_chunks(model, x, labels):
    """The chunk count of the chunked lm head + CE for this forward, or
    0 for the plain head: ``lm_ce_chunks`` where it is above 1 and
    divides the tokens. On a mesh (the logits split over ``mp``) the
    loss always takes the chunked head, in one chunk where the count
    does not divide; a mesh model trains, its logits are not
    gathered."""
    chunks = int(model.config.lm_ce_chunks or 0)
    if chunks < 1 or x.shape[0] * x.shape[1] % chunks:
        chunks = 1
    if model.mp_group is None and model.batch_group is None:
        return chunks if labels is not None and chunks > 1 else 0
    if labels is None:
        raise NotImplementedError(
            "logits and decoding on a mesh are not ported: see ROADMAP.md")
    return chunks


class GPTPretrainingCriterion(nn.Module):
    """Token-level cross entropy, mean over non-ignored positions, on
    pre-shifted labels (no shift happens here). Log-softmax in f32; the
    mean divides by max(count, 1) as the JAX package does."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        logp = torch.log_softmax(logits.reshape(-1, logits.shape[-1])
                                 .float(), dim=-1)
        lab = labels.reshape(-1).long()
        valid = lab != self.ignore_index
        picked = logp.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
        nll = -torch.where(valid, picked, 0.0)
        return nll.sum() / valid.sum().clamp_min(1)
