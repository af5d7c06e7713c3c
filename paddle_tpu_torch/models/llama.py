"""Llama-2 family decoder-only LM (GQA, RoPE, SwiGLU, RMSNorm), as
PyTorch modules.

Port of ``paddle_tpu/models/llama.py``. Parameters carry the JAX
package's names (``llama.layers.{i}.self_attn.q_proj.weight``, ...) and
keep Paddle's ``[in, out]`` linear layout, so a JAX model's
``state_dict`` maps onto this one by copy
(:func:`paddle_tpu_torch.convert.params_from_paddle_tpu`). The model
serves through :meth:`LlamaForCausalLM.decode_adapter`; the
full-sequence ``forward`` (training) is a later slice (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .gpt import Linear

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_tiny", "llama2_7B"]


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
    """The weight of an RMSNorm over the last axis (the serving step
    normalises through K7, ``models/generation.py`` ``_rms``)."""

    def __init__(self, d: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **factory))


class LlamaAttention(nn.Module):
    """The q/k/v/o projections (no biases); k and v have
    ``num_kv_heads`` heads."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.q_proj = Linear(h, config.num_heads * hd, False, **factory)
        self.k_proj = Linear(h, config.num_kv_heads * hd, False, **factory)
        self.v_proj = Linear(h, config.num_kv_heads * hd, False, **factory)
        self.o_proj = Linear(config.num_heads * hd, h, False, **factory)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, ffn, False, **factory)
        self.up_proj = Linear(h, ffn, False, **factory)
        self.down_proj = Linear(ffn, h, False, **factory)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h = config.hidden_size
        self.input_layernorm = RMSNorm(h, **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(h, **factory)
        self.mlp = LlamaMLP(config, **factory)


class LlamaModel(nn.Module):
    """Embedding + N blocks + final RMSNorm."""

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
        self.norm = RMSNorm(h, **factory)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM holding the JAX package's parameter tree.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for);
    weights are drawn on that device from ``generator`` (default: a
    generator there seeded with ``seed``), as the port's GPT draws them:
    normal(0, initializer_range), and initializer_range / sqrt(2 L) for
    the residual-branch outputs ``o_proj`` and ``down_proj``; RMSNorm
    weights one."""

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
        raise NotImplementedError(
            "Llama's full-sequence forward (training) is not ported yet: "
            "serve through decode_adapter() / serving.ServingEngine "
            "(ROADMAP.md)")

    def decode_adapter(self):
        """Weight-extraction protocol of the serving engine
        (models/generation.py)."""
        from .generation import LlamaDecodeAdapter

        return LlamaDecodeAdapter(self)
