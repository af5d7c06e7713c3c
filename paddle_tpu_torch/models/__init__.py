"""Model families of the port: GPT-3 (training, dense or MoE, decoding
and serving) and Llama-2 (training, decoding and serving), the decode
entry points :func:`generate`, :func:`beam_search` and
:func:`speculative_generate`; :mod:`.pipeline_gpt` is ``bench.py``'s
pure-function GPT for the compiled pipeline."""
from .generation import (GPTDecodeAdapter, LlamaDecodeAdapter, beam_search,
                         generate, speculative_generate)
from .gpt import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                  gpt3_125M, gpt3_13B, gpt3_1p3B, gpt3_6p7B, gpt_tiny)
from .llama import LlamaConfig, LlamaForCausalLM, llama2_7B, llama_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTDecodeAdapter",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt3_125M", "gpt3_1p3B", "gpt3_6p7B", "gpt3_13B",
           "LlamaConfig", "LlamaForCausalLM", "LlamaDecodeAdapter",
           "llama_tiny", "llama2_7B", "generate", "beam_search",
           "speculative_generate"]
