"""Model families of the port (so far GPT-3: training and serving)."""
from .generation import GPTDecodeAdapter
from .gpt import (GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
                  gpt3_125M, gpt3_1p3B, gpt_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTDecodeAdapter",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt3_125M", "gpt3_1p3B"]
