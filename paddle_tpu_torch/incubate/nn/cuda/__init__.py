"""Wrappers of the hand-written Hopper kernels (the counterpart of the
JAX package's ``incubate/nn/pallas``). Importing builds nothing: each
kernel is compiled on its first launch."""
from .flash_attn import (flash_attention, flash_attention_ref, flash_bwd,
                         flash_bwd_fused, flash_bwd_ref, flash_bwd_split,
                         flash_fwd, flash_fwd_ref)
from .paged_attention import (paged_kv_write_chunk, ragged_paged_attention,
                              ragged_paged_attention_ref)

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "paged_kv_write_chunk", "flash_attention", "flash_attention_ref",
           "flash_fwd", "flash_fwd_ref", "flash_bwd", "flash_bwd_fused",
           "flash_bwd_split", "flash_bwd_ref"]
