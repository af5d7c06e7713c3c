"""Wrappers of the hand-written Hopper kernels (the counterpart of the
JAX package's ``incubate/nn/pallas``, and of its two remote-copy kernels
in ``fusion/overlap_mm.py`` and ``distributed/pipeline/transport.py``:
``ring.py``). Importing builds nothing: each
kernel is compiled on its first launch. K6's ``paged_attention`` stays
in its module (``from .paged_attention import paged_attention`` would
hide the module of the same name)."""
from .flash_attn import (flash_attention, flash_attention_ref, flash_bwd,
                         flash_bwd_fused, flash_bwd_ref, flash_bwd_split,
                         flash_fwd, flash_fwd_ref)
from .moe_dispatch import grouped_matmul, grouped_matmul_ref, sort_dispatch
from .norms import layer_norm, layer_norm_ref, rms_norm, rms_norm_ref
from .paged_attention import (paged_kv_write_chunk, quantize_kv_pages,
                              ragged_paged_attention,
                              ragged_paged_attention_ref)
from .ring import mm_step, mm_step_ref, shift

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "paged_kv_write_chunk", "quantize_kv_pages", "flash_attention", "flash_attention_ref",
           "flash_fwd", "flash_fwd_ref", "flash_bwd", "flash_bwd_fused",
           "flash_bwd_split", "flash_bwd_ref", "rms_norm", "rms_norm_ref",
           "layer_norm", "layer_norm_ref", "grouped_matmul",
           "grouped_matmul_ref", "sort_dispatch", "mm_step", "mm_step_ref",
           "shift"]
