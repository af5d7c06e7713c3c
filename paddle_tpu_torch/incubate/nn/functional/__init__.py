"""Functional layer of the port's incubating operators."""
from .flash_attention import flash_attention, scaled_dot_product_attention
from .fused_ops import (fused_layer_norm, fused_rms_norm,
                        fused_rotary_position_embedding, layer_norm,
                        rms_norm)
from .moe_dispatch import moe_ffn_sorted
from .serving import fused_moe

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "fused_rms_norm", "fused_layer_norm", "rms_norm", "layer_norm",
           "fused_rotary_position_embedding",
           "moe_ffn_sorted", "fused_moe"]
