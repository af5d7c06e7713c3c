"""Functional layer of the port's incubating operators."""
from .flash_attention import flash_attention, scaled_dot_product_attention

__all__ = ["flash_attention", "scaled_dot_product_attention"]
