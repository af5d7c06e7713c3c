"""Fused training epilogues of the port (the chunked lm head + CE)."""
from .chunked import lm_head_chunked_ce

__all__ = ["lm_head_chunked_ce"]
