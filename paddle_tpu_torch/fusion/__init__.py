"""Fused training epilogues of the port (the chunked lm head + CE) and
the TP ring primitives (:mod:`.overlap_mm`)."""
from . import overlap_mm
from .chunked import lm_head_chunked_ce
from .overlap_mm import (all_gather_matmul, matmul_reduce_scatter,
                         sharded_all_gather_matmul,
                         sharded_matmul_reduce_scatter)

__all__ = ["lm_head_chunked_ce", "overlap_mm", "all_gather_matmul",
           "matmul_reduce_scatter", "sharded_all_gather_matmul",
           "sharded_matmul_reduce_scatter"]
