"""Fused training epilogues of the port (the chunked lm head + CE, the
residual add + RMSNorm, the SwiGLU gate and the residual add + dropout,
the MoE FFN) and the TP
ring primitives (:mod:`.overlap_mm`)."""
from . import overlap_mm
from .chunked import lm_head_chunked_ce
from .epilogues import add_rms_norm, dropout_add, swiglu_linear
from .moe import fused_moe_mlp
from .overlap_mm import (all_gather_matmul, matmul_reduce_scatter,
                         sharded_all_gather_matmul,
                         sharded_matmul_reduce_scatter)

__all__ = ["lm_head_chunked_ce", "add_rms_norm", "swiglu_linear",
           "dropout_add",
           "fused_moe_mlp", "overlap_mm", "all_gather_matmul",
           "matmul_reduce_scatter", "sharded_all_gather_matmul",
           "sharded_matmul_reduce_scatter"]
