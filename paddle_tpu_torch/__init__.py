"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package holds
the slices ported so far in PyTorch: GPT serving, GPT training, Llama
serving over bf16 or int8 KV pages, the engine's two-program layout, the
MoE serving op, and the TP ring primitives (``fusion.overlap_mm``) and
the compiled pipeline (``distributed.pipeline``) over a ring of devices
driven by one process (``distributed.Ring``). Every TPU kernel on those
slices is rewritten by hand for ``sm_90a``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (or a ring of CPU devices).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
