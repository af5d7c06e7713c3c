"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package holds
the slices ported so far (GPT serving and GPT training) in PyTorch, with
every TPU kernel on those slices rewritten by hand for ``sm_90a``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
