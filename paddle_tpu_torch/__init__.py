"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package holds
the slices ported so far in PyTorch: GPT serving, GPT training, Llama
serving over bf16 or int8 KV pages, the engine's two-program layout, the
MoE serving op, and the TP ring primitives (``fusion.overlap_mm``) and
the compiled pipeline (``distributed.pipeline``) over a ring of devices
driven by one process (``distributed.Ring``), the training options
of a real run (LR schedulers, gradient merge, health policies, 8-bit
Adam moments, dropout, ``TrainStep.run_steps_stream``; ``seed(n)``
seeds dropout outside a ``TrainStep``), and whole-generation decoding
(``models.generate`` / ``beam_search`` / ``speculative_generate`` over
int8 / int4 weights and an int8 KV cache, ``forward(caches=...)``;
``seed(n)`` seeds their sampling too), and the eager dygraph surface
(``to_tensor``, ``nn.Layer`` and its layers, ``io.DataLoader``, the
eager optimizers, ``vision`` (MNIST, LeNet, ResNet), ``DataParallel``
and the custom-op registry ``utils.register_op``, whose ops are mounted
on ``ops`` and here). Every TPU kernel on those slices is rewritten by
hand for ``sm_90a``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (or a ring of CPU devices) or calls
``set_device("cpu")``.
"""
from . import io, nn, ops, optimizer, utils, vision
from .core.autograd import (backward, enable_grad, grad, is_grad_enabled,
                            no_grad, set_grad_enabled)
from .core.random import seed
from .core.tensor import is_tensor, to_tensor
from .device import get_device, resolve_device, set_device
from .distributed.parallel import DataParallel

__all__ = ["resolve_device", "seed", "set_device", "get_device",
           "to_tensor", "is_tensor", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "grad", "backward", "nn",
           "io", "ops", "optimizer", "utils", "vision", "DataParallel"]
