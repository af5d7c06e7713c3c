"""``twoxplus1``: ``x * 2 + 1`` through a hand-written CUDA kernel.

The port's counterpart of the Pallas fixture of ``tests/test_custom_op.py``
(``twoxplus1``: a ``pl.pallas_call`` registered as a custom op). The
kernel, ``twoxplus1.cu`` beside this file, is built like the port's own
kernels (``paddle_tpu_torch.incubate.nn.cuda._build``: ``nvcc`` for
``sm_90a`` into the git-ignored ``_build/``, on first use) and bound
with ``ctypes``.

* :func:`twoxplus1_cuda` launches the kernel; it takes CUDA tensors of
  f32, bf16 or f16 only, gives a non-contiguous one ``.contiguous()``
  first, and counts its launches in ``twoxplus1_cuda.launches``;
* :func:`twoxplus1_ref` is the plain PyTorch version, ``x * 2 + 1``;
* :func:`twoxplus1` is the op's function: the kernel for a CUDA tensor,
  the plain version for a CPU tensor, an error for another type.

Register it with ``register_op("twoxplus1", twoxplus1)``. The kernel is
invisible to autograd: called on a tensor that records its gradient,
the registered op raises (it has no ``backward``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from paddle_tpu_torch.incubate.nn.cuda import _build

__all__ = ["SOURCE", "twoxplus1", "twoxplus1_cuda", "twoxplus1_ref"]

SOURCE = Path(__file__).resolve().with_name("twoxplus1.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p = ctypes.c_void_p
        lib.twoxplus1_launch.argtypes = [p, p, ctypes.c_longlong,
                                         ctypes.c_int, p]
        lib.twoxplus1_launch.restype = ctypes.c_int
        lib.twoxplus1_error_string.argtypes = [ctypes.c_int]
        lib.twoxplus1_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError("twoxplus1 takes float32, bfloat16 or float16, got "
                        "%s" % x.dtype)


def twoxplus1_cuda(x: torch.Tensor) -> torch.Tensor:
    """``x * 2 + 1`` by the kernel, on ``x``'s card, in ``x``'s type."""
    if x.device.type != "cuda":
        raise ValueError("twoxplus1_cuda takes a CUDA tensor, got one on %s "
                         "(twoxplus1_ref serves the CPU)" % x.device)
    _check_dtype(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _bind()
    with torch.cuda.device(x.device):
        rc = lib.twoxplus1_launch(
            x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("twoxplus1 launch failed: %s"
                           % lib.twoxplus1_error_string(rc).decode())
    twoxplus1_cuda.launches += 1
    return y


twoxplus1_cuda.launches = 0


def twoxplus1_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x * 2 + 1`` in PyTorch."""
    return x * 2 + 1


def twoxplus1(x: torch.Tensor) -> torch.Tensor:
    """The custom op's function: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check_dtype(x)
    if x.device.type == "cuda":
        return twoxplus1_cuda(x)
    return twoxplus1_ref(x)
