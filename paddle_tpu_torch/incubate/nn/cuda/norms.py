"""Row RMSNorm (with or without a bias) and LayerNorm over the last axis.

Port of ``paddle_tpu/incubate/nn/pallas/norms.py``'s forward kernels.
:func:`rms_norm` and :func:`layer_norm` launch the hand-written Hopper
kernel (``csrc/norms.cu``) on CUDA tensors and raise on anything else;
:func:`rms_norm_ref` and :func:`layer_norm_ref` are the plain PyTorch
versions of the same function (the JAX package's ``_rms_ref`` and
``_ln_ref``). The one dispatching, differentiable entry is
:mod:`..functional.fused_ops`, which takes the plain versions for CPU
tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["rms_norm", "layer_norm", "rms_norm_ref", "layer_norm_ref",
           "check_kernel_inputs"]

_KERNEL = "norms"
_MAX_D = 32768                    # 1024 threads x 4 vectors x 8 values
_KIND = {"rms": 0, "rms_bias": 1, "ln": 2}


def rms_norm_ref(x, w, b=None, eps=1e-6):
    """``_rms_ref``: f32 statistics, ``x * rsqrt(mean(x^2) + eps) * w
    (+ b)``, rounded to x's type once."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    out = xf * inv * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def layer_norm_ref(x, w, b, eps=1e-5):
    """``_ln_ref``: f32 statistics in two passes (the mean, then the
    mean of the centred squares), ``(x - mu) * rsqrt(var + eps) * w +
    b``, rounded to x's type once."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * inv * w.float() + b.float()).to(x.dtype)


def check_kernel_inputs(x, w, b=None) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: it
    reads raw pointers, so device, type, shape, layout and alignment
    are settled here."""
    if x.device.type != "cuda":
        raise ValueError("the norm kernel takes CUDA tensors, got %s "
                         "(the plain versions serve the CPU)" % x.device)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the norm kernel takes bf16 or f32, got %s"
                         % x.dtype)
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or d % 8 or d > _MAX_D:
        raise ValueError("the last axis must be a multiple of 8 and at "
                         "most %d, got %d" % (_MAX_D, d))
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in (("weight", w), ("bias", b)):
        if t is None:
            continue
        if tuple(t.shape) != (d,):
            raise ValueError("%s must be [%d], got %s"
                             % (name, d, tuple(t.shape)))
        if t.dtype != x.dtype:
            raise ValueError("%s is %s, x is %s: the kernel takes one type"
                             % (name, t.dtype, x.dtype))
        if t.device != x.device:
            raise ValueError("%s is on %s, x on %s"
                             % (name, t.device, x.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s must be contiguous and 16-byte aligned"
                             % name)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.norm_launch.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, i,
                                    p]
        lib.norm_launch.restype = i
        lib.norm_error_string.argtypes = [i]
        lib.norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(kind, x, w, b, eps):
    check_kernel_inputs(x, w, b)
    out = torch.empty_like(x)
    d = x.shape[-1]
    n = x.numel() // d
    if n == 0:
        return out, False
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.norm_launch(x.data_ptr(), w.data_ptr(),
                             None if b is None else b.data_ptr(),
                             out.data_ptr(), n, d, float(eps), _KIND[kind],
                             int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("norm kernel launch failed: %s"
                           % lib.norm_error_string(rc).decode())
    return out, True


def rms_norm(x, w, b=None, eps=1e-6):
    """RMSNorm over the last axis of a CUDA tensor ``x [..., d]`` (bf16
    or f32, contiguous) with ``w`` (and ``b``) ``[d]`` of x's type, on
    the Hopper kernel. Raises ``ValueError`` on what the kernel does not
    take. Each launch adds one to ``rms_norm.launches``."""
    out, launched = _launch("rms" if b is None else "rms_bias", x, w, b, eps)
    rms_norm.launches += launched
    return out


rms_norm.launches = 0


def layer_norm(x, w, b, eps=1e-5):
    """LayerNorm over the last axis of a CUDA tensor ``x [..., d]``, on
    the Hopper kernel; same inputs as :func:`rms_norm`, with a bias.
    Each launch adds one to ``layer_norm.launches``."""
    if b is None:
        raise ValueError("layer_norm takes a bias, as the TPU kernel does")
    out, launched = _launch("ln", x, w, b, eps)
    layer_norm.launches += launched
    return out


layer_norm.launches = 0
