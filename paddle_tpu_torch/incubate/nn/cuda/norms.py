"""Row RMSNorm (with or without a bias) and LayerNorm over the last axis,
each optionally after adding a bias and a residual to its input.

Port of ``paddle_tpu/incubate/nn/pallas/norms.py``'s forward kernels and
of the adds in front of them in the JAX ``fused_rms_norm`` /
``fused_layer_norm`` (``bias=``, ``residual=``). :func:`rms_norm` and
:func:`layer_norm` launch the hand-written Hopper kernel
(``csrc/norms.cu``) on CUDA tensors and raise on anything else;
:func:`rms_norm_ref` and :func:`layer_norm_ref` are the plain PyTorch
versions of the same functions (the JAX package's ``_rms_ref`` and
``_ln_ref``, after PyTorch's own adds). The one dispatching,
differentiable entry is :mod:`..functional.fused_ops`, which takes the
plain versions for CPU tensors.

In every function ``b`` is the norm's bias (added after the scale) and
the keyword ``bias`` the one added to ``x`` before the norm, as the JAX
fused functions name them. With ``residual`` the functions return
``(out, s)``, ``s = (x + bias) + residual`` rounded to x's type after
each add as PyTorch rounds them, and ``out`` the norm of ``s``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["rms_norm", "layer_norm", "rms_norm_ref", "layer_norm_ref",
           "check_kernel_inputs", "plan"]

_KERNEL = "norms"
_MAX_D = 32768                    # 1024 threads x 4 vectors x 8 values
_KIND = {"rms": 0, "rms_bias": 1, "ln": 2}
_BF16 = {torch.bfloat16: 1, torch.float32: 0}


def _added(x, bias, residual):
    """``(x + bias) + residual``, each add PyTorch's own (rounded to the
    type of its operands)."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    return x


def rms_norm_ref(x, w, b=None, eps=1e-6, *, bias=None, residual=None):
    """``_rms_ref`` of ``s`` (x, after the adds): f32 statistics, ``s *
    rsqrt(mean(s^2) + eps) * w (+ b)``, rounded to s's type once."""
    s = _added(x, bias, residual)
    sf = s.float()
    inv = torch.rsqrt((sf * sf).mean(-1, keepdim=True) + eps)
    out = sf * inv * w.float()
    if b is not None:
        out = out + b.float()
    out = out.to(s.dtype)
    return out if residual is None else (out, s)


def layer_norm_ref(x, w, b, eps=1e-5, *, bias=None, residual=None):
    """``_ln_ref`` of ``s`` (x, after the adds): f32 statistics in two
    passes (the mean, then the mean of the centred squares), ``(s - mu)
    * rsqrt(var + eps) * w + b``, rounded to s's type once."""
    s = _added(x, bias, residual)
    sf = s.float()
    sc = sf - sf.mean(-1, keepdim=True)
    inv = torch.rsqrt((sc * sc).mean(-1, keepdim=True) + eps)
    out = (sc * inv * w.float() + b.float()).to(s.dtype)
    return out if residual is None else (out, s)


def _row_ok(t, d, dtype, dev):
    return (t.dtype is dtype and t.shape == (d,) and t.is_contiguous()
            and not t.data_ptr() % 16 and t.get_device() == dev)


def check_kernel_inputs(x, w, b=None, bias=None, residual=None) -> int:
    """Raise ``ValueError`` on anything the kernel does not take: it
    reads raw pointers, so device, type, shape, layout and alignment
    are settled here. Returns ``d``, the last axis. The common case is
    one expression; a failure is explained by :func:`_fault`."""
    if not x.is_cuda:
        raise ValueError("the norm kernel takes CUDA tensors, got %s "
                         "(the plain versions serve the CPU)" % x.device)
    shape, dtype, dev = x.shape, x.dtype, x.get_device()
    d = shape[-1] if shape else 0
    if (dtype in _BF16 and 0 < d <= _MAX_D and not d % 8
            and x.is_contiguous() and not x.data_ptr() % 16
            and w is not None and _row_ok(w, d, dtype, dev)
            and (b is None or _row_ok(b, d, dtype, dev))
            and (bias is None or _row_ok(bias, d, dtype, dev))
            and (residual is None or (
                residual.dtype is dtype and residual.shape == shape
                and residual.is_contiguous() and not residual.data_ptr() % 16
                and residual.get_device() == dev))):
        return d
    raise ValueError(_fault(x, d, w, b, bias, residual))


def _fault(x, d, w, b, bias, residual) -> str:
    """What :func:`check_kernel_inputs` refused, in words."""
    if x.dtype not in _BF16:
        return "the norm kernel takes bf16 or f32, got %s" % x.dtype
    if d == 0 or d % 8 or d > _MAX_D:
        return "the last axis must be a multiple of 8 and at most %d, got " \
            "%d" % (_MAX_D, d)
    if not x.is_contiguous():
        return "x must be contiguous"
    if x.data_ptr() % 16:
        return "x must be 16-byte aligned"
    if w is None:
        return "the norm kernel takes a weight"
    for name, t, want in (("weight", w, (d,)), ("norm bias", b, (d,)),
                          ("bias", bias, (d,)),
                          ("residual", residual, tuple(x.shape))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            return "%s must be %s, got %s" % (name, list(want),
                                              tuple(t.shape))
        if t.dtype != x.dtype:
            return "%s is %s, x is %s: the kernel takes one type" % (
                name, t.dtype, x.dtype)
        if t.device != x.device:
            return "%s is on %s, x on %s" % (name, t.device, x.device)
        if not t.is_contiguous() or t.data_ptr() % 16:
            return "%s must be contiguous and 16-byte aligned" % name
    return "the norm kernel does not take these inputs"


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.norm_launch.argtypes = [p] * 7 + [i, i, ctypes.c_float, i, i, p]
        lib.norm_launch.restype = i
        lib.norm_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.norm_plan.restype = i
        lib.norm_error_string.argtypes = [i]
        lib.norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(kind, x, w, b, eps, bias, residual):
    """Check, allocate ``out`` (and the sum), launch on the current
    stream of x's device. Returns ``(out, sum or None, launched)``."""
    d = check_kernel_inputs(x, w, b, bias, residual)
    out = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    n = x.numel() // d
    if n == 0:
        return out, s, False
    lib = _lib if _lib is not None else _bind()
    dev = x.get_device()
    args = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            None if bias is None else bias.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            None if s is None else s.data_ptr(), n, d, eps, _KIND[kind],
            _BF16[x.dtype])
    # the stream is read on every call (a caller may capture a graph on
    # a side stream); the device is entered only when it is not current
    if torch._C._cuda_getDevice() == dev:
        rc = lib.norm_launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = lib.norm_launch(*args,
                                 torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError("norm kernel launch failed: %s"
                           % lib.norm_error_string(rc).decode())
    return out, s, True


def rms_norm(x, w, b=None, eps=1e-6, *, bias=None, residual=None):
    """RMSNorm over the last axis of a CUDA tensor ``x [..., d]`` (bf16
    or f32, contiguous) with ``w`` (and ``b``) ``[d]`` of x's type, on
    the Hopper kernel; with ``bias [d]`` and / or ``residual`` (x's
    shape) added to x first, in the same launch (the fused form; with a
    residual, returns ``(out, sum)``). Raises ``ValueError`` on what the
    kernel does not take. Each launch adds one to ``rms_norm.launches``,
    and one to ``rms_norm.launches_fused`` in the fused form."""
    out, s, launched = _launch("rms" if b is None else "rms_bias", x, w, b,
                               eps, bias, residual)
    rms_norm.launches += launched
    if bias is not None or residual is not None:
        rms_norm.launches_fused += launched
    return out if residual is None else (out, s)


rms_norm.launches = 0
rms_norm.launches_fused = 0


def layer_norm(x, w, b, eps=1e-5, *, bias=None, residual=None):
    """LayerNorm over the last axis of a CUDA tensor ``x [..., d]``, on
    the Hopper kernel; same inputs as :func:`rms_norm`, with a norm bias
    ``b``. Each launch adds one to ``layer_norm.launches`` (and to
    ``layer_norm.launches_fused`` in the fused form)."""
    if b is None:
        raise ValueError("layer_norm takes a bias, as the TPU kernel does")
    out, s, launched = _launch("ln", x, w, b, eps, bias, residual)
    layer_norm.launches += launched
    if bias is not None or residual is not None:
        layer_norm.launches_fused += launched
    return out if residual is None else (out, s)


layer_norm.launches = 0
layer_norm.launches_fused = 0


def plan(n, d, kind, dtype=torch.bfloat16, residual=False):
    """What the kernel launches for ``n`` rows of ``d`` (``kind`` "rms",
    "rms_bias" or "ln"; on the current CUDA device): ``(form, blocks,
    threads a block, vectors of 8 values a thread)``, form "rows" (a
    block a row) or "persistent" (one wave of blocks, several rows a
    block)."""
    out = (ctypes.c_int * 4)()
    lib = _bind()
    rc = lib.norm_plan(n, d, _KIND[kind], int(residual), _BF16[dtype], out)
    if rc != 0:
        raise RuntimeError("norm_plan failed: %s"
                           % lib.norm_error_string(rc).decode())
    return ("persistent" if out[0] else "rows", out[1], out[2], out[3])
