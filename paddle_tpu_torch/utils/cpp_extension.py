"""``paddle.utils.cpp_extension`` surface.

Port of ``paddle_tpu/utils/cpp_extension.py``: building C++ / CUDA
operators from sources through this API is not supported. A custom op,
with a hand-written CUDA kernel or without one, is registered with
:func:`paddle_tpu_torch.utils.register_op` (forward and custom backward,
eager); a kernel source is built by ``nvcc`` into a plain-C library and
bound with ``ctypes`` (``incubate/nn/cuda/_build.py`` builds any named
``.cu`` file), as the port's own kernels are.
"""
from __future__ import annotations

__all__ = ["load", "setup", "CppExtension", "CUDAExtension"]

_MSG = (
    "is not supported: register custom ops with "
    "paddle_tpu_torch.utils.register_op(name, fn, backward=...), fn a "
    "PyTorch function or a wrapper that launches a CUDA kernel built by "
    "paddle_tpu_torch.incubate.nn.cuda._build (nvcc into a plain-C "
    "library bound with ctypes)."
)


class _Unsupported(NotImplementedError):
    def __init__(self, what):
        super().__init__(f"{what} {_MSG}")


def load(name, sources, *a, **kw):
    raise _Unsupported("cpp_extension.load")


def setup(**kw):
    raise _Unsupported("cpp_extension.setup")


def CppExtension(sources, *a, **kw):
    raise _Unsupported("CppExtension")


def CUDAExtension(sources, *a, **kw):
    raise _Unsupported("CUDAExtension")
