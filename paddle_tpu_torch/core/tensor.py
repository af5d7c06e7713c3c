"""Tensor creation of the eager surface.

Port of ``to_tensor`` / ``is_tensor`` of ``paddle_tpu/core/tensor.py``.
The port's tensor is ``torch.Tensor`` itself: ``stop_gradient=False``
is ``requires_grad=True``, and autograd is PyTorch's. The JAX package's
default types hold: a Python float, and float64 numpy data without a
``dtype``, become float32 (``core/dtype.py``'s narrowing); integers stay
int64, PyTorch's index type. The tensor lands on ``place`` or, without
one, on :func:`paddle_tpu_torch.device.get_device`'s place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["to_tensor", "is_tensor"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def as_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from Paddle's names (``"float32"``), numpy
    types or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> torch.Tensor:
    """A new tensor holding a copy of ``data`` (a tensor, numpy array,
    Python scalar or nested list) on ``place`` (default: the global
    place). ``stop_gradient=False`` makes it a leaf that records its
    gradient."""
    dev = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    if dtype is not None:
        t = t.to(as_dtype(dtype))
    return t.requires_grad_(not stop_gradient)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
