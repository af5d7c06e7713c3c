"""2-D pooling (port of ``max_pool2d``, ``avg_pool2d`` and
``adaptive_avg_pool2d`` of ``paddle_tpu/nn/functional/pooling.py``).

The JAX package pools with ``lax.reduce_window`` over explicit pads
(``-inf`` for max, zeros for average), ``"SAME"`` as XLA computes it,
``ceil_mode`` as extra padding at the end of an axis; an ``exclusive``
average divides by the window's count of real elements when anything is
padded, else by the window's size. The port calls PyTorch's pooling with
its own padding where that is the same function (symmetric padding of at
most half the window, no ``ceil_mode``), else pads explicitly first.
NCHW only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .conv import _pair, check_nchw, pad_input, padding_pairs

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _pairs(x, kernel, stride, padding, ceil_mode):
    """The pads of each spatial axis, ``ceil_mode``'s extra included."""
    pairs = padding_pairs(padding, x.shape[2:], kernel, stride, (1, 1))
    if ceil_mode and not isinstance(padding, str):
        for i, (size, k, s) in enumerate(zip(x.shape[2:], kernel, stride)):
            lo, hi = pairs[i]
            out = -(-(size + lo + hi - k) // s) + 1
            pairs[i] = (lo, hi + max(0, (out - 1) * s + k - (size + lo + hi)))
    return pairs


def _native(pairs, kernel, ceil_mode):
    """PyTorch's own padding computes the same windows."""
    return not ceil_mode and all(lo == hi and lo <= k // 2
                                 for (lo, hi), k in zip(pairs, kernel))


def _max(x, kernel, stride, padding, ceil_mode):
    pairs = _pairs(x, kernel, stride, padding, ceil_mode)
    if _native(pairs, kernel, ceil_mode):
        return tF.max_pool2d(x, kernel, stride, [lo for lo, _ in pairs])
    return tF.max_pool2d(pad_input(x, pairs, float("-inf")), kernel, stride)


def max_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0,
               return_mask=False, ceil_mode=False, data_format="NCHW"
               ) -> torch.Tensor:
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported (ROADMAP.md §1 item 9)")
    check_nchw(data_format)
    kernel = _pair(kernel_size)
    stride = _pair(stride if stride is not None else kernel_size)
    return _max(x, kernel, stride, padding, ceil_mode)


def _avg(x, kernel, stride, padding, ceil_mode, exclusive):
    pairs = _pairs(x, kernel, stride, padding, ceil_mode)
    if _native(pairs, kernel, ceil_mode):
        return tF.avg_pool2d(x, kernel, stride, [lo for lo, _ in pairs],
                             count_include_pad=not exclusive)
    out = tF.avg_pool2d(pad_input(x, pairs), kernel, stride)
    if exclusive and any(lo or hi for lo, hi in pairs):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / tF.avg_pool2d(pad_input(ones, pairs), kernel, stride)
    return out


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0,
               ceil_mode=False, exclusive=True, divisor_override=None,
               data_format="NCHW") -> torch.Tensor:
    if divisor_override is not None:
        raise NotImplementedError("avg_pool2d(divisor_override=...) is not "
                                  "ported (ROADMAP.md §1 item 9)")
    check_nchw(data_format)
    kernel = _pair(kernel_size)
    stride = _pair(stride if stride is not None else kernel_size)
    return _avg(x, kernel, stride, padding, ceil_mode, exclusive)


def adaptive_avg_pool2d(x: torch.Tensor, output_size, data_format="NCHW"
                        ) -> torch.Tensor:
    """Averages over ``output_size`` regions an axis, region i spanning
    ``[floor(i * in / out), ceil((i + 1) * in / out))`` (the JAX rule and
    PyTorch's)."""
    check_nchw(data_format)
    return tF.adaptive_avg_pool2d(x, _pair(output_size))
