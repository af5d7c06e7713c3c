"""``conv2d`` (port of ``paddle_tpu/nn/functional/conv.py``).

The JAX package computes the convolution with ``lax.conv_general_dilated``
outside any Pallas kernel; the port calls ``torch.nn.functional.conv2d``
(cuDNN on the card). Paddle's padding forms are kept: an int, one int
an axis, ``[top, bottom, left, right]``, pairs, and ``"SAME"`` /
``"VALID"`` (XLA's SAME: ``ceil(in / stride)`` outputs, the odd pad at
the end). A symmetric padding goes to the convolution itself, any other
through ``F.pad`` first. NCHW only: channel-last inputs wait
(``ROADMAP.md`` §1 item 9).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as tF

__all__ = ["conv2d"]


def check_nchw(data_format: str) -> None:
    if data_format != "NCHW":
        raise NotImplementedError("data_format %r is not ported: NCHW "
                                  "only (ROADMAP.md §1 item 9)"
                                  % data_format)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(int(x) for x in v)


def padding_pairs(padding, spatial: Sequence[int], kernel: Sequence[int],
                  stride: Sequence[int], dilation: Sequence[int]
                  ) -> List[Tuple[int, int]]:
    """``(low, high)`` a spatial axis for any of Paddle's padding forms."""
    n = len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError("padding %r: an int, a list, 'SAME' or 'VALID'"
                             % padding)
        pairs = []
        for size, k, s, d in zip(spatial, kernel, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(int(x) for x in p) for p in padding]


def pad_input(x: torch.Tensor, pairs, value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded by ``pairs`` on its spatial axes."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return tF.pad(x, flat, value=value)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, dilation=1, groups=1, data_format="NCHW"
           ) -> torch.Tensor:
    """2-D convolution, ``weight`` ``[out, in / groups, kh, kw]``."""
    check_nchw(data_format)
    stride, dilation = _pair(stride), _pair(dilation)
    pairs = padding_pairs(padding, x.shape[2:], weight.shape[2:], stride,
                          dilation)
    if all(lo == hi for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x, pad = pad_input(x, pairs), 0
    return tF.conv2d(x, weight, bias, stride, pad, dilation, groups)
