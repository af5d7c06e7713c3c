"""``batch_norm`` and ``layer_norm`` (port of ``paddle_tpu/nn/functional/
norm.py``).

Paddle's ``momentum`` is the weight of the OLD running statistic:
``running = momentum * running + (1 - momentum) * batch`` (``norm.py``
of the JAX package), the opposite of PyTorch's ``momentum``, so the port
hands PyTorch ``1 - momentum``. In training the batch's biased variance
normalises and the running variance takes the unbiased one (n / (n - 1)),
as both packages do. ``use_global_stats`` normalises by the running
statistics even in training. The statistics are updated in place.
NCHW only.

``layer_norm`` normalises over the trailing ``normalized_shape`` axes
in f32 (the biased variance), scales and shifts in f32 and returns the
input's type, as the JAX function does (plain there too: no kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .conv import check_nchw

__all__ = ["batch_norm", "layer_norm"]


def batch_norm(x: torch.Tensor, running_mean, running_var, weight=None,
               bias=None, training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None) -> torch.Tensor:
    check_nchw(data_format)
    return tF.batch_norm(x, running_mean, running_var, weight, bias,
                         training=training and not use_global_stats,
                         momentum=1.0 - momentum, eps=epsilon)


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon=1e-5, name=None) -> torch.Tensor:
    shape = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    out = tF.layer_norm(x.float(), shape,
                        None if weight is None else weight.float(),
                        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)
