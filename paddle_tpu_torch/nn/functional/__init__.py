"""Functionals of ``paddle_tpu.nn.functional`` the port needs: dropout,
linear, embedding, relu, gelu, tanh, conv2d, the 2-D pools, batch_norm,
layer_norm, cross_entropy and ``scaled_dot_product_attention`` (the
function of ``incubate.nn.functional``: K1 / K2 / K3 on the card)."""
from .activation import gelu, relu, tanh
from .common import dropout, embedding, linear
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d
from ...incubate.nn.functional.flash_attention import (  # noqa: E402
    scaled_dot_product_attention)

__all__ = ["dropout", "linear", "embedding", "relu", "gelu", "tanh",
           "conv2d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "batch_norm", "layer_norm", "cross_entropy",
           "scaled_dot_product_attention"]
