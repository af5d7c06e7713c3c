"""Functionals of ``paddle_tpu.nn.functional`` the port needs: dropout,
linear, relu, conv2d, the 2-D pools, batch_norm and cross_entropy."""
from .activation import relu
from .common import dropout, linear
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["dropout", "linear", "relu", "conv2d", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "batch_norm", "cross_entropy"]
