"""Core services of the port: the random streams (dropout, parameter
initialisation, the samplers), tensor creation and grad mode."""
from . import autograd, random, tensor

__all__ = ["autograd", "random", "tensor"]
