"""Neural-network pieces of the port: functionals (so far dropout) and
the global-norm gradient clip the eager optimizers take."""
from . import functional
from .clip import ClipGradByGlobalNorm

__all__ = ["functional", "ClipGradByGlobalNorm"]
