"""Neural-network functionals of the port (so far dropout)."""
from . import functional

__all__ = ["functional"]
