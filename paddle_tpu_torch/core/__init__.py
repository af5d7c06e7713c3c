"""Core services of the port (so far the random streams of dropout)."""
from . import random

__all__ = ["random"]
