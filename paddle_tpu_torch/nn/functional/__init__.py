"""Functionals of ``paddle_tpu.nn.functional`` the port needs (so far
dropout)."""
from .common import dropout

__all__ = ["dropout"]
