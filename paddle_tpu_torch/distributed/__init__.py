"""Distributed layers of the port: the ring of devices that the TP ring
primitives (``fusion/overlap_mm.py``) and the compiled pipeline
(:mod:`.pipeline`) run over."""
from .ring import Ring

__all__ = ["Ring"]
