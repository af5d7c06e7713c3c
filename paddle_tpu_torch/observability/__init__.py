"""Observability of the port: the global gradient norm and the
training health policies (:mod:`.health`)."""
from . import health
from .health import grad_health

__all__ = ["grad_health", "health"]
