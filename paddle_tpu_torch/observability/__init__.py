"""Observability of the port (so far the global gradient norm)."""
from .health import grad_health

__all__ = ["grad_health"]
