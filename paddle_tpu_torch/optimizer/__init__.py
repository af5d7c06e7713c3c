"""Optimizers of the port (the functional AdamW that TrainStep
drives, and the functional SGD of the compiled pipeline)."""
from .optimizers import SGD, AdamW

__all__ = ["AdamW", "SGD"]
