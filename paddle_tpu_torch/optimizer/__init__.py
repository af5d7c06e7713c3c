"""Optimizers of the port (the functional AdamW that TrainStep
drives)."""
from .optimizers import AdamW

__all__ = ["AdamW"]
