"""Optimizers of the port (the functional AdamW that TrainStep
drives, and the functional SGD of the compiled pipeline) and the
learning-rate schedulers (:mod:`.lr`) either takes as its rate."""
from . import lr
from .optimizers import SGD, AdamW

__all__ = ["AdamW", "SGD", "lr"]
