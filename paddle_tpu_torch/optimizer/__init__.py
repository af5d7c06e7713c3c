"""Optimizers of the port (the functional AdamW that TrainStep
drives, the functional SGD of the compiled pipeline, and the eager Adam
and Momentum of the dygraph path; every one also steps eagerly over
``parameters=``) and the learning-rate schedulers (:mod:`.lr`) each
takes as its rate."""
from . import lr
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Adam", "AdamW", "SGD", "Momentum", "lr"]
