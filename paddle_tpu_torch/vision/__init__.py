"""Vision pieces of the port: the MNIST dataset and the LeNet / ResNet
models of the eager path."""
from . import datasets, models

__all__ = ["datasets", "models"]
