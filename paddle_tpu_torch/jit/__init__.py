"""Training steps of the port (the eager counterpart of the JAX
package's compiled ``TrainStep``)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
