"""Training steps of the port (the eager counterpart of the JAX
package's compiled ``TrainStep``) and the chunk prefetcher that feeds
``TrainStep.run_steps_stream``."""
from .train_step import ChunkPrefetcher, TrainStep

__all__ = ["TrainStep", "ChunkPrefetcher"]
