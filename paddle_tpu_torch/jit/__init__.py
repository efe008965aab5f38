from .decode_step import ChunkPrefillStep, ServeDecodeStep
from .train_step import TrainStep

__all__ = ["ChunkPrefillStep", "ServeDecodeStep", "TrainStep"]
