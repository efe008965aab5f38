from .decode_step import (ChunkPrefillStep, DecodeStep, GenerationEngine,
                          PrefillStep, ServeDecodeStep)
from .train_step import TrainStep

__all__ = ["ChunkPrefillStep", "DecodeStep", "GenerationEngine",
           "PrefillStep", "ServeDecodeStep", "TrainStep"]
