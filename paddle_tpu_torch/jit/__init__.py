from .decode_step import (ChunkPrefillStep, DecodeStep, GenerationEngine,
                          PrefillStep, ServeDecodeStep)
from .fused_scan_step import FusedScanTrainStep
from .train_step import TrainStep

__all__ = ["ChunkPrefillStep", "DecodeStep", "FusedScanTrainStep",
           "GenerationEngine", "PrefillStep", "ServeDecodeStep", "TrainStep"]
