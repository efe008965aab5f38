from .decode_step import (ChunkPrefillStep, DecodeStep, GenerationEngine,
                          PrefillStep, ServeDecodeStep)
from .fused_scan_step import FusedScanTrainStep
from .pipeline_step import PipelineScanTrainStep
from .sharded_scan import ShardedFusedScanTrainStep, select_train_step
from .train_step import TrainStep

__all__ = ["ChunkPrefillStep", "DecodeStep", "FusedScanTrainStep",
           "GenerationEngine", "PipelineScanTrainStep", "PrefillStep",
           "ServeDecodeStep",
           "ShardedFusedScanTrainStep", "TrainStep", "select_train_step"]
