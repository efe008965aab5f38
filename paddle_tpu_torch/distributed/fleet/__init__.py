"""Fleet: the port of paddle_tpu/distributed/fleet for the dp, sharding,
mp, pp and sep axes: `DistributedStrategy`, `init`, the topology and its
groups, `distributed_model` / `distributed_optimizer`, sharding stage 1
(`DygraphShardingOptimizer`), tensor parallelism (`layers.mpu`,
`TensorParallel`, the clip over the model-parallel group), pipeline
parallelism (`meta_parallel.PipelineLayer`, `PipelineParallel`, the
ring of `meta_parallel.spmd_pipeline`), sequence blocks over the sep
axis (`SegmentParallel`, `meta_parallel.ring_attention`), the sync
helpers and Megatron's sequence parallelism (`utils`) and activation
recomputation. The sep axis composes with dp, mp and a
`PipelineLayer`'s pp (sharding, and another model at pp, raise, naming
ROADMAP A9b.5b)."""
from . import layers, meta_optimizers, meta_parallel, utils  # noqa: F401
from .layers.mpu import get_rng_state_tracker  # noqa: F401
from .fleet import (DistributedStrategy, Fleet, barrier_worker,  # noqa: F401
                    distributed_model, distributed_optimizer, fleet, init,
                    is_first_worker, worker_index, worker_num)
from .meta_optimizers import (DygraphShardingOptimizer,  # noqa: F401
                              HybridParallelOptimizer)
from .meta_parallel import (HybridParallel, LayerDesc,  # noqa: F401
                            PipelineLayer, PipelineParallel,
                            SegmentParallel, SharedLayerDesc,
                            ShardingParallel, TensorParallel)
from .recompute import recompute
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["CommunicateTopology", "DistributedStrategy",
           "DygraphShardingOptimizer", "Fleet", "HybridCommunicateGroup",
           "HybridParallel", "HybridParallelOptimizer", "LayerDesc",
           "PipelineLayer", "PipelineParallel", "SharedLayerDesc",
           "SegmentParallel", "ShardingParallel", "TensorParallel",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "fleet", "get_hybrid_communicate_group",
           "get_rng_state_tracker", "init",
           "is_first_worker", "recompute", "set_hybrid_communicate_group",
           "worker_index", "worker_num"]
