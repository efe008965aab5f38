"""Fleet: the port of paddle_tpu/distributed/fleet for the dp and
sharding axes: `DistributedStrategy`, `init`, the topology and its
groups, `distributed_model` / `distributed_optimizer`, sharding stage 1
(`DygraphShardingOptimizer`), the sync helpers (`utils`) and activation
recomputation. The mp, pp and sep axes (`TensorParallel`,
`PipelineParallel`, `SegmentParallel`, a degree above 1 in
``hybrid_configs``) raise, naming ROADMAP A9b."""
from . import meta_optimizers, meta_parallel, utils  # noqa: F401
from .fleet import (DistributedStrategy, Fleet, barrier_worker,  # noqa: F401
                    distributed_model, distributed_optimizer, fleet, init,
                    is_first_worker, worker_index, worker_num)
from .meta_optimizers import (DygraphShardingOptimizer,  # noqa: F401
                              HybridParallelOptimizer)
from .meta_parallel import (HybridParallel, PipelineParallel,  # noqa: F401
                            SegmentParallel, ShardingParallel,
                            TensorParallel)
from .recompute import recompute
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["CommunicateTopology", "DistributedStrategy",
           "DygraphShardingOptimizer", "Fleet", "HybridCommunicateGroup",
           "HybridParallel", "HybridParallelOptimizer", "PipelineParallel",
           "SegmentParallel", "ShardingParallel", "TensorParallel",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "fleet", "get_hybrid_communicate_group", "init",
           "is_first_worker", "recompute", "set_hybrid_communicate_group",
           "worker_index", "worker_num"]
