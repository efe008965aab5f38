"""Fleet: the port of paddle_tpu/distributed/fleet/fleet.py.

`init` joins the world (`env.init_parallel_env`) if it has not been
joined, builds the rank grid from ``strategy.hybrid_configs`` (a -1
degree takes the rest of the world) and its groups (`topology.
HybridCommunicateGroup`). `distributed_model` wraps by the active axes as
the reference does (fleet.py:114-133), pp first: on a pp degree above 1
a `meta_parallel.PipelineLayer` gives `meta_parallel.PipelineParallel`
(``strategy.pipeline_configs["accumulate_steps"]`` micro-batches) and
any other model `meta_parallel.HybridParallel` (whose `train_step`
builds the pipelined scan for a ``scan_layers`` GPT); then an mp degree
above 1 gives `meta_parallel.TensorParallel`, a sharding degree above 1
`meta_parallel.ShardingParallel`, a dp degree above 1 `DataParallel`.
`distributed_optimizer` gives `HybridParallelOptimizer`, which shards
the optimizer state over the data axes when the sharding degree is
above 1 and clips by the global norm over the pp x mp group when the
mp or pp degree is. Under a sep degree above 1 (each rank its block of
the sequence) a `PipelineLayer` at a pp degree above 1 gives the
sep-aware `meta_parallel.PipelineParallel` (each micro-batch cut to the
rank's block), any other model there raises, naming ROADMAP A9b.5b, and
every model otherwise gives `meta_parallel.SegmentParallel`, beside mp
or not (a sharding degree raises, naming A9b.5b); either sums the grads
over sep and averages them over dp before the optimizer (and its clip,
over pp x mp) sees them.

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update({"dp_degree": d, "mp_degree": m,
                                    "pp_degree": p})
    strategy.pipeline_configs = {"accumulate_steps": 4}
    fleet.init(is_collective=True, strategy=strategy)
    step = fleet.distributed_model(gpt_scan).train_step(opt)
    loss = step(*env.data_shard((ids, labels)))
"""
from __future__ import annotations

import numpy as np

from .. import collective
from .. import env
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       set_hybrid_communicate_group)

__all__ = ["DistributedStrategy", "Fleet", "distributed_model",
           "distributed_optimizer", "fleet", "init"]


class DistributedStrategy:
    """Reference distributed_strategy.py:175: the knobs, with the
    reference's defaults."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1, "mp_configs": {},
            "pp_configs": {}, "sharding_configs": {},
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level=None, backend=None, device=None):
        """Reference fleet.py:166; ``backend`` / ``device`` go to
        `env.init_parallel_env` (gloo on the CPU on request)."""
        env.init_parallel_env(backend=backend, device=device)
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        dims = [int(hc.get(k, 1)) for k in ("pp_degree", "dp_degree",
                                            "sharding_degree", "sep_degree",
                                            "mp_degree")]
        known = int(np.prod([d for d in dims if d > 0]))
        dims = [env.get_world_size() // known if d == -1 else d
                for d in dims]
        if int(np.prod(dims)) == 1 and env.get_world_size() > 1:
            dims[1] = env.get_world_size()      # all degrees 1: pure dp
        self._hcg = HybridCommunicateGroup(CommunicateTopology(dims=dims))
        set_hybrid_communicate_group(self._hcg)
        return self

    @property
    def worker_num(self):
        return env.get_world_size()

    def worker_index(self):
        return env.get_rank()

    def is_first_worker(self):
        return env.get_rank() == 0

    def get_hybrid_communicate_group(self):
        return self._hcg

    def distributed_model(self, model):
        """Reference model.py:32: wrap by the active axes."""
        if self._hcg is None:
            self.init()
        hcg = self._hcg
        from ..parallel import DataParallel
        from .meta_parallel import (A9B5B, HybridParallel, PipelineLayer,
                                    PipelineParallel, SegmentParallel,
                                    ShardingParallel, TensorParallel)

        sep = hcg.get_sep_parallel_world_size() > 1
        if hcg.get_pipe_parallel_world_size() > 1:
            if isinstance(model, PipelineLayer):
                return PipelineParallel(model, hcg, strategy=self._strategy)
            if sep:
                raise NotImplementedError(A9B5B.format(
                    f"{type(model).__name__} (not a PipelineLayer) at a pp "
                    f"degree above 1"))
            return HybridParallel(model, hcg, strategy=self._strategy)
        if sep:
            # before mp: it cuts the blocks, then runs as TensorParallel
            return SegmentParallel(model, hcg, strategy=self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, strategy=self._strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, strategy=self._strategy)
        if hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """Reference fleet.py:1325: a `HybridParallelOptimizer`."""
        if self._hcg is None:
            self.init()
        from .meta_optimizers import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._hcg,
                                       strategy or self._strategy)

    def barrier_worker(self):
        collective.barrier()

    def stop_worker(self):
        pass


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, log_level=None,
         backend=None, device=None):
    return fleet.init(role_maker, is_collective, strategy, log_level,
                      backend=backend, device=device)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def worker_num():
    return fleet.worker_num


def worker_index():
    return fleet.worker_index()


def is_first_worker():
    return fleet.is_first_worker()


def barrier_worker():
    fleet.barrier_worker()

