"""The hybrid-parallel optimizer wrapper: the port of paddle_tpu/
distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py.

With a sharding degree above 1, or ``strategy.sharding`` set, it wraps
the optimizer in `DygraphShardingOptimizer` over the data axes (stage 1:
the clip's norm and the guard's flag all-reduced over the shards
there). With data
parallelism alone the model's `DataParallel` averages the grads, so
every rank holds the same grads and the plain step is already global.
"""
from __future__ import annotations

from .dygraph_sharding_optimizer import DygraphShardingOptimizer

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._hcg = hcg
        self._strategy = strategy
        shard = hcg is not None and (
            hcg.get_sharding_parallel_world_size() > 1
            or bool(getattr(strategy, "sharding", False)))
        if shard and not isinstance(optimizer, DygraphShardingOptimizer):
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        self._inner_opt = optimizer

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def _comm_group(self):
        return getattr(self._inner_opt, "_comm_group", None)

    def step(self):
        self._inner_opt.step()

    def _guarded_step(self, inv_scale=None):
        return self._inner_opt._guarded_step(inv_scale)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self._inner_opt.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    load_state_dict = set_state_dict
