"""The hybrid-parallel optimizer wrapper: the port of paddle_tpu/
distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py.

With a sharding degree above 1, or ``strategy.sharding`` set, it wraps
the optimizer in `DygraphShardingOptimizer` over the data axes (stage 1:
the clip's norm and the guard's flag all-reduced over the shards
there, and over the mp and pp groups under model and pipeline
parallelism; a `GradScaler`'s flag, judged on a rank's grads before
their reduce-scatter, is one flag over every rank). With data
parallelism alone the model's `DataParallel` averages the grads, so
every rank holds the same grads and the plain step is already global.
With an mp or pp degree above 1 and no sharding, a
`ClipGradByGlobalNorm` of the optimizer clips, for the step, by the norm
of the global parameters (`HybridParallelClipGrad`, reference :41: the
blocks' squares summed over the model-parallel group, the replicated
parameters counted once, then the stages' sums summed over the pipeline
group, a stage's copy of a shared weight left out), and the guarded
step's non-finite flag is one flag over the pp x mp group (the
optimizer's ``_found_group``; `amp.GradScaler` reads it there too): every
rank skips or steps together. With ``pipelined=False`` the model is
whole on every pp rank (a model that is not a `PipelineLayer`): the pp
group is left out of the norm and the flag. Under a sep degree above 1
`SegmentParallel` and `PipelineParallel` hand the optimizer grads
already summed over sep and averaged over dp, so the sep ranks hold
equal grads: the norm stays summed over mp (and pp) alone and the flag
stays one over pp x mp (C17); with neither axis the plain step is
global. A sharded optimizer there raises (ROADMAP A9b.5b).
"""
from __future__ import annotations

import contextlib

from ...collective import get_group
from ....nn.clip import ClipGradBase, ClipGradByGlobalNorm, mp_norm_stats
from ....nn.clip import scaled as _scaled
from .dygraph_sharding_optimizer import DygraphShardingOptimizer

__all__ = ["HybridParallelClipGrad", "HybridParallelOptimizer"]


class HybridParallelClipGrad(ClipGradBase):
    """``clip`` (a `ClipGradByGlobalNorm`) by the norm over the
    model-parallel group and, when ``pipelined``, the pipeline group
    (`nn.clip.mp_norm_stats`); new grads, as the global clip returns
    them."""

    def __init__(self, clip, hcg, pipelined=True):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self._group = hcg.get_model_parallel_group()
        self._pp_group = hcg.get_pipe_parallel_group() if pipelined else None

    def __call__(self, params_grads):
        _, scale = mp_norm_stats(params_grads, self.clip_norm, self._group,
                                 self._pp_group)
        return [(p, _scaled(g, scale) if g is not None
                 and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None, pipelined=True):
        self._hcg = hcg
        self._strategy = strategy
        shard = hcg is not None and (
            hcg.get_sharding_parallel_world_size() > 1
            or bool(getattr(strategy, "sharding", False)))
        if shard and hcg.get_sep_parallel_world_size() > 1:
            raise NotImplementedError(
                "a sharded optimizer under a sep degree above 1 is not "
                "ported yet: ROADMAP A9b.5b (the sep axis composes with dp, "
                "mp and a PipelineLayer's pp)")
        if shard and not isinstance(optimizer, DygraphShardingOptimizer):
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        self._inner_opt = optimizer
        clip = getattr(optimizer, "_grad_clip", None)
        split = hcg is not None and (
            hcg.get_model_parallel_world_size() > 1
            or pipelined and hcg.get_pipe_parallel_world_size() > 1)
        self._mp_clip = (HybridParallelClipGrad(clip, hcg, pipelined)
                         if not shard and split
                         and type(clip) is ClipGradByGlobalNorm else None)
        if shard:
            # a scaler's eager unscale judges the rank's own grads, before
            # the shards' reduce-scatter: one flag over every rank
            optimizer._found_group = get_group()
        elif split:
            optimizer._found_group = (hcg.get_check_parallel_group()
                                      if pipelined else
                                      hcg.get_model_parallel_group())

    @property
    def _found_group(self):
        return getattr(self._inner_opt, "_found_group", None)

    @contextlib.contextmanager
    def _clipping(self):
        """The step's clip: over the model-parallel group under mp."""
        if self._mp_clip is None:
            yield
            return
        inner = self._inner_opt
        inner._grad_clip = self._mp_clip
        try:
            yield
        finally:
            inner._grad_clip = self._mp_clip._clip

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def _comm_group(self):
        return getattr(self._inner_opt, "_comm_group", None)

    def step(self):
        with self._clipping():
            self._inner_opt.step()

    def _guarded_step(self, inv_scale=None):
        with self._clipping():
            return self._inner_opt._guarded_step(inv_scale)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    load_state_dict = set_state_dict
