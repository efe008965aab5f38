"""Model wrappers by parallel axis: the port of paddle_tpu/distributed/
fleet/meta_parallel/__init__.py, for the dp and sharding axes.

`ShardingParallel` and `HybridParallel` run the wrapped model on the
rank's rows; their `train_step` builds the step for the model
(`jit.sharded_scan.select_train_step`: the sharded fused scan for a
``scan_layers`` GPT over a data degree above 1). `TensorParallel`,
`SegmentParallel` and `PipelineParallel` (the mp, sep and pp axes) raise,
naming ROADMAP A9b.
"""
from __future__ import annotations

from torch import nn

__all__ = ["HybridParallel", "MetaParallelBase", "PipelineParallel",
           "SegmentParallel", "ShardingParallel", "TensorParallel"]

A9B = ("{} (the {} axis) is not ported yet: ROADMAP A9b; this slice runs "
       "the dp and sharding axes")


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    @property
    def _comm_group(self):
        return self._hcg.get_sharding_data_group() if self._hcg else None

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def train_step(self, optimizer, criterion=None, **kw):
        """The whole-step entry (reference meta_parallel :31-57)."""
        from ....jit.sharded_scan import select_train_step

        return select_train_step(self._layers, optimizer,
                                 criterion=criterion,
                                 mesh=self._hcg.mesh if self._hcg else None,
                                 **kw)

    def __getattr__(self, name):
        """The wrapped layer's attributes (``model.loss``, ``config``, ...)
        where the wrapper has none, as the reference delegates them."""
        try:
            return super().__getattr__(name)
        except AttributeError:
            layers = self.__dict__.get("_modules", {}).get("_layers")
            if layers is None:
                raise
            return getattr(layers, name)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)


class ShardingParallel(MetaParallelBase):
    """Reference sharding_parallel.py: the optimizer shards the state
    over the data axes; the model runs the rank's rows."""


class HybridParallel(MetaParallelBase):
    """The generic wrapper for a model that is not a PipelineLayer."""


class TensorParallel(MetaParallelBase):
    def __init__(self, *a, **k):
        raise NotImplementedError(A9B.format("TensorParallel", "mp"))


class SegmentParallel(MetaParallelBase):
    def __init__(self, *a, **k):
        raise NotImplementedError(A9B.format("SegmentParallel", "sep"))


class PipelineParallel(MetaParallelBase):
    def __init__(self, *a, **k):
        raise NotImplementedError(A9B.format("PipelineParallel", "pp"))
