"""Group-sharded training: the port of paddle_tpu/distributed/sharding/
group_sharded.py for stages 1 and 2.

`group_sharded_parallel(model, optimizer, level)`: ``"os"`` (stage 1)
wraps the optimizer in `DygraphShardingOptimizer` (each rank holds its
1/N shard of every bucket's masters and moments); ``"os_g"`` (stage 2)
also wraps the model in `GroupShardedStage2`, whose
`apply_collective_grads` (called by `jit.TrainStep` after the last
micro-batch's backward) reduce-scatters the grads bucket by bucket into
the rank's shards and drops each full grad as its bucket is done, so no
full grad outlives it. The optimizer's step runs on those shards. An
eager loop (``loss.backward(); opt.step()``) reduce-scatters in the
step instead. ``"p_g_os"`` (stage 3, the reference's eager
``GroupShardedStage3``) raises, naming ROADMAP A9b; for a ``scan_layers``
GPT the sharded fused scan step's ``param_storage="sharded"`` is stage
3 (`train_step`).

`GroupShardedScaler` wraps a `GradScaler` (the guard's flag is already
all-reduced over the shards by the optimizer); `save_group_sharded_model`
writes the model's state dict and the optimizer's gathered state with
``framework/io.py``.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from ..fleet.meta_optimizers.dygraph_sharding_optimizer import \
    DygraphShardingOptimizer

__all__ = ["GroupShardedScaler", "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model"]

A9B_STAGE3 = ("eager sharding stage 3 (level='p_g_os', GroupShardedStage3) "
              "is not ported yet: ROADMAP A9b; for a scan_layers GPT, "
              "ShardedFusedScanTrainStep(param_storage='sharded') stores "
              "the parameters as 1/N shards")


class GroupShardedStage2(nn.Module):
    """The stage-2 model wrapper (reference group_sharded.py:32-157)."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device=None, dp_group=None,
                 comm_bucket_mb=None):
        super().__init__()
        if not isinstance(sharding_optimizer, DygraphShardingOptimizer):
            raise TypeError("GroupShardedStage2 needs the "
                            "DygraphShardingOptimizer of its parameters")
        self._layers = layer
        self._opt = sharding_optimizer

    @property
    def _comm_group(self):
        return self._opt._group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @torch.no_grad()
    def apply_collective_grads(self):
        """One reduce-scatter (mean) a bucket into the rank's shards; each
        full grad is dropped as its bucket is done."""
        if any(p.grad is not None for p in self._opt._params):
            self._opt._bucketer.reduce_scatter(average=True, release=True)

    def train_step(self, optimizer=None, criterion=None, **kw):
        from ...jit.sharded_scan import select_train_step

        return select_train_step(self._layers, optimizer or self._opt,
                                 criterion=criterion, group=self._opt._group,
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


class GroupShardedStage3:
    def __init__(self, *a, **k):
        raise NotImplementedError(A9B_STAGE3)


class GroupShardedScaler:
    """Reference group_sharded_utils.GroupShardedScaler: the wrapped
    scaler as it is."""

    def __init__(self, scaler):
        self._scaler = scaler

    def __getattr__(self, item):
        return getattr(self._scaler, item)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Reference group_sharded.py:272. ``level``: "os" (stage 1) or
    "os_g" (stage 2). Returns ``(model, optimizer, scaler)``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"bad level {level!r} (os, os_g, p_g_os)")
    if level == "p_g_os":
        raise NotImplementedError(A9B_STAGE3)
    if offload:
        raise NotImplementedError("offload under group sharding")
    opt = (optimizer if isinstance(optimizer, DygraphShardingOptimizer)
           else DygraphShardingOptimizer(optimizer, group=group))
    out = model if level == "os" else GroupShardedStage2(
        model, opt, group=group, buffer_max_size=buffer_max_size)
    if scaler is not None:
        scaler = GroupShardedScaler(scaler)
    return out, opt, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Reference group_sharded.py:296: ``output/model.pdparams`` and, with
    the optimizer, ``output/model.pdopt`` (its gathered full state).
    Every rank gathers; rank 0 writes."""
    from ...framework import io as fio
    from .. import env

    layers = getattr(model, "_layers", model)
    opt_state = optimizer.state_dict() if optimizer is not None else None
    if env.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    fio.save(layers.state_dict(), os.path.join(output, "model.pdparams"))
    if opt_state is not None:
        fio.save(opt_state, os.path.join(output, "model.pdopt"))
