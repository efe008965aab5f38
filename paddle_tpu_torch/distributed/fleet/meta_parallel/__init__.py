"""Model wrappers by parallel axis: the port of paddle_tpu/distributed/
fleet/meta_parallel/__init__.py, for the dp, sharding, mp and pp axes.

`ShardingParallel` and `HybridParallel` run the wrapped model on the
rank's rows; their `train_step` builds the step for the model
(`jit.sharded_scan.select_train_step`, reference :32-53: on a pp degree
above 1 the pipelined scan for a ``scan_layers`` GPT, its micro-batch
count the strategy's ``pipeline_configs["accumulate_steps"]``; the
sharded fused scan over a data or model degree above 1, dp x mp when the
mesh has an mp axis). `TensorParallel` runs a model built of the
`layers.mpu` layers over the model-parallel group. `PipelineParallel`
runs a `PipelineLayer`'s stages, one rank a stage (`pipeline_parallel`).
`SegmentParallel` runs the sep axis: each rank its block of the
sequence (`ring_attention`), beside mp (a rank's heads of its block) or
dp; a `PipelineLayer` at pp x sep runs through `PipelineParallel`, which
cuts each micro-batch to the rank's block.
"""
from __future__ import annotations

import torch
from torch import nn

from ....incubate.distributed.models.moe.moe_layer import refuse_moe
from ...collective import all_gather_concat
from .ring_attention import (ring_attention, ring_flash_attention, sep_cut,
                             sep_gathered_attention, sep_group, sep_shard)

__all__ = ["HybridParallel", "LayerDesc", "MetaParallelBase",
           "PipelineLayer", "PipelineParallel",
           "PipelineParallelWithInterleave", "SegmentParallel",
           "SharedLayerDesc", "ShardingParallel", "TensorParallel",
           "pipelined_blocks", "ring_attention", "ring_flash_attention",
           "sep_gathered_attention", "sep_group", "sep_shard"]

A9B5B = ("{} under a sep degree above 1 is not ported yet: ROADMAP A9b.5b "
         "(the sep axis composes with dp, mp and a PipelineLayer's pp)")


def _refuse_moe_over(layers, hcg, what):
    """An MoE model under a topology of more than one rank: each rank
    would route its own tokens and the aux loss would miss its
    reduction (ROADMAP A9b.3b)."""
    if hcg is not None and max(
            hcg.get_data_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_sharding_parallel_world_size(),
            hcg.get_sep_parallel_world_size()) > 1:
        refuse_moe(layers, what)


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        _refuse_moe_over(layers, hcg, type(self).__name__)
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    @property
    def _comm_group(self):
        return self._hcg.get_sharding_data_group() if self._hcg else None

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _step_model(self):
        """What a `jit.TrainStep` of `train_step` runs."""
        return self._layers

    def train_step(self, optimizer, criterion=None, **kw):
        """The whole-step entry (reference meta_parallel :31-57). A fused
        scan step takes a `HybridParallelOptimizer`'s inner optimizer: it
        takes the clip's norm over its own group. Any other model's
        `jit.TrainStep` takes a plain optimizer wrapped in one when the mp
        degree is above 1, so the global-norm clip and the non-finite
        flag span the mp group (a block's grad is the rank's alone). Such
        a model is whole on every pp rank (a `PipelineLayer` trains
        through `PipelineParallel.train_batch`), so that clip leaves the
        pp group out of its norm."""
        from ....jit.sharded_scan import is_scan_gpt, select_train_step
        from ..meta_optimizers import HybridParallelOptimizer

        hcg = self._hcg
        if is_scan_gpt(self._layers):
            if isinstance(optimizer, HybridParallelOptimizer):
                optimizer = optimizer._inner_opt
        elif hcg is not None and not isinstance(
                optimizer, HybridParallelOptimizer) and \
                hcg.get_model_parallel_world_size() > 1:
            optimizer = HybridParallelOptimizer(optimizer, hcg,
                                                self._strategy,
                                                pipelined=False)
        if "num_micro" not in kw and hcg is not None and \
                hcg.get_pipe_parallel_world_size() > 1:
            cfg = getattr(self._strategy, "pipeline_configs", None) or {}
            kw["num_micro"] = int(cfg.get("accumulate_steps", 1) or 1)
        return select_train_step(self._step_model(), optimizer,
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
    """The generic wrapper for a model that is not a PipelineLayer (on a
    pp mesh: `train_step` builds the pipelined scan)."""


class TensorParallel(MetaParallelBase):
    """Reference tensor_parallel.py: the mpu layers hold their blocks and
    run the model-parallel collectives. At construction the parameters
    that are not blocks are broadcast over the model-parallel group and
    every parameter over the data-parallel group, group rank 0's winning
    (Paddle's ``_prepare_for_model``); each forward broadcasts its inputs
    over the model-parallel group, so its ranks compute on the same rows
    (`broadcast_input_data`); `apply_collective_grads` (which
    `jit.TrainStep` calls after the backward) averages the grads over the
    data-parallel group. `train_step` builds the dp x mp sharded scan
    for a ``scan_layers`` GPT, else a `jit.TrainStep` over this wrapper
    (``model.loss``: a LLaMA built under the fleet runs its Megatron
    blocks and the vocab-parallel head there)."""

    def __init__(self, layers, hcg, strategy=None):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters)

        super().__init__(layers, hcg, strategy)
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)

    def forward(self, *inputs, **kwargs):
        from ..utils.hybrid_parallel_util import broadcast_input_data

        inputs = broadcast_input_data(self._hcg, *inputs)
        return self._layers(*inputs, **kwargs)

    def apply_collective_grads(self):
        from ..utils.hybrid_parallel_util import fused_allreduce_gradients

        fused_allreduce_gradients(list(self._layers.parameters()),
                                  self._hcg)

    def _step_model(self):
        return self


class _SeqConcat(torch.autograd.Function):
    """The sep group's blocks of an output concatenated on dim 1 forward;
    this rank's block of the grad backward (every rank computes the same
    loss from the whole output: `mp_ops.c_concat` on the sequence dim)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_concat(x.contiguous(), group, axis=1)

    @staticmethod
    def backward(ctx, g):
        return sep_shard(g, ctx.group), None


class SegmentParallel(MetaParallelBase):
    """Reference segment_parallel.py:26 (the reference's
    meta_parallel/__init__.py:81-97): the sequence dim sharded over sep.
    A rank holds its block of the sequence: ``forward`` cuts dim 1 of
    every tensor input of two dims or more to it (`sep_shard`; a length
    that does not divide by the degree raises, A9b.5b, where the
    reference leaves such a tensor whole) and runs the model there, whose
    attention runs over the sep group (`ring_attention` under the
    config's ``use_ring_attention``, else `sep_gathered_attention`) at
    the block's global positions; the output's blocks are gathered back
    on dim 1 (the rank's block of the grad backward), so the reference's
    ``crit(SegmentParallel(model, hcg)(ids), labels)`` gives the world
    of one's loss on every rank. ``loss`` cuts its inputs the same way
    and runs the model's ``loss``, whose token sums and counts are summed
    over the sep group (the global mean over the rank's rows). At
    construction the parameters are broadcast over the sep and dp groups
    (group rank 0's win); `apply_collective_grads` (which `jit.TrainStep`
    calls after the backward) sums the grads over sep and averages them
    over dp (`fused_allreduce_gradients` over the dp+sep group), so the
    non-finite guard and the clip see reduced grads. `train_step` is a
    `jit.TrainStep` over this wrapper's ``loss``.

    Under mp (a model of `layers.mpu` blocks, a LLaMA built under the
    fleet) it is `TensorParallel` on the block as well: the replicated
    parameters are broadcast over the model-parallel group at
    construction (an mp rank's blocks differ and stay its own), each
    ``forward`` / ``loss`` first sends group rank 0's inputs over it,
    then cuts them; the sep ranks of one mp coordinate hold the same
    blocks, so the dp+sep reduction keeps them equal, and `train_step`'s
    `HybridParallelOptimizer` clips by the norm over the mp group alone.
    At a pp degree above 1 the model is whole on every pp rank, as
    under `HybridParallel` (`fleet.distributed_model` sends a
    `PipelineLayer` to `PipelineParallel` and refuses other models
    there).

    Stricter than the reference: a sharding degree above 1,
    ``group_sharded_parallel``, a ``scan_layers`` GPT and a GPT with
    draft heads raise ``NotImplementedError`` naming ROADMAP A9b.5b (the
    reference composes the first three under GSPMD)."""

    def __init__(self, layers, hcg, strategy=None):
        from ...sharding import group_sharded as _gs
        from ....jit.sharded_scan import is_scan_gpt
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters,
                                                  broadcast_sep_parameters)

        _refuse_moe_over(layers, hcg, "SegmentParallel")
        deg = hcg.get_sharding_parallel_world_size()
        if deg > 1:
            raise NotImplementedError(A9B5B.format(
                f"the sharding axis ({deg})"))
        if isinstance(layers, (_gs.GroupShardedStage2,
                               _gs.GroupShardedStage3)):
            raise NotImplementedError(A9B5B.format(
                "group_sharded_parallel (stages 2/3)"))
        if is_scan_gpt(layers):
            raise NotImplementedError(A9B5B.format(
                "a scan_layers GPT (the fused scan steps)"))
        if getattr(layers, "draft_heads", None) is not None:
            raise NotImplementedError(A9B5B.format(
                "draft heads (their labels cross the blocks)"))
        super().__init__(layers, hcg, strategy)
        broadcast_mp_parameters(layers, hcg)
        broadcast_sep_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)

    @property
    def _sep(self):
        return self._hcg.get_sep_parallel_group()

    def _cut(self, inputs, kwargs):
        """Group rank 0's inputs over mp (as `TensorParallel`), then each
        tensor of two dims or more cut to the rank's block."""
        from ..utils.hybrid_parallel_util import broadcast_input_data

        if self._hcg.get_model_parallel_world_size() > 1:
            broadcast_input_data(self._hcg, *inputs, **kwargs)
        return sep_cut(inputs, self._sep), sep_cut(kwargs, self._sep)

    def forward(self, *inputs, **kwargs):
        inputs, kwargs = self._cut(inputs, kwargs)
        out = self._layers(*inputs, **kwargs)
        if isinstance(out, torch.Tensor) and out.dim() >= 2:
            return _SeqConcat.apply(out, self._sep)
        return out

    def loss(self, *inputs, **kwargs):
        inputs, kwargs = self._cut(inputs, kwargs)
        return self._layers.loss(*inputs, **kwargs)

    def apply_collective_grads(self):
        from ..utils.hybrid_parallel_util import fused_allreduce_gradients

        fused_allreduce_gradients(list(self._layers.parameters()),
                                  self._hcg)

    def _step_model(self):
        return self


from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: E402
from .pipeline_parallel import (PipelineParallel,  # noqa: E402
                                PipelineParallelWithInterleave,
                                pipelined_blocks)
