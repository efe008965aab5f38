"""Megatron sequence parallelism: the port of paddle_tpu/distributed/
fleet/utils/sequence_parallel_utils.py (Paddle's ``ScatterOp`` /
``GatherOp`` / ``AllGatherOp`` / ``ReduceScatterOp`` :85-137,
``ColumnSequenceParallelLinear`` :427, ``RowSequenceParallelLinear``,
``register_sequence_parallel_allreduce_hooks`` :192).

Activations are ``[s, b, h]``; outside the tensor-parallel products a
rank of the model-parallel group holds its block of the sequence (dim
0). The reference writes these as sharding constraints on global
arrays and lets GSPMD place the collectives; here each is an autograd
operator over the model-parallel group, its backward the transpose of
its forward:

* `ScatterOp`: the rank's block of ``axis`` / the blocks gathered;
* `GatherOp`: the blocks gathered along ``axis`` / the rank's block;
* `AllGatherOp`: the blocks gathered along dim 0 / reduce-scatter;
* `ReduceScatterOp`: reduce-scatter along dim 0 / the blocks gathered.

`ColumnSequenceParallelLinear` gathers the sequence before its column
block's product; `RowSequenceParallelLinear` reduce-scatters its row
block's partial product along the sequence, then adds the bias. A
parameter applied to a sequence block (a LayerNorm's, the row layer's
bias) gets a partial grad a rank: `mark_as_sequence_parallel_parameter`
marks it and `register_sequence_parallel_allreduce_hooks` sums its grad
over the group after each backward. Held on the CPU over gloo ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...collective import ReduceOp, all_gather_concat, all_reduce
from ...collective import reduce_scatter as _reduce_scatter
from ..layers.mpu.mp_layers import _block_param
from ..layers.mpu.mp_ops import c_concat, mp_group
from ..layers.mpu.mp_ops import mp_group as _resolve
from ....nn.initializer import Constant, XavierUniform
from ....nn.layer.layers import create_parameter

__all__ = ["AllGatherOp", "ColumnSequenceParallelLinear", "GatherOp",
           "ReduceScatterOp", "RowSequenceParallelLinear", "ScatterOp",
           "all_gather", "mark_as_sequence_parallel_parameter",
           "reduce_scatter", "register_sequence_parallel_allreduce_hooks",
           "scatter"]


def _split(x, axis, group):
    n, r = group.nranks, group.rank
    w = x.shape[axis] // n
    return x.narrow(axis, r * w, w).contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _split(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_concat(g.contiguous(), ctx.group, ctx.axis), \
            None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return all_gather_concat(x.contiguous(), group, axis)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.axis, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_concat(x.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), group=ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_concat(g.contiguous(), ctx.group, 0), None


def _one(group):
    return group is None or group.nranks == 1


class ScatterOp:
    """The rank's block of ``axis`` (reference :85)."""

    @staticmethod
    def apply(x, axis=0, group=None):
        group = mp_group(group)
        return x if _one(group) else _Scatter.apply(x, axis, group)


class GatherOp:
    """The ranks' blocks gathered along ``axis``."""

    @staticmethod
    def apply(x, axis=0, group=None):
        group = mp_group(group)
        return x if _one(group) else _Gather.apply(x, axis, group)


class AllGatherOp:
    """Gather along dim 0 forward, reduce-scatter backward."""

    @staticmethod
    def apply(x, group=None):
        group = mp_group(group)
        return x if _one(group) else _AllGather.apply(x, group)


class ReduceScatterOp:
    """Reduce-scatter along dim 0 forward, gather backward."""

    @staticmethod
    def apply(x, group=None):
        group = mp_group(group)
        return x if _one(group) else _ReduceScatter.apply(x, group)


def scatter(x, axis=0, group=None):
    return ScatterOp.apply(x, axis, group)


def all_gather(x, group=None):
    return AllGatherOp.apply(x, group)


def reduce_scatter(x, group=None):
    return ReduceScatterOp.apply(x, group)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False, group=None):
    """After each backward, the grad of every parameter marked by
    `mark_as_sequence_parallel_parameter` is summed over the
    model-parallel group (Paddle sums after ``accumulation_steps``
    micro-steps; here every accumulation, the same sum). Returns the
    hooks' handles."""
    group = mp_group(group)
    if _one(group):
        return []

    def hook(p):
        all_reduce(p.grad, ReduceOp.SUM, group)

    return [p.register_post_accumulate_grad_hook(hook)
            for p in model.parameters()
            if getattr(p, "sequence_parallel", False)]


class ColumnSequenceParallelLinear(torch.nn.Linear):
    """Reference :427: the input's sequence blocks gathered, then the
    rank's output columns (``gather_output`` concatenates them)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        torch.nn.Module.__init__(self)
        self._group = _resolve(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        w = create_parameter([in_features, out_features], weight_attr, dtype,
                             default_initializer=XavierUniform(),
                             device=device, transpose=True)
        self.weight = _block_param(w, 0, self._group)
        b = create_parameter([out_features], None, dtype, is_bias=True,
                             default_initializer=Constant(0.0),
                             device=device) if has_bias else None
        self.bias = _block_param(b, 0, self._group)

    def forward(self, x):
        out = F.linear(AllGatherOp.apply(x, self._group), self.weight,
                       self.bias)
        return c_concat(out, self._group) if self.gather_output else out


class RowSequenceParallelLinear(torch.nn.Linear):
    """The rank's input columns' partial product reduce-scattered along
    the sequence, then the bias (a sequence-parallel parameter)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        torch.nn.Module.__init__(self)
        self._group = _resolve(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        w = create_parameter([in_features, out_features], weight_attr, dtype,
                             default_initializer=XavierUniform(),
                             device=device, transpose=True)
        self.weight = _block_param(w, 1, self._group)
        self.bias = create_parameter([out_features], None, dtype,
                                     is_bias=True,
                                     default_initializer=Constant(0.0),
                                     device=device) if has_bias else None
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        out = ReduceScatterOp.apply(F.linear(x, self.weight), self._group)
        return out if self.bias is None else out + self.bias

