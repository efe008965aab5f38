"""Gradient and parameter sync helpers: the port of paddle_tpu/
distributed/fleet/utils/hybrid_parallel_util.py (:1-59).

`fused_allreduce_gradients` averages the parameters' grads over the
data-parallel group with one bucketed all-reduce a bucket (a rank's
grads are partial in the port, as in the reference's per-rank
processes); a model-parallel group beside it is left alone: a block's
grad is its own, and a replicated parameter's is whole on every
model-parallel rank already. Under a sep degree above 1 (reference
:254-269) the all-reduce runs over the fused dp+sep group and the sum is
divided by the dp degree alone: a sep rank's grad is its block of the
sequence's part of one loss (summed), a dp rank's the grad of its rows'
loss (averaged). The broadcasts send group rank 0's
parameters (and buffers) to the group, so ranks start equal;
`broadcast_mp_parameters` skips the mpu layers' blocks
(``is_distributed``), which differ by rank, and `broadcast_input_data`
sends group rank 0's inputs over the model-parallel group.
"""
from __future__ import annotations

import torch

from ....nn.clip import is_block
from ...collective import ReduceOp, all_reduce, broadcast  # noqa: F401
from ...comm_bucketer import bucketed_all_reduce

__all__ = ["broadcast_dp_parameters", "broadcast_input_data",
           "broadcast_mp_parameters", "broadcast_sep_parameters",
           "broadcast_sharding_parameters", "fused_allreduce_gradients"]


@torch.no_grad()
def fused_allreduce_gradients(parameter_list, hcg=None, group=None):
    """The grads' mean over ``group`` (default: hcg's data-parallel
    group; under a sep degree above 1 the sum over hcg's dp+sep group
    divided by the dp degree), in place."""
    from ...parallel import data_group

    div = None
    if group is None and hcg is not None and \
            hcg.get_sep_parallel_world_size() > 1:
        group = hcg.get_dp_sep_parallel_group()
        div = hcg.get_data_parallel_world_size()
    group = group or (hcg.get_data_parallel_group() if hcg is not None
                      else data_group())
    div = div or group.nranks
    grads = [p.grad for p in parameter_list
             if getattr(p, "grad", None) is not None]
    if not grads or group.nranks == 1:
        return
    bucketed_all_reduce(grads, group=group)
    if div > 1:
        for g in grads:
            g.mul_(1.0 / div)


def _broadcast(model, group):
    from ...parallel import broadcast_module

    broadcast_module(model, group)


def broadcast_dp_parameters(model, hcg):
    _broadcast(model, hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    _broadcast(model, hcg.get_sharding_parallel_group())


@torch.no_grad()
def broadcast_mp_parameters(model, hcg):
    group = hcg.get_model_parallel_group()
    if group.nranks == 1:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        if not is_block(t):
            broadcast(t.data, 0, group)


def broadcast_sep_parameters(model, hcg):
    group = hcg.get_sep_parallel_group()
    if group is not None:
        _broadcast(model, group)


@torch.no_grad()
def broadcast_input_data(hcg, *inputs, **kwargs):
    """Group rank 0's tensors (in ``inputs`` and ``kwargs``) to the
    model-parallel group, in place; the rest as they are."""
    group = hcg.get_model_parallel_group()
    if group.nranks > 1:
        for t in list(inputs) + list(kwargs.values()):
            if isinstance(t, torch.Tensor):
                broadcast(t, 0, group)
    return inputs if not kwargs else (inputs, kwargs)
