"""Megatron's communication operators as ``torch.autograd.Function``s:
the port of the reference's comm PyLayers (``_c_identity``, ``_c_split``,
``_c_concat``, ``_mp_allreduce``, Paddle's ``mp_ops.py:91-341``).

The reference holds each tensor at its global shape and lets GSPMD write
the collectives; here a rank holds its block and the operators are
written by hand, each the transpose of the other in its backward:

* `c_identity` (Megatron's f): identity forward, all-reduce of the grad
  over the group backward: the input of a column-parallel product, whose
  grad is this rank's part of the sum;
* `mp_allreduce` (g): all-reduce forward, identity backward: the output
  of a row-parallel product;
* `c_split`: this rank's block of the last dim forward, the blocks
  gathered backward;
* `c_concat`: the ranks' blocks gathered along the last dim forward,
  this rank's block of the grad backward;
* `combine_lse`: a vocab-parallel cross entropy's global log-sum-exp and
  label logit from every rank's (no autograd: the callers' backwards
  take the global lse).

``group`` is a `distributed.collective.Group` (default: the fleet's
model-parallel group). A group of one rank makes each an identity.
"""
from __future__ import annotations

import torch

from ....collective import ReduceOp, all_gather_concat, all_reduce

__all__ = ["c_concat", "c_identity", "c_split", "combine_lse",
           "mp_allreduce", "mp_group"]


def mp_group(group=None):
    """``group``, else the fleet's model-parallel group (None without
    one: a world of one)."""
    if group is not None:
        return group
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def _n(group):
    return 1 if group is None else group.nranks


def _summed(t, group):
    t = t.contiguous().clone()
    all_reduce(t, ReduceOp.SUM, group)
    return t


def _block(t, group):
    n, r = group.nranks, group.rank
    w = t.shape[-1] // n
    return t[..., r * w:(r + 1) * w].contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_concat(g.contiguous(), ctx.group,
                                 axis=g.dim() - 1), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_concat(x.contiguous(), group, axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group), None


def c_identity(x, group=None):
    group = mp_group(group)
    return x if _n(group) == 1 else _CIdentity.apply(x, group)


def mp_allreduce(x, group=None):
    group = mp_group(group)
    return x if _n(group) == 1 else _MpAllreduce.apply(x, group)


def c_split(x, group=None):
    group = mp_group(group)
    return x if _n(group) == 1 else _CSplit.apply(x, group)


def c_concat(x, group=None):
    group = mp_group(group)
    return x if _n(group) == 1 else _CConcat.apply(x, group)


def combine_lse(lse_r, picked_r, group):
    """The global ``(lse, picked)`` from every rank's (its columns'
    log-sum-exp, and the label's logit where the label is in them, else
    0): the max of ``lse_r`` over the group, then one all-reduce of
    ``[exp(lse_r - max), picked_r]`` (the reference's pmax and stacked
    psum)."""
    mx = lse_r.clone()
    all_reduce(mx, ReduceOp.MAX, group)
    both = torch.stack([torch.exp(lse_r - mx), picked_r])
    all_reduce(both, ReduceOp.SUM, group)
    return mx + torch.log(both[0]), both[1]
