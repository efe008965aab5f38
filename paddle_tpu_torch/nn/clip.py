"""Gradient clipping: the port of paddle_tpu/nn/clip.py.

A clip is called by `optimizer.Optimizer.step` on the ``(param, grad)``
pairs it is about to apply and returns the pairs to apply. Parameters
with ``need_clip = False`` are neither counted nor changed.

* `ClipGradByGlobalNorm`: the fp32 global norm of the grads as stored
  (bf16 grads stay bf16: the norm upcasts, the grads do not) comes from
  `ops.kernels.multi_tensor.multi_tensor_norm` (one kernel launch on the
  card), ``scale = min(clip_norm / max(norm, 1e-12), 1)``, and every grad
  is scaled and rounded back to its own dtype into a new tensor, as the
  reference returns new arrays: the caller's grads stay as they were.
  `optimizer.Optimizer.step` does not call it: it takes the same norm and
  scales each grad as its update reads it (`scaled`), and `optimizer.Adam`'s
  fused step folds the scale into its update kernel with the same rounding.
* `norm_stats` is that norm with the guard's flag over grads a rank
  holds only a shard of (sharding's reduce-scattered grads): the local
  sum of squares and flag are all-reduced over the group in one
  collective on the device before the scale is taken, so every rank
  clips by the global norm and skips together.
* `mp_norm_stats` is the global norm over a model-parallel group, where
  a distributed parameter (``is_distributed``: an mpu layer's block) is
  a block a rank and a replicated one (LayerNorms, a row-parallel bias)
  whole on every rank: the blocks' sums of squares are all-reduced over
  the group, the replicated ones counted once, so the norm is the
  reference's norm of the global parameters
  (`distributed.fleet.HybridParallelOptimizer` clips by it).
* `ClipGradByValue`, `ClipGradByNorm` (each grad by its own norm) and
  `clip_grad_norm_` (the torch-style utility over parameters), plain
  tensor code as the reference runs them; the first two return new grads.
"""
from __future__ import annotations

import torch

from ..ops.kernels.multi_tensor import multi_tensor_norm

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "mp_norm_stats",
           "norm_stats"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = g.float().square().sum().sqrt()
                scale = (torch.full((), self.clip_norm, device=g.device)
                         / norm.clamp(min=1e-12)).clamp(max=1.0)
                g = (g.float() * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        # (sum of squares, scale)
        stats, _ = multi_tensor_norm(grads, clip_norm=self.clip_norm)
        return [(p, scaled(g, stats[1]) if _clipped(p, g) else g)
                for p, g in params_grads]


def norm_stats(grads, need_clip, inv_scale, clip_norm, group, device=None,
               blocks=None, mp_group=None, pp_group=None):
    """``(sum of squares, clip scale, found_inf)`` as device scalars, like
    `multi_tensor_norm`'s, with the sum and the flag all-reduced over
    ``group`` (a `distributed.collective.Group`) first, in one
    collective: the clip's global norm and the guard's flag over the
    ranks' shards. With a model-parallel ``mp_group`` of more than one
    rank, the grads flagged in ``blocks`` are shards of blocks
    (`is_block`): their sum and the flag are all-reduced over it too,
    and the replicated grads' sum is added once, as `mp_norm_stats`
    counts them. With a ``pp_group`` of more than one rank (each stage
    holds its own layers) the sum and the flag are summed over it last.
    No host read."""
    from ..distributed.collective import ReduceOp, all_reduce

    if mp_group is None or mp_group.nranks == 1:
        stats, found = multi_tensor_norm(grads, need_clip, inv_scale,
                                         device=device)
        tot = torch.stack([stats[0], found.float()])
        all_reduce(tot, ReduceOp.SUM, group)
    else:
        stats, found = multi_tensor_norm(
            grads, [c and b for c, b in zip(need_clip, blocks)], inv_scale,
            device=device)
        rep = multi_tensor_norm(
            grads, [c and not b for c, b in zip(need_clip, blocks)],
            inv_scale, device=device)[0]
        both = torch.stack([stats[0], found.float(), rep[0]])
        all_reduce(both, ReduceOp.SUM, group)
        tot = both[:2].clone()
        all_reduce(tot, ReduceOp.SUM, mp_group)
        tot[0] += both[2]
    if pp_group is not None and pp_group.nranks > 1:
        all_reduce(tot, ReduceOp.SUM, pp_group)
    scale = torch.ones_like(tot[0])
    if clip_norm is not None:
        norm = tot[0].sqrt().clamp(min=1e-12)
        scale = (torch.full_like(norm, clip_norm) / norm).clamp(max=1.0)
    return tot[0], scale, tot[1] > 0


def is_block(p):
    """Whether ``p`` is a rank's block of a model-parallel parameter
    (Paddle's ``is_distributed`` flag; torch tensors also have an
    ``is_distributed`` method, which is no flag)."""
    return getattr(p, "is_distributed", False) is True


def is_stage_copy(p):
    """Whether ``p`` is a pipeline stage's copy of a weight that an
    earlier stage also holds (a `SharedLayerDesc` layer's): a global norm
    counts it on the first stage alone."""
    return getattr(p, "is_stage_copy", False) is True


def mp_norm_stats(params_grads, clip_norm, group, pp_group=None):
    """``(sum of squares, clip scale)`` as device scalars of the clipped
    (``need_clip``) grads of ``params_grads`` over a model-parallel
    ``group``: the distributed parameters' squares summed over the group
    (one all-reduce), the replicated ones' added once; with a
    ``pp_group`` of more than one rank, that sum summed over the stages
    (a stage's copy of a shared weight left out: `is_stage_copy`)."""
    from ..distributed.collective import ReduceOp, all_reduce

    kept = [(p, g) for p, g in params_grads
            if _clipped(p, g) and not is_stage_copy(p)]
    dev = kept[0][1].device if kept else None
    dist = [g for p, g in kept if is_block(p)]
    rep = [g for p, g in kept if not is_block(p)]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sq_d = multi_tensor_norm(dist, device=dev)[0][0] if dist else zero
    sq_d = sq_d.clone()
    if group is not None and group.nranks > 1:
        all_reduce(sq_d, ReduceOp.SUM, group)
    sq = sq_d + (multi_tensor_norm(rep, device=dev)[0][0] if rep else zero)
    if pp_group is not None and pp_group.nranks > 1:
        all_reduce(sq, ReduceOp.SUM, pp_group)
    norm = sq.sqrt().clamp(min=1e-12)
    return sq, (torch.full_like(norm, clip_norm) / norm).clamp(max=1.0)


def any_over(found, group):
    """``found`` (a device bool) made one flag over ``group``: set on
    every rank where it is set on one (an all-reduce MAX, no host
    read)."""
    from ..distributed.collective import ReduceOp, all_reduce

    if group is None or group.nranks == 1:
        return found
    t = found.float().reshape(1)
    all_reduce(t, ReduceOp.MAX, group)
    return t[0] > 0


def scaled(g, scale):
    """``g * scale`` in fp32, rounded to g's dtype, as a new tensor. (A
    multiply of a bf16 tensor by a tensor scale would round ``scale`` to
    bf16 first.)"""
    if g.dtype == torch.float32:
        return g * scale
    return g.float().mul_(scale).to(g.dtype)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """paddle.nn.utils.clip_grad_norm_: scale every grad in place so
    their joint ``norm_type`` norm is at most ``max_norm``; returns the
    norm before clipping (a device scalar)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    dev = params[0].grad.device
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = sum(p.grad.float().abs().pow(norm_type).sum()
                    for p in params).pow(1.0 / norm_type)
    scale = (torch.full((), max_norm, device=dev)
             / total.clamp(min=1e-12)).clamp(max=1.0)
    for p in params:
        p.grad.copy_((p.grad.float() * scale).to(p.grad.dtype))
    return total
