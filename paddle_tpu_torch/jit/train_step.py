"""The training step: the port of paddle_tpu/jit/train_step.py's
``TrainStep``.

    step = TrainStep(model, lambda m, ids, labels: m.loss(ids, labels), opt)
    for ids, labels in batches:
        loss = step(ids, labels)      # a device tensor

One call runs, in the reference's order (train_step.py ``step_fn``):

1. the forward and the backward of ``loss * scale`` (``scale`` is the
   bound GradScaler's loss scale, else no scaling);
2. with ``accumulate_steps`` > 1, the batch's dim 0 split into that
   many micro-batches, each loss scaled by ``1 / accumulate_steps`` and
   its backward accumulated on the parameters' grads;
3. with a guard (``scaler`` or ``guard_nonfinite``), the optimizer's
   gated step (`optimizer.Optimizer._guarded_step`): one finiteness check
   over the (still scaled) grads, the unscale, the grad clip and the
   update, which a step whose grads were not finite skips on the device,
   so nothing of the optimizer's state moves (parameters, masters,
   moments, the step count); the model's buffers (batch norm's running
   statistics, which the forward moves) are selected back to their
   values from before the forward by the same flag, as the reference's
   state includes them; without a guard, ``optimizer.step()`` (its
   grad clip first); then ``clear_grad``;
4. the guard state advances by `GuardSpec.update` from the device flag;
5. an `optimizer.lr.LRScheduler` driving the optimizer's learning rate
   takes one step, as the reference's step advances its host-side
   schedulers.

Distributed (the collective seam): after the last micro-batch's
backward the step calls the model's ``apply_collective_grads`` where it
has one, as the reference does (train_step.py:349-350): `DataParallel`
averages the grads over its group there (the micro-batches before the
last run under its ``no_sync``), `GroupShardedStage2` reduce-scatters
them into the optimizer's shards, and `GroupShardedStage3` scatters
what its hooks have not yet (its sharded buckets' grads are scattered
as each micro-batch's backward completes them). Under a sharded optimizer
(`DygraphShardingOptimizer`) the guard's flag and the clip's sum of
squares are all-reduced on the device before they are used (a rank that
sees an inf makes every rank skip), and so are the numerics monitor's
grad rows. The returned loss is the group's mean (an all-reduce on the
device), as the reference's global loss is.

With ``numerics`` (default: ``FLAGS_numerics_monitor``, on, as in the
reference) the step also fills the reference's per-parameter stats block
on the device (one row a trainable parameter: the unscaled grad's, the
parameter's and the update's squared norms and the grad's finiteness,
`observability.numerics`), from the grads before the update and a copy
of the parameters kept across it, and hands it to a `NumericsMonitor`
(``step.numerics``), which reads it back lazily.

`prefetch` wraps a loader in an `io.DevicePrefetcher` bound to the
step's device, so the next batches' host-to-device copies overlap the
running step.

The constructor takes the reference's arguments in its order:
``donate`` is accepted and does nothing (the step updates the state in
place), and ``accum_steps`` overrides ``accumulate_steps`` as in the
reference. The step runs eagerly: the reference's jit,
retrace sentinel and compile cache have no counterpart here. The returned loss
stays on the device, and nothing is read back to the host, guarded or
not: the gate is a device flag the optimizer's kernels read (see
`nonfinite_guard`).
"""
from __future__ import annotations

import contextlib

import torch

from ..distributed.collective import ReduceOp, all_reduce
from ..io.device_prefetcher import DevicePrefetcher
from ..observability.numerics import NumericsMonitor, monitor_enabled
from ..optimizer.optimizer import _select_back
from .nonfinite_guard import GuardSpec

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, donate=True,
                 accumulate_steps=1, accum_steps=None, scaler=None,
                 guard_nonfinite=None, numerics=None):
        del donate          # the state is updated in place
        if accum_steps is not None:
            if int(accumulate_steps) not in (1, int(accum_steps)):
                raise ValueError(
                    f"conflicting accumulate_steps={accumulate_steps} "
                    f"and accum_steps={accum_steps}")
            accumulate_steps = accum_steps
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = int(accumulate_steps)
        self.guard = (GuardSpec(scaler)
                      if (scaler is not None or guard_nonfinite) else None)
        self._guard_state = None
        self.numerics = None
        if numerics if numerics is not None else monitor_enabled():
            named = [(n, p) for n, p in model.named_parameters()
                     if p.requires_grad]
            if named:
                self.numerics = NumericsMonitor(
                    type(self).__name__, len(named),
                    row_labels=[n for n, _ in named])

    def prefetch(self, loader, depth=2, **kw):
        """``loader`` wrapped in an `io.DevicePrefetcher` that stages its
        batches on this step's device (that of the model's parameters)
        while the previous step runs::

            for x, y in step.prefetch(loader):
                loss = step(x, y)
        """
        kw.setdefault("device", next(self.model.parameters()).device)
        return DevicePrefetcher(loader, depth=depth, **kw)

    def _split(self, batch):
        acc = self.accumulate_steps
        sizes = {t.shape[0] for t in batch
                 if isinstance(t, torch.Tensor) and t.dim() > 0}
        if len(sizes) > 1:
            raise ValueError(
                f"accumulate_steps={acc} needs all batch tensors "
                f"batch-major with one shared dim-0 size; got {sizes}")
        if sizes and next(iter(sizes)) % acc:
            raise ValueError(
                f"batch size {next(iter(sizes))} is not divisible by "
                f"accumulate_steps={acc}")
        return [[t.reshape(acc, t.shape[0] // acc, *t.shape[1:])[m]
                 if isinstance(t, torch.Tensor) and t.dim() > 0 else t
                 for t in batch] for m in range(acc)]

    def __call__(self, *batch):
        params = [p for p in self.model.parameters() if p.requires_grad]
        guard = self.guard
        scale = None
        if guard is not None:
            if self._guard_state is None:
                self._guard_state = guard.init_state(params[0].device)
            if guard.scaling:
                scale = self._guard_state["scale"]
            # the forward moves the buffers (running statistics): their
            # old values, for the gate
            buffers = [(b, b.clone()) for b in self.model.buffers()]

        def backward(loss):
            (loss if scale is None else loss * scale.to(loss.dtype)) \
                .backward()

        acc = self.accumulate_steps
        model = self.model
        if acc > 1:
            losses = []
            no_sync = getattr(model, "no_sync", contextlib.nullcontext)
            for m, micro in enumerate(self._split(batch)):
                with (no_sync() if m < acc - 1
                      else contextlib.nullcontext()):
                    ml = self.loss_fn(model, *micro) * (1.0 / acc)
                    backward(ml)
                losses.append(ml.detach())
            loss = torch.stack(losses).sum()
        else:
            loss = self.loss_fn(model, *batch)
            backward(loss)
            loss = loss.detach()
        sync = getattr(model, "apply_collective_grads", None)
        if sync is not None:
            sync()
        group = (getattr(model, "_comm_group", None)
                 or getattr(self.optimizer, "_comm_group", None))
        if group is not None:
            all_reduce(loss, ReduceOp.AVG, group)

        inv = None if scale is None else torch.reciprocal(scale)
        if self.numerics is not None:
            rows = _numerics_before(params, inv, self.optimizer)
        if guard is None:
            self.optimizer.step()
        else:
            found = self.optimizer._guarded_step(inv)
            _select_back(found, buffers)
        if self.numerics is not None:
            self.numerics.on_step(_numerics_after(params, rows,
                                                  self.optimizer))
        self.optimizer.clear_grad()
        if guard is not None:
            self._guard_state = guard.update(self._guard_state, found)
            guard.writeback(self._guard_state)
        sched = getattr(self.optimizer, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()
        return loss


def _numerics_before(params, inv, optimizer=None):
    """The rows' fields known before the update: each grad's squared norm
    (unscaled by ``inv``; under a sharded optimizer from the rank's
    shards and one all-reduce), the parameter's, and a copy of the
    parameters for the update's norm."""
    f32 = torch.float32
    if getattr(optimizer, "_s3", None):
        # stage 3: the parameters are shards between uses
        return optimizer._stage3_rows(params, inv)
    sharded = getattr(optimizer, "_sharded_grad_sq", None)
    if sharded is not None:
        p_sq = torch.stack(torch._foreach_norm(
            [p.detach() for p in params], 2, dtype=f32)).square()
        return (sharded(params, inv), p_sq,
                [p.detach().clone() for p in params])
    zero = torch.zeros((), dtype=f32, device=params[0].device)
    have = [i for i, p in enumerate(params)
            if p.grad is not None and p.grad.is_floating_point()]
    g_sq = [zero] * len(params)
    norms = torch._foreach_norm([params[i].grad for i in have], 2,
                                dtype=f32) if have else []
    for i, n in zip(have, norms):
        g_sq[i] = n.square() if inv is None else n.square() * inv * inv
    p_sq = torch.stack(torch._foreach_norm(
        [p.detach() for p in params], 2, dtype=f32)).square()
    return torch.stack(g_sq), p_sq, [p.detach().clone() for p in params]


def _numerics_after(params, rows, optimizer=None):
    """The ``[parameters, NFIELDS]`` block: the update's squared norm
    from the copy (0 where the guard skipped the step: the parameters did
    not move; under stage 3 from the shards' copy); finiteness from the
    grad's square-sum, as the reference derives it."""
    g_sq, p_sq, old = rows
    if getattr(optimizer, "_s3", None):
        u_sq = optimizer._stage3_update_sq(params, old)
    else:
        torch._foreach_sub_(old, [p.detach() for p in params])
        u_sq = torch.stack(torch._foreach_norm(
            old, 2, dtype=torch.float32)).square()
    z = torch.zeros_like(g_sq)
    return torch.stack([g_sq, p_sq, u_sq, z, z,
                        (~torch.isfinite(g_sq)).float(), z, z], dim=1)
