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

`prefetch` wraps a loader in an `io.DevicePrefetcher` bound to the
step's device, so the next batches' host-to-device copies overlap the
running step.

The constructor takes the reference's arguments in its order:
``donate`` is accepted and does nothing (the step updates the state in
place), ``accum_steps`` overrides ``accumulate_steps`` as in the
reference, and ``numerics`` (the training-numerics monitor) raises until
ROADMAP queue A7 ports it. The step runs eagerly: the reference's jit,
retrace sentinel, compile cache and sharding are not ported. The returned loss
stays on the device, and nothing is read back to the host, guarded or
not: the gate is a device flag the optimizer's kernels read (see
`nonfinite_guard`).
"""
from __future__ import annotations

import torch

from ..io.device_prefetcher import DevicePrefetcher
from ..optimizer.optimizer import _select_back
from .nonfinite_guard import GuardSpec

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, donate=True,
                 accumulate_steps=1, accum_steps=None, scaler=None,
                 guard_nonfinite=None, numerics=None):
        del donate          # the state is updated in place
        if numerics is not None:
            raise NotImplementedError(
                "TrainStep(numerics=...) is not ported yet: ROADMAP queue "
                "A7 (the numerics monitor)")
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
        if acc > 1:
            losses = []
            for micro in self._split(batch):
                ml = self.loss_fn(self.model, *micro) * (1.0 / acc)
                backward(ml)
                losses.append(ml.detach())
            loss = torch.stack(losses).sum()
        else:
            loss = self.loss_fn(self.model, *batch)
            backward(loss)
            loss = loss.detach()

        if guard is None:
            self.optimizer.step()
        else:
            found = self.optimizer._guarded_step(
                None if scale is None else torch.reciprocal(scale))
            _select_back(found, buffers)
        self.optimizer.clear_grad()
        if guard is not None:
            self._guard_state = guard.update(self._guard_state, found)
            guard.writeback(self._guard_state)
        sched = getattr(self.optimizer, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()
        return loss
