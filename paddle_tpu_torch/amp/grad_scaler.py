"""Dynamic loss scaling: the port of paddle_tpu/amp/grad_scaler.py's
``AmpScaler`` / ``GradScaler``.

The scaler holds the configuration and the state: the scale, the
incr/decr ratios, ``incr_every_n_steps``, ``decr_every_n_nan_or_inf``,
the good and bad step counters and the last step's found-inf flag.

Two ways to use it, as in the reference:

* bound to `jit.TrainStep` (``scaler=``): the step's guard
  (`jit.nonfinite_guard.GuardSpec`) owns the update rule, runs it on the
  device and writes the state back after every step as device scalars;
  `state_dict` reads them as plain numbers.
* the eager loop: ``scaler.scale(loss).backward()``, then
  ``scaler.minimize(opt, loss)`` or ``scaler.step(opt)`` +
  ``scaler.update()``. `unscale_` unscales every grad in one pass
  (`ops.kernels.multi_tensor.multi_tensor_norm`: the unscale written in
  place with the reference's rounding and ``found_inf`` as a device flag,
  one flag over the optimizer's ``_found_group`` where it has one), and
  the step decision reads the flag back once (`_found`, the reference's
  single host read).
"""
from __future__ import annotations

import enum

import torch

from ..ops.kernels.multi_tensor import multi_tensor_norm

__all__ = ["AmpScaler", "GradScaler", "OptimizerState"]


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale(self, optimizer):
        """Unscale every grad of ``optimizer`` in place, once a step, and
        keep ``found_inf`` as a device flag (judged on the scaled grads)."""
        if not self._enable:
            return
        if self._opt_states.get(id(optimizer)) == OptimizerState.UNSCALED:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if grads:
            from ..nn.clip import any_over

            inv = torch.full((), 1.0 / float(self._scale),
                             dtype=torch.float32, device=grads[0].device)
            _, found = multi_tensor_norm(grads, inv_scale=inv, write=True)
            # one flag over the ranks whose grads differ (a hybrid-
            # parallel optimizer's pp x mp group)
            self._found_inf = any_over(
                found, getattr(optimizer, "_found_group", None))
        else:
            self._found_inf = False
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    def unscale_(self, optimizer):
        return self._unscale(optimizer)

    def _found(self):
        """The single device-to-host read of ``found_inf``."""
        self._found_inf = bool(self._found_inf)
        return self._found_inf

    def minimize(self, optimizer, loss, *args, **kwargs):
        self._unscale(optimizer)
        if not self._found():
            optimizer.step()
        self._update()
        self._opt_states.pop(id(optimizer), None)
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found():
            optimizer.step()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable:
            return
        self._update()
        self._opt_states.clear()

    def _update(self):
        if not self._use_dynamic:
            return
        if self._found():
            self._bad_steps = int(self._bad_steps) + 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(float(self._scale) * self._decr_ratio,
                                  1.0)
                self._bad_steps = 0
        else:
            self._good_steps = int(self._good_steps) + 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale = float(self._scale) * self._incr_ratio
                self._good_steps = 0

    def get_loss_scaling(self):
        return float(self._scale)

    def set_init_loss_scaling(self, value):
        self._scale = float(value)

    def state_dict(self):
        return {
            "scale": float(self._scale),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": int(self._good_steps),
            "bad_steps": int(self._bad_steps),
            "use_dynamic_loss_scaling": bool(self._use_dynamic),
        }

    def load_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))
        self._use_dynamic = bool(state.get("use_dynamic_loss_scaling",
                                           self._use_dynamic))


class GradScaler(AmpScaler):
    """Public name (paddle.amp.GradScaler)."""
