"""Non-finite step guard and dynamic loss scale: the port of
paddle_tpu/jit/nonfinite_guard.py.

* `all_finite(grads)`: one finiteness reduction over all the grads, a
  device scalar.
* `GuardSpec`: the guard's configuration, mirrored from a bound
  `amp.GradScaler` (without one it only gates, with the scale pinned at
  1.0), and `GuardSpec.update`, the reference's rule word for word over
  device scalars.

The gate is the reference's, on the device: `jit.TrainStep` hands the
optimizer's gated step (`optimizer.Optimizer._guarded_step`) the inverse
loss scale, the step finds ``found_inf`` in one pass over the grads
(`ops.kernels.multi_tensor.multi_tensor_norm`) and skips the update where
it is set without reading it back: the fused Adam/AdamW kernel writes
nothing, and the per-parameter optimizers select their old state with
``torch.where``, as the reference's ``gate`` does. Parameters, masters,
moments and the step count stay bit-identical, and `GuardSpec.update`
advances the scale and the counters from the same device flag. A guarded
step makes no host sync.
"""
from __future__ import annotations

import torch

__all__ = ["GuardSpec", "all_finite"]


def all_finite(grads) -> torch.Tensor:
    """True (a 0-dim bool tensor on the grads' device) iff every element
    of every floating grad is finite."""
    flags = [torch.isfinite(g).all() for g in grads
             if g is not None and g.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


class GuardSpec:
    """Static configuration of the guard, mirrored from a GradScaler when
    one is bound; its scale and counters are carried as device scalars by
    `init_state` / `update` and written back by `writeback`."""

    def __init__(self, scaler=None):
        self.scaler = scaler if (scaler is not None
                                 and scaler.is_enable()) else None
        s = self.scaler
        self.scaling = s is not None
        self.use_dynamic = bool(s and s._use_dynamic)
        self.incr_ratio = float(s._incr_ratio) if s else 2.0
        self.decr_ratio = float(s._decr_ratio) if s else 0.5
        self.incr_every_n = int(s._incr_every_n_steps) if s else 0
        self.decr_every_n = int(s._decr_every_n_nan_or_inf) if s else 1
        self.skipped = 0

    def init_state(self, device):
        s = self.scaler

        def dev(v, dt):
            return torch.as_tensor(v, dtype=dt, device=device)

        return {
            "scale": dev(s._scale if s else 1.0, torch.float32),
            "good": dev(s._good_steps if s else 0, torch.int32),
            "bad": dev(s._bad_steps if s else 0, torch.int32),
            "found": dev(s._found_inf if s else False, torch.bool),
            "skipped": dev(self.skipped, torch.int32),
        }

    def writeback(self, gst):
        if self.scaler is not None:
            self.scaler._scale = gst["scale"]
            self.scaler._good_steps = gst["good"]
            self.scaler._bad_steps = gst["bad"]
            self.scaler._found_inf = gst["found"]
        self.skipped = gst["skipped"]

    def update(self, gst, found_inf):
        """The next guard state after a step whose grads were (not)
        finite: halve (``decr_ratio``, floor 1.0) after
        ``decr_every_n`` bad steps, grow ``incr_ratio``-fold after
        ``incr_every_n`` good ones."""
        scale, good, bad = gst["scale"], gst["good"], gst["bad"]
        found = torch.as_tensor(found_inf, dtype=torch.bool,
                                device=scale.device)
        skipped = gst["skipped"] + found.to(torch.int32)
        zero = torch.zeros_like(good)
        if not self.use_dynamic:
            return {"scale": scale,
                    "good": torch.where(found, zero, good + 1),
                    "bad": torch.where(found, bad + 1, zero),
                    "found": found, "skipped": skipped}
        bad1 = bad + 1
        good1 = good + 1
        dec = bad1 >= self.decr_every_n
        inc = (good1 >= self.incr_every_n) if self.incr_every_n > 0 \
            else torch.zeros_like(found)
        new_scale = torch.where(
            found,
            torch.where(dec, torch.clamp(scale * self.decr_ratio, min=1.0),
                        scale),
            torch.where(inc, scale * self.incr_ratio, scale))
        new_good = torch.where(found, zero, torch.where(inc, zero, good1))
        new_bad = torch.where(found, torch.where(dec, zero, bad1), zero)
        return {"scale": new_scale, "good": new_good, "bad": new_bad,
                "found": found, "skipped": skipped}
