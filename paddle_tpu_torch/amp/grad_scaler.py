"""Dynamic loss scaling state: the port of paddle_tpu/amp/grad_scaler.py's
``AmpScaler`` / ``GradScaler`` as `jit.TrainStep` binds it (``scaler=``).

The scaler holds the configuration and the state: the scale, the
incr/decr ratios, ``incr_every_n_steps``, ``decr_every_n_nan_or_inf``,
the good and bad step counters and the last step's found-inf flag. The
step that binds it (`jit.nonfinite_guard.GuardSpec`) owns the update
rule and writes the state back after every step as device scalars;
`state_dict` reads them as plain numbers. The eager
``minimize``/``step``/``update`` loop of the reference is not ported.
"""
from __future__ import annotations

__all__ = ["AmpScaler", "GradScaler"]


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

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return float(self._scale)

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
