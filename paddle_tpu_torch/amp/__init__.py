"""Automatic mixed precision: the port of paddle_tpu/amp's ``decorate``
(level O2) and the ``GradScaler`` state that `jit.TrainStep` binds."""
from .auto_cast import auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "auto_cast", "decorate"]
