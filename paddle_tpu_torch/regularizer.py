"""paddle.regularizer: the port of paddle_tpu/regularizer.py. ``L1Decay``
and ``L2Decay`` carry their coefficient; an optimizer's
``weight_decay`` reads it (``_coeff``), and a parameter's own
(`nn.ParamAttr(regularizer=...)`) exempts it from the optimizer's L2
decay, as in the reference."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param."""


class L1Decay(WeightDecayRegularizer):
    """Its coefficient; as the reference's optimizer does, the port's
    folds it in as ``coeff * param``."""
