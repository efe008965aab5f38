"""Activation layers: the port of paddle_tpu/nn/layer/activation.py,
each over its `nn.functional` counterpart (``PReLU`` holds its slopes as
a parameter, ``RReLU`` draws in training)."""
from __future__ import annotations

from .. import functional as PF
from ..initializer import Constant
from .layers import Layer

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


def _simple(name, fn, doc):
    def forward(self, x):
        return fn(x)

    def __init__(self, name=None):
        Layer.__init__(self)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__doc__": doc, "__module__": __name__})


ReLU = _simple("ReLU", PF.relu, "max(x, 0).")
ReLU6 = _simple("ReLU6", PF.relu6, "min(max(x, 0), 6).")
Sigmoid = _simple("Sigmoid", PF.sigmoid, "1 / (1 + exp(-x)).")
Tanh = _simple("Tanh", PF.tanh, "tanh(x).")
Silu = _simple("Silu", PF.silu, "x * sigmoid(x).")
Swish = _simple("Swish", PF.swish, "x * sigmoid(x).")
Mish = _simple("Mish", PF.mish, "x * tanh(softplus(x)).")
Hardswish = _simple("Hardswish", PF.hardswish, "x * clip(x + 3, 0, 6) / 6.")
Hardsigmoid = _simple("Hardsigmoid", PF.hardsigmoid,
                      "clip(x / 6 + 0.5, 0, 1).")
Softsign = _simple("Softsign", PF.softsign, "x / (1 + |x|).")
Tanhshrink = _simple("Tanhshrink", PF.tanhshrink, "x - tanh(x).")
LogSigmoid = _simple("LogSigmoid", PF.log_sigmoid, "-softplus(-x).")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return PF.gelu(x, self._approximate)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return PF.hardtanh(x, self._min, self._max)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return PF.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return PF.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return PF.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return PF.celu(x, self._alpha)


class PReLU(Layer):
    """Learned slopes ``weight [num_parameters]`` (init ``init``)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, dtype=dtype,
            default_initializer=Constant(init), device=device,
            generator=generator)

    def forward(self, x):
        return PF.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None, *,
                 generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self._generator = generator

    def forward(self, x):
        return PF.rrelu(x, self._lower, self._upper, self.training,
                        generator=self._generator)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return PF.softplus(x, self._beta, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return PF.softshrink(x, self._threshold)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return PF.hardshrink(x, self._threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return PF.thresholded_relu(x, self._threshold, self._value)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return PF.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return PF.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return PF.maxout(x, self._groups, self._axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return PF.glu(x, self._axis)
