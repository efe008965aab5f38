"""Activation functionals: the port of paddle_tpu/nn/functional/
activation.py. Elementwise aten ops, as the reference's are single XLA
ops; each keeps the reference's formula (Paddle's parameter names and
defaults, which are not always torch's: ``hardsigmoid``'s slope 1/6,
``thresholded_relu``'s ``value``, ``gelu``'s bool ``approximate``).
Random ones (``rrelu`` in training, ``gumbel_softmax``) draw from an
explicit ``generator`` (None: torch's default one of the device). The
in-place forms write into ``x``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializer import to_torch_dtype

__all__ = ["celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh", "hardtanh_",
           "leaky_relu", "leaky_relu_", "log_sigmoid", "log_softmax",
           "maxout", "mish", "prelu", "relu", "relu6", "relu_", "rrelu",
           "selu", "sigmoid", "silu", "softmax", "softmax_", "softplus",
           "softshrink", "softsign", "swish", "tanh", "tanh_", "tanhshrink",
           "thresholded_relu", "thresholded_relu_"]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return F.relu6(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return F.silu(x)


def swish(x, name=None):
    return F.silu(x)


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0, 1)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha=alpha)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where >= 0, else ``weight * x``: one slope, or one a channel
    (axis 1 for "NC...", the last for "N...C")."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=False, name=None,
          generator=None):
    """Training: a slope drawn uniformly from ``[lower, upper)`` for each
    element; otherwise the mean slope."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    slope = torch.empty_like(x).uniform_(lower, upper, generator=generator)
    return torch.where(x >= 0, x, slope * x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(beta * x > threshold, x, F.softplus(beta * x) / beta)


def softsign(x, name=None):
    return x / (1 + x.abs())


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def log_sigmoid(x, name=None):
    return -F.softplus(-x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """softmax((x + g) / temperature), g Gumbel noise; ``hard``: the
    one-hot of its argmax in the forward, the soft gradient in the
    backward (straight through)."""
    u = torch.empty_like(x).uniform_(generator=generator)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(axis + 1)


def glu(x, axis=-1, name=None):
    a, b = x.chunk(2, axis)
    return a * torch.sigmoid(b)


def _inplace(fn):
    def inplace(x, *args, **kwargs):
        return x.copy_(fn(x, *args, **kwargs))
    inplace.__name__ = fn.__name__ + "_"
    inplace.__doc__ = f"`{fn.__name__}`, written into ``x``."
    return inplace


relu_ = _inplace(relu)
elu_ = _inplace(elu)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
softmax_ = _inplace(softmax)
tanh_ = _inplace(tanh)
thresholded_relu_ = _inplace(thresholded_relu)
