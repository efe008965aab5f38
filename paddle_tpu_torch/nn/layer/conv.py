"""``Conv2D``: the port of paddle_tpu/nn/layer/conv.py's 2-D convolution
layer. Weight ``[out, in / groups, kh, kw]`` and bias drawn by default
from Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in / groups *
kh * kw, as in the reference; ``weight_attr`` / ``bias_attr`` take what
the reference's take (`layers.ParamAttr`)."""
from __future__ import annotations

import math

import torch

from .. import functional as PF
from ..initializer import Uniform
from .layers import create_parameter

__all__ = ["Conv2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(torch.nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D padding_mode={padding_mode!r} is not ported yet: "
                "ROADMAP queue A10")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        kw = dict(dtype=dtype, device=device, generator=generator,
                  default_initializer=Uniform(-bound, bound))
        self.weight = create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            weight_attr, **kw)
        self.bias = create_parameter([out_channels], bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x):
        return PF.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
