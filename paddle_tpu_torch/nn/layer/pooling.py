"""Pooling layers: the port of paddle_tpu/nn/layer/pooling.py's
``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D`` (over
`nn.functional.pooling`)."""
from __future__ import annotations

import torch

from .. import functional as PF

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "MaxPool2D"]


class MaxPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, return_mask, ceil_mode,
                      data_format)

    def forward(self, x):
        return PF.max_pool2d(x, *self._args)


class AvgPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive,
                      divisor_override, data_format)

    def forward(self, x):
        return PF.avg_pool2d(x, *self._args)


class AdaptiveAvgPool2D(torch.nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size, self._data_format = output_size, data_format

    def forward(self, x):
        return PF.adaptive_avg_pool2d(x, self._output_size,
                                      self._data_format)
