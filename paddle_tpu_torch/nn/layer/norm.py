"""Batch norm layers: the port of paddle_tpu/nn/layer/norm.py's
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D``.

Parameters ``weight`` (ones) and ``bias`` (zeros); persistable buffers
``_mean`` (zeros) and ``_variance`` (ones), the reference's names, and
no ``num_batches_tracked``, so state-dict names match the reference's.
``momentum`` is Paddle's (the share of the old running value kept); see
`nn.functional.batch_norm`.
"""
from __future__ import annotations

import torch

from .. import functional as PF
from .layers import wants_parameter

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"]


class _BatchNormBase(torch.nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        factory = dict(device=device, dtype=dtype)
        self.weight = (torch.nn.Parameter(
                           torch.ones(num_features, **factory))
                       if wants_parameter(weight_attr, "weight_attr")
                       else None)
        self.bias = (torch.nn.Parameter(
                         torch.zeros(num_features, **factory))
                     if wants_parameter(bias_attr, "bias_attr") else None)
        self.register_buffer("_mean", torch.zeros(num_features, **factory))
        self.register_buffer("_variance",
                             torch.ones(num_features, **factory))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return PF.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
