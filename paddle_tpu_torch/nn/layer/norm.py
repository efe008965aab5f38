"""Norm layers: the port of paddle_tpu/nn/layer/norm.py.

* ``BatchNorm``, ``BatchNorm1D/2D/3D``: parameters ``weight`` (ones) and
  ``bias`` (zeros); persistable buffers ``_mean`` (zeros) and
  ``_variance`` (ones), the reference's names, and no
  ``num_batches_tracked``, so state-dict names match the reference's.
  ``momentum`` is Paddle's (the share of the old running value kept); see
  `nn.functional.batch_norm`.
* ``LayerNorm`` is a ``torch.nn.LayerNorm``, so `amp.decorate` keeps it
  in fp32 as the reference keeps its LayerNorm; it normalises in fp32
  and returns the input's dtype.
* ``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D`` (parameters
  ``scale`` and ``bias``, the reference's names) and
  ``LocalResponseNorm``. `amp.decorate` casts these, as the reference's
  casts every layer but batch norm and LayerNorm; their functionals
  upcast the weights.

``weight_attr`` / ``bias_attr`` take what the reference's take
(`layers.ParamAttr`). ``SyncBatchNorm`` waits for ROADMAP A9b.
"""
from __future__ import annotations

import torch

from .. import functional as PF
from ..initializer import Constant
from .layers import Layer, create_parameter

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm"]


def _weight_and_bias(shape, weight_attr, bias_attr, kw):
    """The reference's norm parameters: a weight of ones and a bias of
    zeros, each left out by an attr of False."""
    return (create_parameter(shape, weight_attr,
                             default_initializer=Constant(1.0), **kw),
            create_parameter(shape, bias_attr, is_bias=True,
                             default_initializer=Constant(0.0), **kw))


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _weight_and_bias(
            [num_features], weight_attr, bias_attr,
            dict(dtype=dtype, device=device, generator=generator))
        factory = dict(device=device, dtype=dtype)
        self.register_buffer("_mean", torch.zeros(num_features, **factory))
        self.register_buffer("_variance",
                             torch.ones(num_features, **factory))

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


class LayerNorm(torch.nn.LayerNorm):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        torch.nn.Module.__init__(self)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(normalized_shape)
        self.eps = epsilon
        self.elementwise_affine = weight_attr is not False
        self.weight, self.bias = _weight_and_bias(
            list(normalized_shape), weight_attr, bias_attr,
            dict(dtype=dtype, device=device, generator=generator))

    def forward(self, input):
        return PF.layer_norm(input, self.normalized_shape, self.weight,
                             self.bias, self.eps)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, dtype=dtype,
            default_initializer=Constant(1.0), device=device,
            generator=generator)

    def forward(self, input):
        return PF.rms_norm(input, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        self.weight, self.bias = _weight_and_bias(
            [num_channels], weight_attr, bias_attr,
            dict(dtype=dtype, device=device, generator=generator))

    def forward(self, input):
        return PF.group_norm(input, self._num_groups, self._epsilon,
                             self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale, self.bias = _weight_and_bias(
            [num_features], weight_attr, bias_attr,
            dict(dtype=dtype, device=device, generator=generator))

    def forward(self, input):
        return PF.instance_norm(input, weight=self.scale, bias=self.bias,
                                eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, input):
        return PF.local_response_norm(input, self.size, self.alpha,
                                      self.beta, self.k, self.data_format)
