"""Common layers: the port of paddle_tpu/nn/layer/common.py's
``Identity``, ``Linear``, ``Embedding``, the dropouts, ``Flatten``,
``Unflatten``, ``Bilinear``, ``CosineSimilarity`` and
``PairwiseDistance``.

``Linear`` is a ``torch.nn.Linear``: its weight is ``[out, in]``, the
transpose of the reference's ``[in, out]``, drawn in the reference's
layout (default XavierUniform, bias zeros) and stored transposed;
`convert` transposes it on the way across, and `amp.decorate` treats it
as torch's. ``weight_attr`` / ``bias_attr`` take what the reference's
take (`layers.ParamAttr`). The resampling and padding layers wait for
ROADMAP queue A10.
"""
from __future__ import annotations

import math

import torch

from .. import functional as PF
from ..initializer import Constant, Uniform, XavierUniform
from .layers import Layer, create_parameter

__all__ = ["AlphaDropout", "Bilinear", "CosineSimilarity", "Dropout",
           "Dropout2D", "Dropout3D", "Embedding", "Flatten", "Identity",
           "Linear", "PairwiseDistance", "Unflatten"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(torch.nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        torch.nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierUniform(), transpose=True, **kw)
        self.bias = create_parameter(
            [out_features], bias_attr, is_bias=True,
            default_initializer=Constant(0.0), **kw)


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table (default XavierUniform,
    the ``padding_idx`` row zero and read as zero)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, dtype=dtype,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return PF.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self._generator = generator

    def forward(self, input):
        return PF.dropout(input, p=self.p, axis=self.axis,
                          training=self.training, mode=self.mode,
                          generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self._generator = generator

    def forward(self, input):
        return PF.dropout2d(input, p=self.p, training=self.training,
                            data_format=self.data_format,
                            generator=self._generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self._generator = generator

    def forward(self, input):
        return PF.dropout3d(input, p=self.p, training=self.training,
                            data_format=self.data_format,
                            generator=self._generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self._generator = generator

    def forward(self, input):
        return PF.alpha_dropout(input, p=self.p, training=self.training,
                                generator=self._generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, input):
        return torch.flatten(input, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, input):
        return torch.unflatten(input, self.axis, tuple(self.shape))


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return PF.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out = x1 @ weight[o] @ x2 + bias``; weight ``[out, in1, in2]``
    and bias drawn from Uniform(-1/sqrt(in1), 1/sqrt(in1))."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        bound = 1 / math.sqrt(in1_features)
        kw = dict(dtype=dtype, device=device, generator=generator,
                  default_initializer=Uniform(-bound, bound))
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x1, x2):
        return PF.bilinear(x1, x2, self.weight, self.bias)


class PairwiseDistance(Layer):
    """The p-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)
