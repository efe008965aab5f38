"""``Linear`` with the reference's initialisation (paddle_tpu/nn/layer/
common.py): weight XavierUniform (limit sqrt(6 / (in + out))), bias
zeros. It is a ``torch.nn.Linear``, so its weight is ``[out, in]``, the
transpose of the reference's ``[in, out]``; `convert` transposes it on
the way across."""
from __future__ import annotations

import math

import torch

from .layers import wants_parameter

__all__ = ["Linear"]


class Linear(torch.nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        wants_parameter(weight_attr, "weight_attr")
        torch.nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        factory = dict(device=device, dtype=dtype)
        self.weight = torch.nn.Parameter(
            torch.empty(out_features, in_features, **factory))
        self.bias = (torch.nn.Parameter(
                         torch.empty(out_features, **factory))
                     if wants_parameter(bias_attr, "bias_attr") else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()
