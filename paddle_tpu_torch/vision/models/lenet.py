"""LeNet: the port of paddle_tpu/vision/models/lenet.py (the reference's
layer stack: a 1 x 28 x 28 input, two convolutions with ReLU and 2 x 2
max pooling, three Linears, 10 classes by default).

``LeNet(num_classes=10, device=None, dtype=torch.float32, seed=0)``
follows the port's entry-point convention: on the CUDA card unless
``device="cpu"``, its weights drawn there with the reference's
initialisers from a ``torch.Generator`` seeded with ``seed``. The
parameter names are the reference's state-dict keys
(``features.0.weight``, ``fc.2.bias``); the convolutions and pooling run
as cuDNN and aten ops.
"""
from __future__ import annotations

import torch

from ...framework.device import resolve_device
from ...nn.layer import Conv2D, Layer, Linear, MaxPool2D, ReLU, Sequential

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **factory),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **factory),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **factory),
                Linear(120, 84, **factory),
                Linear(84, num_classes, **factory),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
