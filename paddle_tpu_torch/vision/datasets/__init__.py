"""Vision datasets: the port of paddle_tpu/vision/datasets' ``MNIST`` and
``FashionMNIST``.

Images and labels load from the IDX ``.gz`` files the reference reads
when ``image_path`` and ``label_path`` exist; otherwise the reference's
deterministic synthetic fallback: 4096 images (``RandomState(0)`` for
"train", ``RandomState(1)`` for "test"), the same bytes as the
reference's. ``__getitem__`` returns a ``[1, 28, 28]`` float32 image in
[0, 1] (or ``transform(image)``) and an int64 ``[1]`` label, as numpy
arrays: the loader's collate makes the batch tensors.

``Cifar10``, ``Cifar100``, ``DatasetFolder`` / ``ImageFolder``,
``Flowers`` and ``VOC2012`` are not ported yet (ROADMAP queue A10b):
they raise.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ["Cifar10", "Cifar100", "DatasetFolder", "FashionMNIST", "Flowers",
           "ImageFolder", "MNIST", "VOC2012"]


class MNIST(Dataset):
    """MNIST from IDX files, or the reference's synthetic images."""

    NUM_CLASSES = 10
    IMAGE_SHAPE = (28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode.lower()
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path)
        self.dtype = "float32"

    def _load(self, image_path, label_path):
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows,
                                                                   cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8)
            return images, labels
        n = min(60000 if self.mode == "train" else 10000, 4096)
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        images = rng.randint(0, 256, (n,) + self.IMAGE_SHAPE, dtype=np.uint8)
        labels = rng.randint(0, self.NUM_CLASSES, (n,), dtype=np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class _NotPorted(Dataset):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"vision.datasets.{type(self).__name__} is not ported yet: "
            "ROADMAP queue A10b (MNIST and FashionMNIST are)")


class Cifar10(_NotPorted):
    pass


class Cifar100(_NotPorted):
    pass


class DatasetFolder(_NotPorted):
    pass


ImageFolder = DatasetFolder


class Flowers(_NotPorted):
    pass


class VOC2012(_NotPorted):
    pass
