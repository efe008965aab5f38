from .common import Linear
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv2D", "CrossEntropyLoss",
           "Linear", "MaxPool2D"]
