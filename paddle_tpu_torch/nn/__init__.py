from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv2D, CrossEntropyLoss,
                    Linear, MaxPool2D)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv2D", "CrossEntropyLoss",
           "Linear", "MaxPool2D", "clip_grad_norm_"]
