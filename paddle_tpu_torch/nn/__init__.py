from . import initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = sorted(_layers + ["ClipGradByGlobalNorm", "ClipGradByNorm",
                            "ClipGradByValue", "clip_grad_norm_",
                            "initializer"])
