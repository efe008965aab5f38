from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import Conv2D
from .layers import Layer, ParamAttr, create_parameter
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = sorted(_activation + _common + _container + _loss + _norm + [
    "AdaptiveAvgPool2D", "AvgPool2D", "Conv2D", "Layer", "MaxPool2D",
    "ParamAttr", "create_parameter"])
