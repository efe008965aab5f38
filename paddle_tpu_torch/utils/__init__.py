from . import flags
from .flags import get_flags, set_flags

__all__ = ["flags", "get_flags", "set_flags"]
