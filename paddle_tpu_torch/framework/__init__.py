from .device import resolve_device
from .io import load, save

__all__ = ["load", "resolve_device", "save"]
