"""The high-level API: the port of paddle_tpu/hapi (``Model``,
``InputSpec``, the callbacks, ``summary`` and ``flops``)."""
from . import callbacks
from .callbacks import Callback
from .model import InputSpec, Model
from .model_summary import flops, summary

__all__ = ["Callback", "InputSpec", "Model", "callbacks", "flops",
           "summary"]
