"""Device resolution for the port's entry points.

Every entry point (`GPTForCausalLM`, `PagedKVCache`, `ServingEngine`)
takes a ``device`` argument and resolves it here: no argument means the
CUDA card, and a machine without one raises instead of falling back to
the CPU quietly. The CPU runs only when the caller asks for it, as the
tests do.

fp32 means true fp32, as in the reference (paddle_tpu/framework/
__init__.py pins ``jax_default_matmul_precision="float32"``): TF32 is
switched off for matmuls and for cuDNN when this module is imported.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without a CUDA device); ``"cpu"``
    and ``"cuda[:i]"`` are honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda", 0 if dev.index is None else dev.index)
