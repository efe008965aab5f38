"""int4 nibble format: the storage format of the int4 paged KV pools.

Counterpart of ``quantize_symmetric_q4``, ``pack_q4`` and ``unpack_q4``
in paddle_tpu/nn/quant/__init__.py (only these three; weight-only
quantization comes later). One fp32 scale per row, ``max|x|`` floored at
1e-30 and divided by 7, payload ``round(x / scale)`` (half to even)
clipped to [-7, 7]; packing stores two values a byte, the even lane in
the high nibble, offset-binary (+8).
"""
from __future__ import annotations

import torch

from ...distributed.collective import _symmetric

__all__ = ["quantize_symmetric_q4", "pack_q4", "unpack_q4"]


def quantize_symmetric_q4(x, axis=-1):
    """(q int8 in [-7, 7], unpacked; scales fp32 with ``axis``
    removed). Pair with `pack_q4` for the pool layout."""
    q, sc = _symmetric(x, axis, 7.0)
    return q.to(torch.int8), sc


def pack_q4(q):
    """int values in [-7, 7] ``[..., d]`` -> uint8 ``[..., d // 2]``:
    even lane in the high nibble, odd lane in the low one, each + 8.
    The last dim must be even."""
    if q.shape[-1] % 2:
        raise ValueError(
            f"pack_q4 needs an even last dim, got {q.shape[-1]}")
    v = q.to(torch.int32) + 8
    return ((v[..., 0::2] << 4) | v[..., 1::2]).to(torch.uint8)


def unpack_q4(p):
    """Inverse of `pack_q4`: uint8 ``[..., d // 2]`` -> int32 ``[..., d]``
    in [-8, 7], high nibble first."""
    v = p.to(torch.int32)
    return torch.stack([(v >> 4) - 8, (v & 0xF) - 8], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2)
