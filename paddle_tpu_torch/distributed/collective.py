"""Symmetric int8 quantization: the wire and storage format of the comm
stack, and of the int8 paged KV pools.

Counterpart of ``quantize_symmetric_q8`` / ``dequantize_q8`` in
paddle_tpu/distributed/collective.py (only these two functions; the
collectives come with the multi-device slice). The recipe is the
reference's to the bit: one fp32 scale per row, ``max|x|`` floored at
1e-30 and divided by 127, the payload ``round(x / scale)`` (half to
even) clipped to [-127, 127].
"""
from __future__ import annotations

import torch

__all__ = ["quantize_symmetric_q8", "dequantize_q8"]


def _symmetric(x, axis, qmax):
    """(round(x / scale) clipped to [-qmax, qmax] as fp32, scales fp32
    with ``axis`` removed). The divisor is a full tensor, not a Python
    number: PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, which can differ from the reference's division by one
    unit in the last place. ``max|x|`` is the inf-norm: one kernel, and
    exact."""
    xf = x.float()
    amax = torch.linalg.vector_norm(xf, float("inf"), dim=axis) \
        .clamp_min(1e-30)
    sc = amax / torch.full_like(amax, qmax)
    q = torch.round(xf / sc.unsqueeze(axis)).clamp_(-qmax, qmax)
    return q, sc


def quantize_symmetric_q8(x, axis=-1):
    """(q int8, scales fp32 with ``axis`` removed): one scale per
    ``axis``-row."""
    q, sc = _symmetric(x, axis, 127.0)
    return q.to(torch.int8), sc


def dequantize_q8(q, scales, axis=-1, dtype=torch.float32):
    """Inverse of `quantize_symmetric_q8`: ``q * scale`` broadcast along
    ``axis``."""
    return (q.float() * scales.unsqueeze(axis)).to(dtype)
