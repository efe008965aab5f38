"""Quantization for decoding: weight-only int8 / int4 linears and the
int4 nibble format of the int4 paged KV pools.

Counterpart of paddle_tpu/nn/quant/__init__.py, so far these:

* ``weight_quantize`` / ``weight_dequantize``: per-channel (or grouped:
  64 or 128 input columns a group) absmax quantization of an ``[in,
  out]`` weight to int8 ``[out, in]`` with fp32 scales ``[out]`` (``[in /
  g, out]`` grouped); int4 is values in [-8, 7] stored in int8 bytes, as
  the reference stores it;
* ``weight_only_linear``: the product with the int8 weight, the kernel
  of ``ops/kernels/weight_only.py`` on the card;
* ``WeightOnlyLinear`` and ``quantize_for_decode``: a Linear with its
  weight quantized once, and the swap of a model's Linears by attribute
  name (the decode lane's int8 weights);
* ``quantize_symmetric_q4``, ``pack_q4``, ``unpack_q4``: the int4 KV
  pools' format. One fp32 scale per row, ``max|x|`` floored at 1e-30 and
  divided by 7, payload ``round(x / scale)`` (half to even) clipped to
  [-7, 7]; packing stores two values a byte, the even lane in the high
  nibble, offset-binary (+8).

Not ported yet (ROADMAP A10): ``llm_int8_linear``,
``apply_per_channel_scale``, the fake-quant and QAT layers.
"""
from __future__ import annotations

import torch
from torch import nn

from ...distributed.collective import _symmetric
from ...ops.kernels.weight_only import weight_only_linear

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_decode",
           "quantize_symmetric_q4", "pack_q4", "unpack_q4"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _bits(algo):
    if algo not in ("weight_only_int8", "weight_only_int4", "llm.int8"):
        raise ValueError(f"unsupported quant algo {algo!r}")
    return 4 if algo == "weight_only_int4" else 8


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Per-channel (or grouped) absmax int8 / int4 weight quantization.
    x: ``[in, out]`` fp16 / bf16 / fp32 (the reference's Linear layout).
    Returns (q ``[out, in]`` int8, scale fp32 ``[out]``, or ``[in /
    group_size, out]`` grouped): scale ``max|x| / qmax`` over the
    column (or its group), q ``round(x / scale)`` (half to even) clipped
    to [-qmax - 1, qmax]. ``arch`` is accepted and ignored."""
    del arch
    bits = _bits(algo)
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")
    qmax = float(2 ** (bits - 1) - 1)
    with torch.no_grad():
        wf = x.detach().float()
        if group_size == -1:
            scale = wf.abs().amax(dim=0) / qmax                 # [out]
            q = torch.clamp(torch.round(wf / scale[None, :]), -qmax - 1,
                            qmax)
            return q.t().to(torch.int8).contiguous(), scale
        k = wf.shape[0]
        if k % group_size:
            raise ValueError(
                f"in-dim {k} not divisible by group {group_size}")
        g = wf.reshape(k // group_size, group_size, -1)
        scale = g.abs().amax(dim=1) / qmax                      # [k/g, out]
        q = torch.clamp(torch.round(g / scale[:, None, :]), -qmax - 1, qmax)
        return q.reshape(k, -1).t().to(torch.int8).contiguous(), scale


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16"):
    """Inverse of `weight_quantize`: q ``[out, in]`` + scale -> ``[in,
    out]`` in ``out_dtype`` (a name or a torch dtype), the product in
    fp32 rounded once."""
    _bits(algo)
    dt = _DTYPES[out_dtype] if isinstance(out_dtype, str) else out_dtype
    w = x.float().t()                                           # [in, out]
    if scale.dim() == 1:
        return (w * scale.float()[None, :]).to(dt)
    k = w.shape[0]
    gs = k // scale.shape[0]
    return (w.reshape(scale.shape[0], gs, -1) * scale.float()[:, None, :]) \
        .reshape(k, -1).to(dt)


class WeightOnlyLinear(nn.Module):
    """Inference Linear with an int8 (or int4-valued) weight in device
    memory: half the weight bytes of bf16, a quarter of fp32, where
    decoding is bound by the weight's bytes.

    Built from a ``torch.nn.Linear`` (the weight quantized once, per
    channel); ``quant_weight`` (int8 ``[out, in]``) and ``weight_scale``
    (fp32 ``[out]``) are parameters without gradients, and the Linear's
    ``bias`` is kept as it was, under the reference's names."""

    def __init__(self, linear, algo="weight_only_int8"):
        super().__init__()
        if linear.weight is None:
            raise ValueError("linear has no weight")
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.algo = algo
        self.weight_dtype = "int4" if "int4" in algo else "int8"
        qw, scale = weight_quantize(linear.weight.t(), algo=algo)
        self.quant_weight = nn.Parameter(qw, requires_grad=False)
        self.weight_scale = nn.Parameter(scale, requires_grad=False)
        self.bias = linear.bias

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, bias=self.bias,
                                  weight_scale=self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, algo={self.algo}")


def quantize_for_decode(model, algo="weight_only_int8",
                        include=("qkv", "out_proj", "fc1", "fc2",
                                 "lm_head")):
    """Swap every ``torch.nn.Linear`` of ``model`` (the port's
    ``nn.Linear`` among them) whose attribute name is in ``include`` for
    a `WeightOnlyLinear`, in place; returns the model. A tied head
    (``lm_head`` None) keeps the fp embedding product."""
    for layer in list(model.modules()):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, nn.Linear) and name in include:
                setattr(layer, name, WeightOnlyLinear(sub, algo=algo))
    return model


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
