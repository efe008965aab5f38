"""Convolution functionals: the port of paddle_tpu/nn/functional/conv.py's
``conv2d``, the form the vision models use.

Weights are ``[out, in / groups, kh, kw]`` in both packages, so nothing
is transposed. On the card the convolution is cuDNN's under the port's
numerics contract (TF32 off, `framework.device`): the reference's is an
XLA convolution, not a Pallas kernel. Padding takes an int or one int a
spatial side (``[ph, pw]``, or the pairs form ``[t, b, l, r]`` where each
pair is even); string and uneven padding and layouts other than NCHW
raise until ROADMAP queue A10 ports them.
"""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["conv2d"]


def _pair(v, what):
    if isinstance(v, int):
        return (v, v)
    v = tuple(int(x) for x in v)
    if len(v) == 2:
        return v
    raise NotImplementedError(
        f"conv2d {what}={v!r} is not ported yet: ROADMAP queue A10")


def _padding(padding):
    if isinstance(padding, str):
        raise NotImplementedError(
            f"conv2d padding={padding!r} is not ported yet: ROADMAP queue "
            "A10")
    if isinstance(padding, int):
        return (padding, padding)
    pads = tuple(int(p) for p in padding)
    if len(pads) == 2:
        return pads
    if len(pads) == 4 and pads[0] == pads[1] and pads[2] == pads[3]:
        return (pads[0], pads[2])
    raise NotImplementedError(
        f"conv2d padding={list(padding)!r} (uneven) is not ported yet: "
        "ROADMAP queue A10")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x`` [N, C, H, W] with ``weight`` [O, C /
    groups, kh, kw] (and ``bias`` [O])."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"conv2d data_format={data_format!r} is not ported yet: ROADMAP "
            "queue A10")
    return F.conv2d(x, weight, bias, _pair(stride, "stride"),
                    _padding(padding), _pair(dilation, "dilation"), groups)
