"""Pooling functionals: the port of paddle_tpu/nn/functional/pooling.py's
2-D max, average and adaptive-average pools, as the vision models use
them.

* ``max_pool2d`` pads with -inf, as the reference's ``reduce_window``
  does; a gradient goes to the first largest element of a window, as
  XLA's ``select_and_scatter`` sends it.
* ``avg_pool2d`` with ``exclusive`` (the default) divides by the
  window's elements inside the input, else by the whole window.
* ``adaptive_avg_pool2d``: cell i averages rows ``floor(i * in / out)``
  to ``ceil((i + 1) * in / out)``, as in the reference.

On the card these are aten's pooling kernels: the reference's are XLA
reductions, not Pallas kernels. ``ceil_mode``, ``return_mask``,
``divisor_override`` and layouts other than NCHW raise until ROADMAP
queue A10 ports them.
"""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "max_pool2d"]


def _refuse(what):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP queue A10")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(x) for x in v)


def _check(padding, ceil_mode, data_format, name):
    if isinstance(padding, str):
        _refuse(f"{name} padding={padding!r}")
    if ceil_mode:
        _refuse(f"{name} ceil_mode=True")
    if data_format != "NCHW":
        _refuse(f"{name} data_format={data_format!r}")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _check(padding, ceil_mode, data_format, "max_pool2d")
    if return_mask:
        _refuse("max_pool2d return_mask=True")
    return F.max_pool2d(x, _pair(kernel_size),
                        _pair(kernel_size if stride is None else stride),
                        _pair(padding))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _check(padding, ceil_mode, data_format, "avg_pool2d")
    if divisor_override is not None:
        _refuse("avg_pool2d divisor_override")
    return F.avg_pool2d(x, _pair(kernel_size),
                        _pair(kernel_size if stride is None else stride),
                        _pair(padding), count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    if data_format != "NCHW":
        _refuse(f"adaptive_avg_pool2d data_format={data_format!r}")
    return F.adaptive_avg_pool2d(x, _pair(output_size))
