"""``ParamAttr``, ``create_parameter`` and ``Layer``: the port of
paddle_tpu/nn/layer/layers.py.

A layer's ``weight_attr`` / ``bias_attr`` is a `ParamAttr`, an
initializer, a name (str), None (the defaults) or False (no parameter),
as in the reference. `create_parameter` draws the parameter with the
attr's initializer, else the global one (`nn.initializer.
set_global_initializer`), else the layer's default, else XavierUniform
(a weight) or zeros (a bias), and hangs the reference's attributes on
the ``torch.nn.Parameter``:

* ``optimize_attr = {"learning_rate": scale}``: the optimizer multiplies
  its lr by it (`optimizer.Optimizer._param_lr_scale`);
* ``regularizer``: a parameter with its own takes no L2 decay from the
  optimizer, as in the reference;
* ``need_clip``: False leaves it out of the grad clips;
* ``trainable=False`` makes it ``requires_grad=False``, which the
  optimizer and `jit.TrainStep` skip.

An attr's ``name`` is accepted and not kept: a torch tensor's ``name``
is not writable, and the port keys optimizer state by the names
``named_parameters()`` gives (`optimizer.Optimizer._key`).

`Layer` is a ``torch.nn.Module`` with the reference's
``create_parameter`` and ``sublayers``. The reference numbers unnamed
parameters ``param_<counter>`` in creation order; the port's modules
register their parameters in that order, so ``named_parameters()`` is
it (`convert` relies on this).
"""
from __future__ import annotations

import torch

from ..initializer import (Constant, XavierUniform, get_global_initializer,
                           to_torch_dtype)

__all__ = ["Layer", "ParamAttr", "create_parameter"]


class ParamAttr:
    """paddle.ParamAttr: a parameter's name, initializer, learning-rate
    scale, regularizer, trainability and clip membership."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr(initializer=attr)      # an initializer


def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, *, device=None,
                     generator=None, transpose=False):
    """A ``torch.nn.Parameter`` of ``shape`` drawn as the reference's
    ``Layer.create_parameter`` draws it, or None for ``attr=False``.
    ``transpose`` stores the transpose of the 2-D draw (a Linear weight:
    drawn in the reference's ``[in, out]``, stored ``[out, in]``)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    glob = get_global_initializer()
    init = attr.initializer
    if init is None and glob is not None:
        init = glob[1] if is_bias else glob[0]
    if init is None:
        init = default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    with torch.no_grad():
        data = init(list(shape), to_torch_dtype(dtype), device, generator)
        if transpose:
            data = data.t().contiguous()
    p = torch.nn.Parameter(data, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class Layer(torch.nn.Module):
    """paddle.nn.Layer over ``torch.nn.Module``: `create_parameter` (with
    ``device=`` and ``generator=`` keywords) and ``sublayers``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, **kw):
        return create_parameter(shape, attr, dtype or self._dtype, is_bias,
                                default_initializer, **kw)

    def sublayers(self, include_self=False):
        layers = list(self.modules())
        return layers if include_self else layers[1:]
