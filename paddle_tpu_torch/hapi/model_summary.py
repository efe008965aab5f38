"""``summary`` and ``flops``: the port of paddle_tpu/hapi/
model_summary.py. One forward at ``input_size`` (zeros on the network's
device, under ``no_grad``) or on the given inputs, with a forward hook
on each leaf module (``named_modules()`` without the network itself,
the reference's ``named_sublayers``): each leaf's output shape and
parameter count, or its FLOPs by the reference's per-layer rules."""
from __future__ import annotations

import numpy as np
import torch

from ..nn.initializer import to_torch_dtype

__all__ = ["flops", "summary"]


def _leaves(net):
    return [(name, m) for name, m in net.named_modules()
            if name and next(m.children(), None) is None]


def _dry_run(net, args, input_size, dtypes, what):
    """Run ``net`` once, on ``args`` or on zeros of ``input_size``."""
    if args is not None:
        args = args if isinstance(args, (tuple, list)) else [args]
    elif input_size is not None:
        shapes = input_size if isinstance(input_size, list) \
            else [input_size]
        dts = dtypes or ["float32"] * len(shapes)
        p = next(net.parameters(), None)
        dev = p.device if p is not None else torch.device("cpu")
        args = [torch.zeros([d if d and d > 0 else 1 for d in shape],
                            dtype=to_torch_dtype(dt), device=dev)
                for shape, dt in zip(shapes, dts)]
    else:
        raise ValueError(f"{what} needs input_size or input")
    with torch.no_grad():
        net(*args)


def _hooked_run(net, make_hook, args, input_size, dtypes, what):
    hooks = [m.register_forward_hook(make_hook(name))
             for name, m in _leaves(net)]
    try:
        _dry_run(net, args, input_size, dtypes, what)
    finally:
        for h in hooks:
            h.remove()


def summary(net, input_size=None, dtypes=None, input=None):
    """Prints each leaf's output shape and parameter count; returns
    ``{"total_params", "trainable_params"}``."""
    rows = []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            shape = list(out.shape) if hasattr(out, "shape") else "?"
            n_params = sum(p.numel() for p in layer._parameters.values()
                           if p is not None)
            rows.append((name, type(layer).__name__, shape, n_params))

        return hook

    _hooked_run(net, make_hook, input, input_size, dtypes, "summary")
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = max([len(r[0]) for r in rows] + [10]) + 2
    print(f"{'Layer':<{width}}{'Type':<24}{'Output Shape':<20}"
          f"{'Params':>12}")
    print("-" * (width + 56))
    for name, typ, shape, n in rows:
        print(f"{name:<{width}}{typ:<24}{str(shape):<20}{n:>12,}")
    print("-" * (width + 56))
    print(f"Total params: {total:,}\nTrainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def _layer_flops(layer, inputs, outputs):
    """A leaf's multiply-add-style FLOPs (the reference's rules, by class
    name)."""
    out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    out_elems = int(np.prod(out.shape)) if hasattr(out, "shape") else 0
    cls = type(layer).__name__
    if cls == "Linear":
        return out_elems * layer.in_features
    if cls in ("Conv1D", "Conv2D", "Conv3D"):
        return out_elems * int(np.prod(layer.weight.shape[1:]))
    if cls in ("BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "LayerNorm",
               "GroupNorm"):
        return 2 * out_elems
    if cls in ("ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "SiLU",
               "AvgPool2D", "MaxPool2D", "AdaptiveAvgPool2D"):
        return out_elems
    return 0


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """The FLOPs of one forward, summed over the leaves
    (``custom_ops``: {module class: fn(module, inputs, outputs)})."""
    total = [0]
    custom_ops = custom_ops or {}

    def make_hook(name):
        def hook(layer, ins, outs):
            fn = custom_ops.get(type(layer), _layer_flops)
            total[0] += int(fn(layer, ins, outs))

        return hook

    _hooked_run(net, make_hook, inputs, input_size, None, "flops")
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
