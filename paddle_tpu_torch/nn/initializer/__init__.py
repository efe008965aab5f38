"""Weight initializers: the port of paddle_tpu/nn/initializer.

Each initializer is a callable ``(shape, dtype="float32", device=None,
generator=None) -> torch.Tensor``. Random ones draw from ``generator``
(a ``torch.Generator`` on ``device``; None: torch's default generator of
that device) in fp32 and round once to ``dtype``. The reference draws
with numpy or ``jax.random``, so a draw is held to its contract (bounds,
moments, fans), not bit for bit; `Constant`, `Assign`, `Dirac` and
`Bilinear` are exact.

Fans follow the reference's ``_fan_in_out``: a vector has fan in = fan
out = its length; otherwise fan in = ``shape[1] * receptive`` and fan
out = ``shape[0] * receptive`` (receptive = the product of
``shape[2:]``). The reference's Linear weight is ``[in, out]``: the
port's `nn.Linear` draws in that layout and stores the transpose, so an
initializer sees the reference's shape.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "get_global_initializer",
           "set_global_initializer"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int64": torch.int64, "int32": torch.int32, "bool": torch.bool}


def to_torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = shape[0] if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


def _draw(shape, dtype, device, fill):
    """``fill`` (an in-place draw) on an fp32 tensor, rounded once to
    ``dtype``."""
    dt = to_torch_dtype(dtype)
    work = torch.float64 if dt == torch.float64 else torch.float32
    out = torch.empty(tuple(shape), dtype=work, device=device)
    fill(out)
    return out.to(dt)


class Initializer:
    def __call__(self, shape, dtype="float32", device=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return _draw(shape, dtype, device, lambda t: t.normal_(
            self.mean, self.std, generator=generator))


class TruncatedNormal(Initializer):
    """``mean + std * z``, z standard normal redrawn where it falls
    outside ``[a, b]`` (64 rounds, then clipped), as the reference."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        def fill(t):
            t.normal_(generator=generator)
            for _ in range(64):
                bad = (t < self.a) | (t > self.b)
                if not bad.any():
                    break
                t.copy_(torch.where(bad, torch.empty_like(t).normal_(
                    generator=generator), t))
            t.clamp_(self.a, self.b).mul_(self.std).add_(self.mean)
        return _draw(shape, dtype, device, fill)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return _draw(shape, dtype, device, lambda t: t.uniform_(
            self.low, self.high, generator=generator))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device,
                                                 generator)


class Assign(Initializer):
    """The given value (array, tensor or nested list), reshaped to
    ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        v = self.value
        v = (v.detach() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        return v.to(device=device, dtype=to_torch_dtype(dtype)).reshape(
            tuple(shape)).clone()


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal columns (or rows, if it is
    wide) over ``shape`` viewed as ``[prod(shape[:-1]), shape[-1]]``: the
    reference's ``jax.nn.initializers.orthogonal`` (column axis -1). QR of
    a normal draw, signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        shape = tuple(shape)
        cols = shape[-1]
        rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1

        def fill(t):
            a = torch.empty(max(rows, cols), min(rows, cols), device=t.device,
                            dtype=t.dtype).normal_(generator=generator)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))[None]
            if rows < cols:
                q = q.t()
            t.copy_((self.gain * q).reshape(shape))
        return _draw(shape, dtype, device, fill)


class Dirac(Initializer):
    """A convolution weight that passes its input through: 1 at the
    kernel's centre of ``(i, i % in)`` for ``i < min(out, in * groups)``."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        arr = np.zeros(shape, dtype=np.float32)
        out_c, in_c = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(out_c, in_c * self.groups)):
            arr[(i, i % in_c) + centers] = 1.0
        return torch.from_numpy(arr).to(device=device,
                                        dtype=to_torch_dtype(dtype))


class Bilinear(Initializer):
    """The bilinear-upsample kernel of a transposed convolution weight
    ``[C_out, C_in, k, k]``: the same separable triangle filter for every
    channel pair (reference initializer/Bilinear)."""

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D conv weight")
        k = shape[-1]
        if shape[-2] != k:
            raise ValueError("Bilinear init expects square kernels")
        f = np.ceil(k / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        t = 1 - np.abs(np.arange(k, dtype=np.float32) / f - c)
        w = np.broadcast_to(t[:, None] * t[None, :], shape).astype(np.float32)
        return torch.from_numpy(w.copy()).to(device=device,
                                             dtype=to_torch_dtype(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


_GLOBAL_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers for parameters created from now on
    (`nn.layer.layers.create_parameter` reads them); None restores the
    layers' own defaults."""
    global _GLOBAL_INIT
    _GLOBAL_INIT = None if weight_init is None else (weight_init, bias_init)


def get_global_initializer():
    return _GLOBAL_INIT
