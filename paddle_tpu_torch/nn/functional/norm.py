"""Normalization functionals: the port of paddle_tpu/nn/functional/
norm.py: ``batch_norm``, ``layer_norm``, ``rms_norm``, ``group_norm``,
``instance_norm`` and ``local_response_norm``. Each computes its
statistics in fp32 whatever the input's dtype, upcasts its weight and
bias to fp32, and returns the input's dtype, as the reference does.
``spectral_norm`` is not ported yet (ROADMAP queue A10).

``batch_norm`` follows Paddle's conventions, which differ from torch's:

* ``momentum`` is the share of the old running value kept:
  ``new = momentum * old + (1 - momentum) * batch`` (torch's argument is
  ``1 - momentum``);
* the running variance takes the unbiased batch variance (``n / (n -
  1)``), while the batch is normalised with the biased one;
* statistics are computed in fp32 whatever the input's dtype, and the
  output has the input's dtype;
* in training (and without ``use_global_stats``) the running statistics
  are updated in place on the tensors passed in.

The arithmetic is `torch.nn.functional.batch_norm` (cuDNN's on the card,
whose running update is the same rule with torch's momentum): the
reference's batch norm is XLA, not a Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["batch_norm", "group_norm", "instance_norm", "layer_norm",
           "local_response_norm", "rms_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's (axis 1 for "NC...",
    the last for "N...C")."""
    channel_last = data_format[1] != "C"
    v = x.movedim(-1, 1) if channel_last else x
    if v.dtype != torch.float32:
        v = v.float()
    use_batch_stats = training and not use_global_stats
    # statistics in fp32: running buffers of another dtype go through
    # fp32 copies, written back after the update
    stats = [None if s is None or s.dtype == torch.float32 else s.float()
             for s in (running_mean, running_var)]
    out = F.batch_norm(
        v, running_mean if stats[0] is None else stats[0],
        running_var if stats[1] is None else stats[1],
        None if weight is None else weight.float(),
        None if bias is None else bias.float(),
        training=use_batch_stats, momentum=1.0 - momentum, eps=epsilon)
    if use_batch_stats:
        with torch.no_grad():
            for buf, s in zip((running_mean, running_var), stats):
                if s is not None:
                    buf.copy_(s)
    out = out.to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def _f32(t):
    return None if t is None else t.float()


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalise over the trailing ``normalized_shape`` axes (biased
    variance)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    out = F.layer_norm(x.float(), list(normalized_shape), _f32(weight),
                       _f32(bias), epsilon)
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps)`` in
    fp32, times the fp32 upcast of ``weight``, cast back to the input's
    dtype (the LLaMA norm; the reference's is one fused XLA expression).
    """
    x32 = x.float()
    out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def _affine(out, weight, bias, bshape):
    if weight is not None:
        out = out * weight.float().reshape(bshape)
    if bias is not None:
        out = out + bias.float().reshape(bshape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Statistics over each group of ``C / num_groups`` channels and the
    spatial axes (channel axis 1, as the reference reads it)."""
    n, c = x.shape[0], x.shape[1]
    v = x.float().reshape(n, num_groups, c // num_groups, *x.shape[2:])
    axes = tuple(range(2, v.dim()))
    mean = v.mean(axes, keepdim=True)
    var = v.var(axes, unbiased=False, keepdim=True)
    out = ((v - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias,
                   [1, c] + [1] * (x.dim() - 2)).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Statistics over the spatial axes of each sample and channel (the
    reference uses the input's statistics whatever the running
    arguments)."""
    v = x.float()
    axes = tuple(range(2, x.dim()))
    mean = v.mean(axes, keepdim=True)
    var = v.var(axes, unbiased=False, keepdim=True)
    out = (v - mean) / torch.sqrt(var + eps)
    return _affine(out, weight, bias,
                   [1, x.shape[1]] + [1] * (x.dim() - 2)).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum / size) ** beta``, the sum of squares over
    a window of ``size`` channels (axis 1) centred on each."""
    sq = x.float().square()
    c, half = x.shape[1], size // 2
    widths = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    padded = F.pad(sq, widths)
    acc = sum(padded[:, i:i + c] for i in range(size))
    return (x.float() / torch.pow(k + alpha * acc / size, beta)).to(x.dtype)
