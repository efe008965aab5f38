"""Normalization functionals: the port of paddle_tpu/nn/functional/
norm.py's ``batch_norm``.

Paddle's conventions, which differ from torch's:

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

__all__ = ["batch_norm"]


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
