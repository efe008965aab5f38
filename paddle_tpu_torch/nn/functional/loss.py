"""Loss functionals: the port of the parts of paddle_tpu/nn/functional/
loss.py the training path runs.

* `fused_linear_cross_entropy`: the vocab-tiled route (the reference's
  ``FLAGS_fused_ce`` default): hidden states and the LM-head weight go
  straight into `ops.kernels.fused_cross_entropy`, so the
  ``[tokens, vocab]`` logits never exist. The token-chunked route
  (``n_chunks`` / ``vocab_tiled=False``) is not ported.
* `cross_entropy`: hard labels over materialised logits, as far as
  ``GPTPretrainingCriterion`` needs it.
"""
from __future__ import annotations

import torch

from ...ops.kernels.fused_cross_entropy import fused_cross_entropy

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def _reduce(losses, valid, reduction):
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    if reduction == "mean":
        return losses.sum() / valid.float().sum().clamp(min=1.0)
    raise ValueError(f"reduction must be none, sum or mean, got "
                     f"{reduction!r}")


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy over the last axis of ``input`` with integer
    ``label`` (hard labels only): ``lse - picked`` in fp32, 0 at
    ``ignore_index``; "mean" divides by the number of non-ignored
    labels (at least 1)."""
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    x32 = input.float()
    lse = torch.logsumexp(x32, dim=-1)
    picked = x32.gather(-1, safe[..., None])[..., 0]
    losses = torch.where(valid, lse - picked,
                         torch.zeros((), device=input.device))
    return _reduce(losses, valid, reduction)


def fused_linear_cross_entropy(hidden, weight, labels, transpose_y=True,
                               ignore_index=-100, reduction="mean",
                               n_chunks=None, vocab_tiled=None):
    """Cross entropy of ``softmax(hidden @ weight^T)`` (``transpose_y``,
    weight ``[V, H]``) or ``softmax(hidden @ weight)`` (weight ``[H, V]``)
    without the logits. hidden ``[..., H]``, labels int ``[...]``;
    "mean" averages over non-ignored tokens."""
    if n_chunks is not None or vocab_tiled is False:
        raise NotImplementedError(
            "the token-chunked route of fused_linear_cross_entropy is not "
            "ported; the vocab-tiled route is the default")
    flat_h = hidden.reshape(-1, hidden.shape[-1])
    flat_l = labels.reshape(-1)
    # the kernel's layout is [V, H]: an [H, V] head transposes outside
    # (autograd routes dweight back through the transpose)
    w_vh = weight if transpose_y else weight.t().contiguous()
    losses = fused_cross_entropy(flat_h, w_vh, flat_l,
                                 ignore_index=ignore_index)
    if reduction == "none":
        return losses.reshape(labels.shape)
    return _reduce(losses, flat_l != ignore_index, reduction)
