"""Loss functionals: the port of paddle_tpu/nn/functional/loss.py.

* `fused_linear_cross_entropy`, the LM-head loss without the
  ``[tokens, vocab]`` logits, has the reference's two routes:
  - vocab-tiled (``FLAGS_fused_ce`` on, the default): hidden states and
    the head's weight go straight into `ops.kernels.fused_cross_entropy`
    (the CUDA kernels #11/#12 on the card);
  - token-chunked (``FLAGS_fused_ce`` off or ``vocab_tiled=False``;
    ``n_chunks``, default ``FLAGS_fused_ce_chunks``): full-vocab fp32
    logits a token chunk at a time, discarded after the reduction and
    recomputed in the backward, which sums the weight's gradient in
    fp32. The reference runs it as XLA, so it is plain torch here.
* `cross_entropy` with the reference's soft labels, label smoothing,
  class weights, ``axis`` and ``use_softmax``.
* the losses the loss layers need: mse, l1, smooth_l1, nll, bce,
  bce_with_logits, kl_div, margin_ranking, hinge_embedding,
  cosine_embedding, triplet_margin.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.kernels.fused_cross_entropy import fused_cross_entropy
from ...utils import flags as _flags

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cross_entropy",
           "fused_linear_cross_entropy", "hinge_embedding_loss", "kl_div",
           "l1_loss", "margin_ranking_loss", "mse_loss", "nll_loss",
           "smooth_l1_loss", "triplet_margin_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "none":
        return out
    raise ValueError(f"reduction must be none, sum or mean, got "
                     f"{reduction!r}")


def _valid_mean(losses, valid):
    return losses.sum() / valid.float().sum().clamp(min=1.0)


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy in fp32 over ``axis``, as the reference.

    Hard labels (integers, ``[...]`` or ``[..., 1]``): ``lse - picked``,
    0 at ``ignore_index``; with ``label_smoothing`` e the picked log
    probability becomes ``(1 - e) * picked + e * mean(logp)``; class
    ``weight`` scales each loss, and "mean" then divides by the weights'
    sum over valid labels. Soft labels (``soft_label``, or float labels
    of the input's shape): ``-sum(label * logp)``, the label smoothed to
    ``label * (1 - e) + e / classes``. "mean" over hard labels divides by
    the number of valid labels (at least 1). ``use_softmax=False`` takes
    ``input`` as probabilities."""
    if soft_label and ignore_index != -100:
        raise ValueError(
            "When soft_label == True, the value of ignore_index should "
            f"be -100 (got {ignore_index}): ignore_index is only usable "
            "with hard (integer) labels")
    axis = axis % input.dim()
    is_soft = soft_label or (
        label.dim() == input.dim() and label.shape[axis] == input.shape[axis]
        and label.is_floating_point())
    x32 = input.float()
    if is_soft:
        logp = (torch.log_softmax(x32, axis) if use_softmax
                else torch.log(x32.clamp(min=1e-30)))
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) \
                + label_smoothing / input.shape[axis]
        return _reduce(-(soft * logp).sum(axis), reduction)
    idx = label.long()
    if idx.dim() == input.dim():
        idx = idx.squeeze(axis)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    moved = x32.movedim(axis, -1)
    if use_softmax and label_smoothing == 0.0 and weight is None:
        lse = torch.logsumexp(moved, -1)
        picked = moved.gather(-1, safe[..., None])[..., 0]
        losses = torch.where(valid, lse - picked, _zero(lse))
        if reduction == "mean":
            return _valid_mean(losses, valid)
        return _reduce(losses, reduction)
    logp = (torch.log_softmax(moved, -1) if use_softmax
            else torch.log(moved.clamp(min=1e-30)))
    picked = logp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(-1)
    losses = torch.where(valid, -picked, _zero(picked))
    if weight is not None:
        w = torch.where(valid, weight.float()[safe], _zero(picked))
        losses = losses * w
        if reduction == "mean":
            return losses.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean":
        return _valid_mean(losses, valid)
    return _reduce(losses, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[..., label]`` (log probabilities on the last axis), 0 at
    ``ignore_index``, weighted by ``weight[label]``; "mean" over the
    valid labels' weights (or count)."""
    idx = label.long()
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    losses = torch.where(valid, -input.gather(-1, safe[..., None])[..., 0],
                         _zero(input))
    if weight is not None:
        w = torch.where(valid, weight[safe], _zero(weight))
        losses = losses * w
        if reduction == "mean":
            return losses.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean":
        return _valid_mean(losses, valid)
    return _reduce(losses, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return F.mse_loss(input, label, reduction=reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return F.l1_loss(input, label, reduction=reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """The reference's smooth L1 is torch's Huber loss."""
    return F.huber_loss(input, label, reduction=reduction, delta=delta)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = input.float().clamp(1e-12, 1 - 1e-7)
    losses = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        losses = losses * weight
    return _reduce(losses, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``(1 - y) z + m + log(exp(-m) + exp(-z - m))``, m
    = max(-z, 0), with ``pos_weight`` scaling the log term by
    ``(pw - 1) y + 1``."""
    z, y = logit.float(), label.float()
    m = torch.clamp(-z, min=0)
    log_term = torch.log(torch.exp(-m) + torch.exp(-z - m)) + m
    if pos_weight is not None:
        losses = (1 - y) * z + ((pos_weight - 1) * y + 1) * log_term
    else:
        losses = (1 - y) * z + log_term
    if weight is not None:
        losses = losses * weight
    return _reduce(losses, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        losses = torch.exp(label) * (label - input)
    else:
        losses = label * (torch.log(label.clamp(min=1e-12)) - input)
    if reduction == "batchmean":
        return losses.sum() / input.shape[0]
    return _reduce(losses, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return F.margin_ranking_loss(input, other, label, margin=margin,
                                 reduction=reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / (
        input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        eps=1e-6, swap=False, reduction="mean", name=None):
    def dist(a, b):
        return ((a - b).abs() + eps).pow(p).sum(-1).pow(1.0 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


# ---------------------------------------------------------------------------
# the fused LM-head loss
# ---------------------------------------------------------------------------

def _chunk_logits(hc, w, transpose_y):
    """fp32 logits of a token chunk: the products of the inputs' values
    summed in fp32 (the reference's ``preferred_element_type``)."""
    w32 = w.float()
    return hc.float() @ (w32.t() if transpose_y else w32)


class _TokenChunkedCE(torch.autograd.Function):
    """The reference's ``_fused_linear_ce`` custom VJP: per-token losses
    a chunk of tokens at a time; the backward recomputes each chunk's
    logits, rounds ``d = (softmax - onehot) * g`` to the hidden states'
    dtype and sums the weight's gradient over chunks in fp32."""

    @staticmethod
    def forward(ctx, h, w, labels, transpose_y, ignore_index, n_chunks):
        ctx.save_for_backward(h, w, labels)
        ctx.args = (transpose_y, ignore_index, n_chunks)
        out = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
        for sl in _chunks(h.shape[0], n_chunks):
            logits = _chunk_logits(h[sl], w, transpose_y)
            lc = labels[sl]
            valid = lc != ignore_index
            safe = torch.where(valid, lc, torch.zeros_like(lc)).long()
            lse = torch.logsumexp(logits, -1)
            picked = logits.gather(-1, safe[:, None])[:, 0]
            out[sl] = torch.where(valid, lse - picked, _zero(lse))
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, labels = ctx.saved_tensors
        transpose_y, ignore_index, n_chunks = ctx.args
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dh = torch.empty_like(h)
        w32 = w.float()
        for sl in _chunks(h.shape[0], n_chunks):
            hc, lc = h[sl], labels[sl]
            p = torch.softmax(_chunk_logits(hc, w, transpose_y), -1)
            valid = lc != ignore_index
            safe = torch.where(valid, lc, torch.zeros_like(lc)).long()
            rows = torch.arange(hc.shape[0], device=h.device)
            p[rows, safe] -= 1.0
            d = p * torch.where(valid, g[sl].float(), _zero(p))[:, None]
            d = d.to(h.dtype).float()       # the grads ride in h's dtype
            if transpose_y:                 # w [V, H]
                dh[sl] = (d @ w32).to(h.dtype)
                dw += d.t() @ hc.float()
            else:                           # w [H, V]
                dh[sl] = (d @ w32.t()).to(h.dtype)
                dw += hc.float().t() @ d
        return dh, dw.to(w.dtype), None, None, None, None


def _chunks(n, n_chunks):
    c = -(-n // n_chunks)
    return [slice(i, min(i + c, n)) for i in range(0, n, c)]


def fused_linear_cross_entropy(hidden, weight, labels, transpose_y=True,
                               ignore_index=-100, reduction="mean",
                               n_chunks=None, vocab_tiled=None, name=None):
    """Cross entropy of ``softmax(hidden @ weight^T)`` (``transpose_y``,
    weight ``[V, H]``) or ``softmax(hidden @ weight)`` (weight ``[H, V]``)
    without the ``[tokens, vocab]`` logits. hidden ``[..., H]``, labels
    int ``[...]``; "mean" averages over non-ignored tokens. The route:
    ``vocab_tiled`` (default ``FLAGS_fused_ce``) takes the kernels, else
    the token-chunked one over ``n_chunks`` (default
    ``FLAGS_fused_ce_chunks``) chunks."""
    if n_chunks is None:
        n_chunks = int(_flags.get_flag("FLAGS_fused_ce_chunks"))
    n_chunks = max(1, int(n_chunks))
    if vocab_tiled is None:
        vocab_tiled = bool(_flags.get_flag("FLAGS_fused_ce"))
    flat_h = hidden.reshape(-1, hidden.shape[-1])
    flat_l = labels.reshape(-1)
    if vocab_tiled:
        # the kernel's layout is [V, H]: an [H, V] head transposes outside
        # (autograd routes dweight back through the transpose)
        w_vh = weight if transpose_y else weight.t().contiguous()
        losses = fused_cross_entropy(flat_h, w_vh, flat_l,
                                     ignore_index=ignore_index)
    else:
        losses = _TokenChunkedCE.apply(flat_h, weight, flat_l, transpose_y,
                                       ignore_index, n_chunks)
    if reduction == "none":
        return losses.reshape(labels.shape)
    if reduction == "sum":
        return losses.sum()
    return _valid_mean(losses, flat_l != ignore_index)
