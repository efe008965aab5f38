"""Common functionals: the port of paddle_tpu/nn/functional/common.py
(linear, the dropouts, embedding, one_hot, label_smooth, pad,
cosine_similarity, normalize, bilinear, sequence_mask).

``linear`` takes the reference's ``[in, out]`` weight (``x @ W + b``);
the port's `nn.Linear` layer holds ``[out, in]`` and calls
``torch.nn.functional.linear`` itself. The dropouts draw their masks
from an explicit ``generator`` (None: torch's default generator of the
tensor's device), Bernoulli(1 - p) of the mask's shape, as the
reference's ``jax.random.bernoulli``; a draw is held to that contract,
not bit for bit.

Not ported yet, and raising (ROADMAP queue A10): the vision resampling
functions ``interpolate`` / ``upsample``, ``unfold`` / ``fold``,
``pixel_shuffle`` / ``pixel_unshuffle``, ``channel_shuffle``,
``affine_grid``, ``grid_sample`` and ``temporal_shift``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializer import to_torch_dtype

__all__ = ["alpha_dropout", "bilinear", "cosine_similarity", "dropout",
           "dropout2d", "dropout3d", "embedding", "label_smooth", "linear",
           "normalize", "one_hot", "pad", "sequence_mask"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with the reference's ``[in, out]`` weight."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _keep_mask(x, p, axis, generator):
    if axis is None:
        shape = x.shape
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    return torch.rand(shape, device=x.device,
                      generator=generator) < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each element (or each slice along ``axis``) with probability
    ``p`` in training. ``"upscale_in_train"`` scales what is kept by
    ``1 / (1 - p)``; ``"downscale_in_infer"`` keeps it as it is. Outside
    training both return ``x`` (a copy), as the reference's does."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        return x.clone()
    if p == 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x, p, axis, generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU-preserving dropout: dropped elements take ``-alpha * scale``,
    then ``a * x + b`` keeps the mean and variance."""
    if not training or p == 0.0:
        return x.clone()
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep_mask(x, p, None, generator)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` read 0 (and
    pass no gradient), as the reference's ``where``."""
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        pad = padding_idx % weight.shape[0]
        out = torch.where((x == pad)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def one_hot(x, num_classes, name=None):
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * torch.as_tensor(
            prior_dist, dtype=label.dtype, device=label.device)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def _pad_index(n, lo, hi, mode, device):
    idx = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return idx.clamp(0, n - 1)
    if mode == "circular":
        return idx.remainder(n)
    period = 2 * (n - 1)                        # reflect
    idx = idx.abs().remainder(period)
    return torch.where(idx > n - 1, period - idx, idx)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: ``pad`` lists (low, high) pairs, either one pair per
    axis from the first (``len == 2 * ndim``) or for the trailing spatial
    axes, last axis first (the channel axis left out by
    ``data_format``). Modes constant, reflect, replicate, circular."""
    pad = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        npad = len(pad) // 2
        widths = [(0, 0)] * nd
        spatial = (list(range(2, nd)) if data_format in ("NCHW", "NCL",
                                                          "NCDHW")
                   else list(range(1, nd - 1)))
        spatial = spatial[-npad:] if npad <= len(spatial) else spatial
        for i in range(npad):
            dim = (spatial[len(spatial) - 1 - i] if i < len(spatial)
                   else nd - 1 - i)
            widths[dim] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return F.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for dim, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                               x.device))
    return x


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = (x1 * x2).sum(axis)
    n1 = (x1 * x1).sum(axis).sqrt()
    n2 = (x2 * x2).sum(axis).sqrt()
    return dot / torch.clamp(n1 * n2, min=eps)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = x.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias[o])``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths ``[...]`` -> ``[..., maxlen]``, 1 below each length. The
    reference needs a static ``maxlen``; so does the port."""
    if maxlen is None:
        raise ValueError("sequence_mask needs maxlen, as in the reference")
    rng = torch.arange(maxlen, device=x.device)
    return (rng < x[..., None]).to(to_torch_dtype(dtype))


def _refused(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"nn.functional.{name} is not ported yet: ROADMAP queue A10")
    refuse.__name__ = name
    return refuse


for _name in ("interpolate", "upsample", "unfold", "fold", "pixel_shuffle",
              "pixel_unshuffle", "channel_shuffle", "affine_grid",
              "grid_sample", "temporal_shift"):
    globals()[_name] = _refused(_name)
