"""Attention functionals: the port of paddle_tpu/nn/functional/
flash_attention.py's ``scaled_dot_product_attention``.

Layouts follow the reference: q/k/v ``[batch, seqlen, num_heads,
head_dim]`` (k/v may have fewer heads: GQA), segment ids ``[batch, seq]``
int. Segment ids are passed explicitly (the reference's
``attention_segments`` context is not ported: the port's model threads
them down its forward).

Routing: a causal or plain attention with no mask and no active dropout,
with or without segments, goes to the splash kernel
(`ops.kernels.splash_attention`) at every length it takes; on CPU
tensors that is the kernel's plain version. The reference's length
threshold (``FLAGS_pallas_flash_min_seqlen``) was measured on a TPU and
does not carry over. An ``attn_mask`` or active attention dropout has no
kernel: on the CPU it runs the plain dense attention (`_sdpa_ref`), on
the card it raises ``NotImplementedError`` rather than run plain
PyTorch attention there.
"""
from __future__ import annotations

import torch

from ...ops.kernels.splash_attention import splash_attention

__all__ = ["scaled_dot_product_attention"]


def _sdpa_ref(q, k, v, mask, scale, causal, dropout_p, segment_ids):
    """Dense attention with a boolean or additive mask, segments and
    dropout (the reference's ``_sdpa_ref`` and its segment mask), fp32
    softmax; the plain version for what the kernel does not take."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
            .tril(sk - sq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        logits = logits.masked_fill(
            ~(seg[:, None, :, None] == seg[:, None, None, :sk]),
            float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand_like(probs) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, segment_ids=None):
    """Attention over ``[b, s, heads, d]`` (see the module docstring for
    the routing). ``attn_mask`` together with ``segment_ids`` raises
    ``ValueError``, as in the reference: the two masks do not combine."""
    if segment_ids is not None and attn_mask is not None:
        raise ValueError(
            "scaled_dot_product_attention got both attn_mask and "
            "segment_ids: the masks are not combinable; fold the segment "
            "mask into attn_mask yourself, or drop one")
    drop = dropout_p if training else 0.0
    scale = 1.0 / (query.shape[-1] ** 0.5)
    if attn_mask is None and drop == 0.0:
        return splash_attention(query, key, value, causal=is_causal,
                                segment_ids=segment_ids, scale=scale)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "attention with an attn_mask or active dropout has no kernel "
            "on the card (the splash kernel takes causal and segment "
            "masks, without dropout)")
    return _sdpa_ref(query, key, value, attn_mask, scale, is_causal, drop,
                     segment_ids)
