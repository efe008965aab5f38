"""The port of paddle_tpu/nn/functional/extras.py's attention wrappers:
``flash_attn_qkvpacked``, ``flash_attn_varlen_qkvpacked`` and
``flash_attention_with_sparse_mask`` (``log_sigmoid`` lives in
`activation`; the rest of that file: ROADMAP queue A10b)."""
from __future__ import annotations

import torch

from .flash_attention import (flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)

__all__ = ["flash_attention_with_sparse_mask", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True, name=None,
                         *, generator=None, **kwargs):
    """``qkv [batch, seq, 3, heads, dim]`` -> `flash_attention` over its
    three views (no copy: the kernels take strided q/k/v). Returns
    ``(out, None)``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training,
                           generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None, *, generator=None, **kwargs):
    """``qkv [total_tokens, 3, heads, dim]`` -> `flash_attn_unpadded`
    over its three views. Returns ``(out, None)``."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale, dropout=dropout,
                               causal=causal, training=training,
                               generator=generator)


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, training=True,
                                     name=None, *, generator=None):
    """The reference's row-sparse causal mask: query row ``r`` sees key
    column ``c`` when ``c <= r`` and ``c < start_row_indices[b, h, r]``
    (``[b, h or 1, s]``), composed into a bool mask for
    `scaled_dot_product_attention` (non-causal there: the mask holds
    the causal part), as the reference composes it."""
    s = query.shape[1]
    ind = torch.as_tensor(attn_mask_start_row_indices, device=query.device)
    rows = torch.arange(s, device=query.device)[None, None, :, None]
    cols = torch.arange(s, device=query.device)[None, None, None, :]
    mask = (cols <= rows) & (cols < ind[:, :, :, None])
    return scaled_dot_product_attention(query, key, value, attn_mask=mask,
                                        dropout_p=dropout_p, is_causal=False,
                                        training=training,
                                        generator=generator)
