"""The port of paddle_tpu/nn/functional/extras.py: only
``flash_attn_qkvpacked`` so far (``log_sigmoid`` lives in
`activation`; the rest: ROADMAP queue A10)."""
from __future__ import annotations

from .flash_attention import flash_attention

__all__ = ["flash_attn_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True, name=None,
                         **kwargs):
    """``qkv [batch, seq, 3, heads, dim]`` -> `flash_attention` over its
    three views (no copy: the kernels take strided q/k/v). Returns
    ``(out, None)``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)
