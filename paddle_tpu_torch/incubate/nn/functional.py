"""Fused decode-time functionals of ``paddle.incubate.nn.functional``.

Counterpart of paddle_tpu/incubate/nn/functional.py, so far only
`masked_multihead_attention`, and only the arguments that the dense
decode step of `models.gpt` passes. It has no Pallas kernel in the
reference (XLA fuses it there), so it is plain PyTorch here.
"""
from __future__ import annotations

import torch

__all__ = ["masked_multihead_attention"]


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False, **kwargs):
    """The dense-cache decode step: one new token a sequence, its K/V
    written into the cache at the shared position, q attending the
    cache up to and including it.

    x: [bsz, 3 * num_head * head_dim] fused qkv of the current token;
    cache_kv: [2, bsz, num_head, max_seq, head_dim];
    sequence_lengths: the write position (tokens already cached), an int
    or a one-element tensor: the aligned batch.

    Returns (out [bsz, num_head * head_dim] in x's dtype, cache_kv). The
    reference returns an updated copy of the cache; here the cache is
    written in place (no second [2, bsz, nh, max_seq, d] buffer) and
    returned as it is."""
    unported = {"bias": bias is not None, "src_mask": src_mask is not None,
                "cum_offsets": cum_offsets is not None,
                "rotary_tensor": rotary_tensor is not None,
                "beam_cache_offset": beam_cache_offset is not None,
                "seq_len != 1": seq_len != 1,
                "rotary_emb_dims": bool(rotary_emb_dims),
                "use_neox_rotary_style": bool(use_neox_rotary_style),
                **{k: True for k in kwargs}}
    named = [k for k, on in unported.items() if on]
    if named:
        raise NotImplementedError(
            f"masked_multihead_attention({', '.join(named)}) is not ported "
            f"yet: only the dense decode step's arguments are")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention needs cache_kv "
                         "([2, bsz, num_head, max_seq, head_dim])")
    if sequence_lengths is None:
        raise ValueError("sequence_lengths is required (the write "
                         "position of the aligned batch)")
    if isinstance(sequence_lengths, torch.Tensor):
        if sequence_lengths.numel() != 1:
            raise NotImplementedError(
                "ragged sequence_lengths (one position a row) are not "
                "ported yet: pass the aligned batch's one position")
        sequence_lengths = int(sequence_lengths)
    pos = int(sequence_lengths)
    _, b, nh, ms, d = cache_kv.shape
    qkv = x.reshape(b, 3, nh, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]               # [b, nh, d]
    cache_kv[0, :, :, pos] = k.to(cache_kv.dtype)
    cache_kv[1, :, :, pos] = v.to(cache_kv.dtype)
    kc = cache_kv[0].float()                                 # [b, nh, ms, d]
    vc = cache_kv[1].float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kc) / (d ** 0.5)
    visible = torch.arange(ms, device=x.device) <= pos
    s = s.masked_fill(~visible, -1e9)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, vc)
    return out.reshape(b, nh * d).to(x.dtype), cache_kv
