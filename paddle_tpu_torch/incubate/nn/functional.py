"""Fused functionals of ``paddle.incubate.nn.functional``.

Counterpart of paddle_tpu/incubate/nn/functional.py, so far
`masked_multihead_attention` (the dense decode step), `fused_moe`
(Mixtral-style top-k over all experts) and `fused_ec_moe` (expert
choice). None has a Pallas kernel in the reference (XLA fuses them
there), so they are plain PyTorch here, in the reference's formulation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fused_ec_moe", "fused_moe", "masked_multihead_attention"]


def _positions(sequence_lengths, b, device):
    """The write positions as a device int64 ``[b]`` tensor, and whether
    they are one shared position (aligned) or one a row (ragged). Nothing
    is read back to the host: an aligned tensor position stays on the
    device, a host int becomes a fill."""
    if isinstance(sequence_lengths, torch.Tensor):
        pos = sequence_lengths.to(device=device, dtype=torch.int64)
    elif np.ndim(sequence_lengths) == 0:
        pos = torch.full((), int(sequence_lengths), dtype=torch.int64,
                         device=device)
    else:
        pos = torch.as_tensor(np.asarray(sequence_lengths),
                              dtype=torch.int64, device=device)
    ragged = pos.numel() > 1
    return (pos.reshape(b) if ragged else pos.reshape(1)), ragged


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False, **kwargs):
    """The dense-cache decode step: one new token a sequence, its K/V
    written into the cache at its position, q attending the cache up to
    and including it.

    x: [bsz, 3 * num_head * head_dim] fused qkv of the current token;
    cache_kv: [2, bsz, num_head, max_seq, head_dim]; bias: added to x
    ([3 * num_head * head_dim]); src_mask: an additive bias broadcastable
    to [bsz, 1, 1, max_seq] (a leading 1 broadcasts over the batch),
    added to the scores before the positions past a row's own are
    filled with -1e9; sequence_lengths: the write position (tokens
    already cached): an int or a one-element tensor (the aligned batch:
    a device tensor is never read back to the host), or a [bsz] /
    [bsz, 1] tensor (ragged: each row writes and sees up to its own).
    ``cum_offsets``, ``seq_len``, ``use_neox_rotary_style`` and further
    keywords are accepted and unused, as in the reference.

    Returns (out [bsz, num_head * head_dim] in x's dtype, cache_kv). The
    reference returns an updated copy of the cache; here the cache is
    written in place (no second [2, bsz, nh, max_seq, d] buffer) and
    returned as it is."""
    del cum_offsets, seq_len, use_neox_rotary_style, kwargs
    if rotary_tensor is not None or rotary_emb_dims:
        raise NotImplementedError(
            "apply fused_rotary_position_embedding to q/k before the "
            "cache append; the in-kernel rotary path is not plumbed")
    if beam_cache_offset is not None:
        raise NotImplementedError("beam_cache_offset (beam search decode "
                                  "cache reordering) is descoped")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention needs cache_kv "
                         "([2, bsz, num_head, max_seq, head_dim])")
    if sequence_lengths is None:
        raise ValueError(
            "sequence_lengths is required (int for an aligned batch, "
            "[bsz] tensor for ragged positions)")
    _, b, nh, ms, d = cache_kv.shape
    pos, ragged = _positions(sequence_lengths, b, x.device)
    if bias is not None:
        x = x + bias.reshape(1, -1)
    qkv = x.reshape(b, 3, nh, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]               # [b, nh, d]
    if ragged:
        rows = torch.arange(b, device=x.device)
        cache_kv[0, rows, :, pos] = k.to(cache_kv.dtype)
        cache_kv[1, rows, :, pos] = v.to(cache_kv.dtype)
        visible = torch.arange(ms, device=x.device)[None] <= pos[:, None]
    else:
        # one column of every row: [2, b, nh, 1, d] at the device position
        cache_kv.index_copy_(3, pos, torch.stack([k, v])[:, :, :, None]
                             .to(cache_kv.dtype))
        visible = (torch.arange(ms, device=x.device) <= pos)[None]
    kc = cache_kv[0].float()                                 # [b, nh, ms, d]
    vc = cache_kv[1].float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kc) / (d ** 0.5)
    if src_mask is not None:
        # rank 4, the singleton middle dims collapsed; the batch dim
        # broadcasts (a [1, 1, 1, ms] mask applies to every row)
        mv = src_mask.float()
        while mv.dim() < 4:
            mv = mv[None]
        mv = mv.reshape(mv.shape[0], 1, mv.shape[-1])
        s = s + mv[:, :, :ms]
    s = s.masked_fill(~visible[:, None, :], -1e9)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, vc)
    return out.reshape(b, nh * d).to(x.dtype), cache_kv


def fused_moe(x, gate_weight, ffn1_weight, ffn1_bias, ffn2_weight,
              ffn2_bias, ffn1_scale=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True,
              name=None):
    """Mixtral-style MoE FFN (reference functional.py:91): the fp32
    softmax router over all experts, the top ``moe_topk`` probabilities
    (renormalized to sum 1 with ``norm_topk_prob``), SwiGLU experts, the
    outputs summed by those weights. As in the reference every expert
    runs over every token (batched einsums over the expert dim), the
    unselected ones weighted 0.

    x [b, s, d]; gate_weight [d, E]; ffn1_weight [E, d, 2 * ff] (gate |
    up); ffn1_bias [E, 1, 2 * ff]; ffn2_weight [E, ff, d]; ffn2_bias [E,
    1, d]. Returns [b, s, d]. Quantized weights raise, as there."""
    if quant_method != "None":
        raise NotImplementedError(
            "quantized fused_moe weights are not supported (use "
            "nn.quant.weight_only_linear per expert)")
    b, s, d = x.shape
    t, n_e = b * s, gate_weight.shape[-1]
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ gate_weight.float(), dim=-1)
    topv, topi = torch.topk(probs, int(moe_topk), dim=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    comb = torch.zeros_like(probs).scatter_add(1, topi, topv)   # [t, E]
    h1 = torch.einsum("td,edg->teg", xt, ffn1_weight) \
        + ffn1_bias.reshape(1, n_e, -1)
    g, u = h1.chunk(2, dim=-1)
    h2 = torch.einsum("tef,efd->ted", F.silu(g) * u, ffn2_weight) \
        + ffn2_bias.reshape(1, n_e, -1)
    out = torch.einsum("te,ted->td", comb.to(h2.dtype), h2)
    return out.reshape(b, s, d).to(x.dtype)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Expert-choice MoE (reference functional.py:142): each expert takes
    its ``max(s // 16, 1)`` tokens of highest gate logit in each row,
    runs its two-layer FFN (exact gelu or relu) on them, and adds the
    outputs weighted by the tokens' softmax probabilities onto the
    residual ``x``.

    x [b, s, d]; gate [b, s, e] (logits); bmm0_weight [e, d, ff];
    bmm0_bias [e, 1, ff]; bmm1_weight [e, ff, d]; bmm1_bias [e, 1, d].
    Returns [b, s, d]."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("act_type must be 'gelu' or 'relu'")
    b, s, d = x.shape
    e = gate.shape[-1]
    cap = max(s // 16, 1)
    gates = torch.softmax(gate.float(), dim=-1)
    _, top = torch.topk(gate.transpose(1, 2), cap, dim=-1)  # [b, e, cap]
    xg = torch.gather(x[:, None].expand(b, e, s, d), 2,
                      top[..., None].expand(b, e, cap, d))
    h = torch.einsum("becd,edf->becf", xg, bmm0_weight) \
        + bmm0_bias[None, :, 0, None]
    h = F.gelu(h) if act_type == "gelu" else F.relu(h)
    o = torch.einsum("becf,efd->becd", h, bmm1_weight) \
        + bmm1_bias[None, :, 0, None]
    prob = torch.gather(gates.transpose(1, 2), 2, top)       # [b, e, cap]
    rows = torch.arange(b, device=x.device)[:, None, None].expand_as(top)
    out = torch.zeros_like(x).index_put(
        (rows, top), prob[..., None].to(o.dtype) * o, accumulate=True)
    return out + x
