"""Attention functionals: the port of paddle_tpu/nn/functional/
flash_attention.py's ``scaled_dot_product_attention`` and
``flash_attention`` and ``flash_attn_unpadded``.

Layouts follow the reference: q/k/v ``[batch, seqlen, num_heads,
head_dim]`` (k/v may have fewer heads: GQA), segment ids ``[batch, seq]``
int. Segment ids are passed explicitly (the reference's
``attention_segments`` context is not ported: the port's model threads
them down its forward).

Routing, the reference's (paddle_tpu/nn/functional/flash_attention.py
``scaled_dot_product_attention``) under ``FLAGS_splash_attn`` (default
on) and ``FLAGS_pallas_flash_min_seqlen`` (default 1024; `utils.flags`,
the environment variables of those names set them at import):

* segment ids: the splash kernel (`ops.kernels.splash_attention`) at any
  length when the flag is on and no dropout is active; otherwise the
  dense attention with the segment mask.
* no segment ids: a kernel only when ``seqlen >= min_seqlen``, with no
  mask and no active dropout: splash when the flag is on and its gate
  (`ops.kernels.splash_attention.supports`: the reference's, lengths a
  multiple of 128) takes the shape; else, with q/k/v of one shape, flash
  when `ops.kernels.flash_attention.supports` takes it: the single-block
  pair (#5/#6) at up to 1024 tokens, the tiled pair (#7/#8) above.
* everything else: the dense attention `_sdpa_ref`, the reference's
  XLA code (bf16 scores stored in bf16, the additive mask cast to their
  dtype, an fp32 softmax, dropout on the fp32 probabilities), as aten
  ops on the CPU and on the card alike, as the reference runs it on its
  accelerator: an ``attn_mask`` (bool or additive, broadcast from ``[b,
  1, 1, s]`` or ``[b, h, sq, sk]``), active attention dropout and the
  dense segment mask all take it.

Dropout keeps a probability with chance ``1 - dropout_p`` and scales it
by ``1 / (1 - dropout_p)``, as the reference's ``bernoulli``; the draws
come from ``generator`` (None: torch's default generator of the
tensor's device), so a model that threads its own generator replays
its masks. A draw is held to that contract, not bit for bit.

On CPU tensors each kernel is its plain version. The reference's splash
route also asks that it run on a TPU; the port's kernels run on the card,
and CPU tensors take their plain versions, so the port drops that term.
"""
from __future__ import annotations

import torch

from ...ops.kernels import flash_attention as flash_kernels
from ...ops.kernels import splash_attention as splash_kernels
from ...utils import flags

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]


def _dropout_probs(probs, dropout_p, generator):
    """``where(keep, probs / (1 - p), 0)`` with ``keep`` drawn at rate
    ``1 - p`` from ``generator``."""
    keep = torch.rand(probs.shape, device=probs.device,
                      generator=generator) >= dropout_p
    return torch.where(keep, probs / (1.0 - dropout_p),
                       torch.zeros((), device=probs.device))


def _sdpa_ref(q, k, v, mask, scale, causal, dropout_p, segment_ids,
              generator=None):
    """Dense attention with a boolean or additive mask, segments and
    dropout (the reference's ``_sdpa_ref`` and its segment mask): fp32
    products, the scores stored in the input dtype when it is bf16 or
    fp16 (the reference's default; its ``FLAGS_attention_fp32_scores`` is
    not ported), an fp32 softmax; the plain version for what no kernel
    takes."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if q.dtype in (torch.bfloat16, torch.float16):
        logits = logits.to(q.dtype)
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
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    if dropout_p > 0.0:
        probs = _dropout_probs(probs, dropout_p, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, segment_ids=None, *,
                                 generator=None):
    """Attention over ``[b, s, heads, d]`` (see the module docstring for
    the routing). ``attn_mask`` together with ``segment_ids`` raises
    ``ValueError``, as in the reference: the two masks do not combine.
    ``generator`` draws the dropout mask."""
    if segment_ids is not None and attn_mask is not None:
        raise ValueError(
            "scaled_dot_product_attention got both attn_mask and "
            "segment_ids: the masks are not combinable; fold the segment "
            "mask into attn_mask yourself, or drop one")
    drop = dropout_p if training else 0.0
    scale = 1.0 / (query.shape[-1] ** 0.5)
    splash_on = bool(flags.get_flag("FLAGS_splash_attn"))
    if segment_ids is not None:
        if splash_on and drop == 0.0:
            return splash_kernels.splash_attention(
                query, key, value, causal=is_causal, segment_ids=segment_ids,
                scale=scale)
        return _sdpa_ref(query, key, value, None, scale, is_causal, drop,
                         segment_ids, generator)
    min_seq = int(flags.get_flag("FLAGS_pallas_flash_min_seqlen"))
    kernel = query.shape[1] >= min_seq and attn_mask is None and drop == 0.0
    if kernel and splash_on and splash_kernels.supports(
            tuple(query.shape), key.shape[2], query.dtype):
        return splash_kernels.splash_attention(
            query, key, value, causal=is_causal, scale=scale)
    if kernel and query.shape == key.shape == value.shape and \
            flash_kernels.supports(tuple(query.shape), query.dtype,
                                   is_causal):
        return flash_kernels.flash_attention(query, key, value,
                                             causal=is_causal, scale=scale)
    return _sdpa_ref(query, key, value, attn_mask, scale, is_causal, drop,
                     None, generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, *,
                    generator=None):
    """The reference's ``flash_attention`` (Paddle's signature): attention
    through `scaled_dot_product_attention`'s routing. Returns ``(out,
    None)``: no softmax is returned, as in the reference."""
    out = scaled_dot_product_attention(
        query, key, value, attn_mask=None, dropout_p=dropout,
        is_causal=causal, training=training, generator=generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, *, generator=None):
    """Varlen attention, the reference's ``flash_attn_unpadded``: q/k/v
    ``[total_tokens, heads, head_dim]``, sequences packed back to back
    with boundaries ``cu_seqlens_*`` (``[batch + 1]``, int). As in the
    reference, one dense attention over all tokens with a block-diagonal
    mask (a token sees the keys of its own sequence; with ``causal``
    those at or before its position in it): fp32 scores (the input's
    dtype is not kept for them here), an fp32 softmax, rows with no
    visible key set to 0, dropout on the probabilities, which are cast
    to V's dtype. Returns ``(out, None)``."""
    drop = float(dropout) if training else 0.0
    tq, tk = query.shape[0], key.shape[0]
    cq = torch.as_tensor(cu_seqlens_q, device=query.device).to(torch.int64)
    ck = torch.as_tensor(cu_seqlens_k, device=query.device).to(torch.int64)
    iq = torch.arange(tq, device=query.device)
    ik = torch.arange(tk, device=query.device)
    seg_q = torch.searchsorted(cq, iq, right=True)         # 1-based
    seg_k = torch.searchsorted(ck, ik, right=True)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q, pos_k = iq - cq[seg_q - 1], ik - ck[seg_k - 1]
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    logits = torch.einsum("qhd,khd->hqk", query.float(), key.float()) * scale
    logits = logits.masked_fill(~mask[None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=1)[None, :, None], probs,
                        torch.zeros((), device=query.device))
    if drop > 0.0:
        probs = _dropout_probs(probs, drop, generator)
    out = torch.einsum("hqk,khd->qhd", probs.to(value.dtype).float(),
                       value.float())
    return out.to(query.dtype), None
