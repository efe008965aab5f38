"""Attention functionals: the port of paddle_tpu/nn/functional/
flash_attention.py's ``scaled_dot_product_attention`` and
``flash_attention``.

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
  XLA code (bf16 scores stored in bf16, an fp32 softmax), on the CPU and
  on the card alike, as the reference runs it on its accelerator. On the
  card an ``attn_mask``, active attention dropout or the dense segment
  mask raise ``NotImplementedError`` (ROADMAP queue A10).

On CPU tensors each kernel is its plain version. The reference's splash
route also asks that it run on a TPU; the port's kernels run on the card,
and CPU tensors take their plain versions, so the port drops that term.
"""
from __future__ import annotations

import torch

from ...ops.kernels import flash_attention as flash_kernels
from ...ops.kernels import splash_attention as splash_kernels
from ...utils import flags

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _sdpa_ref(q, k, v, mask, scale, causal, dropout_p, segment_ids):
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
        keep = torch.rand_like(probs) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _dense(q, k, v, mask, scale, causal, dropout_p, segment_ids):
    """`_sdpa_ref`; on the card only without a mask, dropout or segment
    ids (those wait on ROADMAP queue A10)."""
    if q.device.type != "cpu" and (mask is not None or dropout_p > 0.0
                                   or segment_ids is not None):
        raise NotImplementedError(
            "attention with an attn_mask, active dropout or the dense "
            "segment mask has no kernel on the card (ROADMAP queue A10; "
            "the reference runs it as XLA)")
    return _sdpa_ref(q, k, v, mask, scale, causal, dropout_p, segment_ids)


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
    splash_on = bool(flags.get_flag("FLAGS_splash_attn"))
    if segment_ids is not None:
        if splash_on and drop == 0.0:
            return splash_kernels.splash_attention(
                query, key, value, causal=is_causal, segment_ids=segment_ids,
                scale=scale)
        return _dense(query, key, value, None, scale, is_causal, drop,
                      segment_ids)
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
    return _dense(query, key, value, attn_mask, scale, is_causal, drop, None)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """The reference's ``flash_attention`` (Paddle's signature): attention
    through `scaled_dot_product_attention`'s routing. Returns ``(out,
    None)``: no softmax is returned, as in the reference."""
    out = scaled_dot_product_attention(
        query, key, value, attn_mask=None, dropout_p=dropout,
        is_causal=causal, training=training)
    return out, None
