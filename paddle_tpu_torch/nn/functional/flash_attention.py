"""Attention functionals: the port of paddle_tpu/nn/functional/
flash_attention.py's ``scaled_dot_product_attention`` and
``flash_attention``.

Layouts follow the reference: q/k/v ``[batch, seqlen, num_heads,
head_dim]`` (k/v may have fewer heads: GQA), segment ids ``[batch, seq]``
int. Segment ids are passed explicitly (the reference's
``attention_segments`` context is not ported: the port's model threads
them down its forward).

Routing, the reference's under ``FLAGS_splash_attn`` (`utils.flags`,
default on; the environment variable of that name sets it at import):

* segment ids: the splash kernel (`ops.kernels.splash_attention`) when
  the flag is on and no dropout is active; otherwise the reference lowers
  them to a dense mask.
* the flag on, no mask, no active dropout: the splash kernel, at every
  length it takes.
* the flag off, no mask, no active dropout, q/k/v of one shape and
  `ops.kernels.flash_attention.supports`: the flash kernels, the
  single-block pair (#5/#6) at up to 1024 tokens, the tiled pair (#7/#8)
  above (the reference's "round-3 flash/XLA routing").
* anything else (an ``attn_mask``, active attention dropout, the dense
  segment mask, a shape flash does not take): the plain dense attention
  `_sdpa_ref` on CPU tensors; on the card ``NotImplementedError``
  (ROADMAP queue A10) rather than plain PyTorch attention there. In the
  reference these never reach a Pallas kernel either: they are XLA.

On CPU tensors each kernel is its plain version. The reference also gates
splash and flash on ``FLAGS_pallas_flash_min_seqlen``, a length threshold
measured on a TPU; the port does not consult it (`utils.set_flags` still
accepts the name, as the reference accepts any).
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
    kernel_free = attn_mask is None and drop == 0.0
    if kernel_free and splash_on:
        return splash_kernels.splash_attention(
            query, key, value, causal=is_causal, segment_ids=segment_ids,
            scale=scale)
    if kernel_free and segment_ids is None and \
            query.shape == key.shape == value.shape and \
            flash_kernels.supports(tuple(query.shape), query.dtype,
                                   is_causal):
        return flash_kernels.flash_attention(query, key, value,
                                             causal=is_causal, scale=scale)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "attention with an attn_mask, active dropout, the dense "
            "segment mask or a shape the flash kernels do not take has no "
            "kernel on the card (ROADMAP queue A10; the reference runs it "
            "as XLA)")
    return _sdpa_ref(query, key, value, attn_mask, scale, is_causal, drop,
                     segment_ids)


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
