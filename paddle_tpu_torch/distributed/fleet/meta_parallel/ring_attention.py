"""Ring attention over the sep group: the port of paddle_tpu/distributed/
fleet/meta_parallel/ring_attention.py (:29-299).

A rank is a process that holds its block of the sequence: q, k, v are
the rank's ``[b, blk, h, d]`` (``blk = s / n`` over a sep group of ``n``
ranks; rank r holds global positions ``[r * blk, (r + 1) * blk)``,
`sep_shard` cuts them from a global tensor). The K/V blocks travel round
the ring, one rank on a tick (`collective.p2p_permute` and
`collective.p2p_exchange`), and each tick folds one q-block x kv-block
into an online softmax, so no rank ever holds the whole sequence.

* `ring_attention` (the reference's plain ring, :62-121): each tick is
  `_block_attend` in aten ops (the reference's XLA einsums, not a
  kernel): fp32 scores masked causally at the blocks' global offsets
  with the finite `_NEG_INF`, rows with no visible key zeroed (``alive``),
  ``p`` rounded to the input dtype for bf16 / fp16 unless
  ``FLAGS_attention_fp32_scores``, fp32 accumulators, one rounding at the
  end. Each tick is recomputed in the backward (``torch.utils.checkpoint``,
  the reference's ``jax.checkpoint``), so backward memory stays at one
  block; the backward of the rotation is the reverse ring
  (`p2p_permute`'s). A causal block that lies wholly above the diagonal
  is computed too, as in the reference: its zero grads keep every
  rank's rotation on the backward's path, so each runs the reverse
  ring's transfers its peers post.
* `ring_flash_attention` (:144-299) runs the tiled flash pair each tick
  (`ops.kernels.flash_attention`: #7 ``flash_attention_fwd``, #8
  ``flash_attention_bwd``; on the card their kernels, on the CPU their
  plain versions): a tick is ``diag`` (causal inside the block), ``full``
  or ``skip`` (no launch; the K/V still travel). The output is merged in
  fp32 by the tick's lse (``logaddexp``) and cast once. The backward is
  the reference's hand-written reverse ring (a ``torch.autograd.
  Function``): dq stays home, the dk / dv accumulators (fp32) travel with
  their K/V block for n ticks and arrive home, and every tick's backward
  runs from the global out and lse. A causal ring launches #7 ``r + 1``
  times on rank r a forward, and #8 ``r + 1`` times a backward. The
  block must be a multiple of 128 (the reference's ``_pick_block``), else
  the reference's ``ValueError``.
* `sep_gathered_attention`: the rank's queries over the K/V gathered
  from the sep group (dense aten attention with the row offset), what the
  reference's GSPMD does for dense attention on a sequence-sharded mesh;
  the models run it under a sep degree above 1 without
  ``use_ring_attention``.

The last tick's K/V rotation, which the reference makes and discards, is
left out (a rank already holds every block it needs), as is the K/V's on
the backward's last tick (only dk / dv still have to travel home).

Layout: ``[b, s, h, d]``, one head count (GQA callers repeat K/V to the
query heads first, as the reference's LLaMA does); the flash ring's lse
is ``[b, h, blk]`` fp32 (the reference's is lane-replicated).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...collective import (ReduceOp, all_gather_concat, all_reduce,
                           p2p_exchange, p2p_permute)

__all__ = ["ring_attention", "ring_flash_attention", "sep_cut",
           "sep_gathered_attention", "sep_group", "sep_shard"]

_NEG_INF = -1e30  # finite mask value, as the reference's


def sep_group(group=None):
    """``group``, else the fleet's sep group; None below two ranks (a
    world of one, or a sep degree of 1)."""
    if group is None:
        from ..topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        group = None if hcg is None else hcg.get_sep_parallel_group()
    return group if group is not None and group.nranks > 1 else None


def _ring(group):
    """``(group, n, rank)`` of the sep ring (a ring of one without a
    group)."""
    group = sep_group(group)
    return (group, 1, 0) if group is None else (group, group.nranks,
                                                group.rank)


def sep_shard(x, group=None, axis=1):
    """This rank's block of the sequence dim ``axis`` of a global tensor
    (the counterpart of the reference's ``sep_sharding``, :124-126: the
    placement ``P(None, "sep", ...)``): rank r's ``[r * s / n, (r + 1) *
    s / n)``. A length that does not divide by the degree raises
    (A9b.5b: the reference leaves such a tensor whole)."""
    group, n, r = _ring(group)
    if n == 1:
        return x
    s = x.shape[axis]
    if s % n:
        raise ValueError(
            f"sequence length {s} does not split over the {n} sep ranks: "
            f"ROADMAP A9b.5b (the reference leaves such a tensor whole)")
    blk = s // n
    return x.narrow(axis, r * blk, blk)


def sep_cut(data, group=None):
    """`sep_shard` of dim 1 of every tensor of two dims or more in
    ``data`` (a tensor, or a tuple, list or dict of them, nested); the
    rest as it is."""
    if isinstance(data, (tuple, list)):
        return type(data)(sep_cut(d, group) for d in data)
    if isinstance(data, dict):
        return {k: sep_cut(v, group) for k, v in data.items()}
    if isinstance(data, torch.Tensor) and data.dim() >= 2:
        return sep_shard(data, group)
    return data


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _low_scores(dtype):
    from ....utils import flags as _flags

    return (dtype in (torch.bfloat16, torch.float16)
            and not _flags.get_flag("FLAGS_attention_fp32_scores"))


def _block_attend(q, k, v, row0, col0, scale, causal):
    """One q-block x kv-block step (reference :29-61): ``(m [b, h, sq],
    acc [b, sq, h, d], l [b, h, sq])``, fp32; ``row0`` / ``col0`` the
    blocks' global offsets."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = row0 + torch.arange(s.shape[2], device=q.device)[:, None]
        cols = col0 + torch.arange(s.shape[3], device=q.device)[None]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # fully masked rows: m == NEG_INF, p would be exp(0) = 1; zero them
    p = torch.where((m > _NEG_INF / 2)[..., None], p, torch.zeros_like(p))
    if _low_scores(q.dtype):
        p = p.to(q.dtype)
    l = p.float().sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.to(p.dtype).float())
    return m, acc, l


def _rows(t):
    """``[b, h, q]`` -> ``[b, q, h, 1]``, to scale ``[b, q, h, d]``."""
    return t.transpose(1, 2)[..., None]


def ring_attention(q, k, v, group=None, causal=True, scale=None):
    """Exact attention over the rank's blocks ``[b, blk, h, d]`` of a
    sequence held by the sep ``group`` (default: the fleet's); returns the
    rank's block of the output. Differentiable (module docstring)."""
    group, n, r = _ring(group)
    b, blk, h, d = q.shape
    sc = _scale(q, scale)
    perm = [(i, (i + 1) % n) for i in range(n)]
    m_run = torch.full((b, h, blk), _NEG_INF, device=q.device)
    l_run = torch.zeros((b, h, blk), device=q.device)
    acc = torch.zeros((b, blk, h, d), device=q.device)
    kv = torch.stack([k, v])
    grad = torch.is_grad_enabled()
    for t in range(n):
        args = (q, kv[0], kv[1], r * blk, ((r - t) % n) * blk, sc, causal)
        m_b, acc_b, l_b = (checkpoint(_block_attend, *args,
                                      use_reentrant=False)
                           if grad else _block_attend(*args))
        m_new = torch.maximum(m_run, m_b)
        c_run, c_b = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
        l_run = l_run * c_run + l_b * c_b
        acc = acc * _rows(c_run) + acc_b * _rows(c_b)
        m_run = m_new
        if t < n - 1:
            kv = p2p_permute(kv, perm, group)
    return (acc / _rows(l_run.clamp(min=1e-30))).to(q.dtype)


def _check_flash(q, k, v):
    from ....ops.kernels import flash_attention as fa

    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"the flash ring takes q, k, v of one shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    blk = q.shape[1]
    if fa._pick_block(blk) is None:
        raise ValueError(f"flash ring needs block {blk} % 128 == 0")
    return fa


def _mode(causal, src, r):
    if not causal:
        return "full"
    return "diag" if src == r else ("full" if src < r else "skip")


def _rotate(tensors, group, n):
    """Each tensor to the next rank of the ring, one from the previous:
    one round of transfers."""
    r = group.rank
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    return p2p_exchange([(t, (r + 1) % n) for t in tensors],
                        [(b, (r - 1) % n) for b in bufs], group)


def _flash_fwd(q, k, v, group, n, r, causal, sc):
    fa = _check_flash(q, k, v)
    b, blk, h, _ = q.shape
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, blk), _NEG_INF, device=q.device)
    kt, vt = k, v
    for t in range(n):
        mode = _mode(causal, (r - t) % n, r)
        if mode != "skip":
            ob, lb = fa.flash_attention_fwd(q, kt, vt, mode == "diag", sc)
            new = torch.logaddexp(lse, lb)
            # fp32 across the ring: one rounding at the end
            out = out * _rows(torch.exp(lse - new)) \
                + ob.float() * _rows(torch.exp(lb - new))
            lse = new
        if t < n - 1:
            kt, vt = _rotate([kt, vt], group, n)
    return out.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """The flash ring with the reference's hand-written reverse ring
    (:196-256)."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, r, causal, sc):
        out, lse = _flash_fwd(q, k, v, group, n, r, causal, sc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, r, causal, sc)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ....ops.kernels import flash_attention as fa

        q, k, v, out, lse = ctx.saved_tensors
        group, n, r, causal, sc = ctx.ring
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kt, vt = k, v
        for t in range(n):
            mode = _mode(causal, (r - t) % n, r)
            if mode != "skip":
                g = fa.flash_attention_bwd(q, kt, vt, out, lse, dout,
                                           mode == "diag", sc)
                dq += g[0].float()
                dk += g[1].float()
                dv += g[2].float()
            # dk / dv travel with their block and are home after n ticks
            if n > 1:
                if t < n - 1:
                    kt, vt, dk, dv = _rotate([kt, vt, dk, dv], group, n)
                else:
                    dk, dv = _rotate([dk, dv], group, n)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_flash_attention(q, k, v, group=None, causal=True, scale=None):
    """`ring_attention`'s contract on the tiled flash kernels each tick
    (module docstring); the block ``blk`` must be a multiple of 128 and
    q, k, v one shape."""
    _check_flash(q, k, v)
    group, n, r = _ring(group)
    sc = _scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingFlash.apply(q, k, v, group, n, r, bool(causal), sc)
    return _flash_fwd(q, k, v, group, n, r, bool(causal), sc)[0]


class _GatherSeq(torch.autograd.Function):
    """The sep group's blocks concatenated on dim 1 forward; backward, the
    sum of every rank's grad, this rank's block of it (each rank's
    queries read every block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_concat(x.contiguous(), group, axis=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ReduceOp.SUM, ctx.group)
        return sep_shard(g, ctx.group), None


def sep_gathered_attention(q, k, v, group=None, causal=True, scale=None):
    """The rank's queries over the sep group's whole K/V (gathered), dense
    in aten ops with the row offset ``r * blk`` (`_block_attend` over the
    whole key range, normalised); the rank's block of the output."""
    group, n, r = _ring(group)
    if n > 1:
        k, v = _GatherSeq.apply(k, group), _GatherSeq.apply(v, group)
    m, acc, l = _block_attend(q, k, v, r * q.shape[1], 0, _scale(q, scale),
                              causal)
    return (acc / _rows(l.clamp(min=1e-30))).to(q.dtype)
