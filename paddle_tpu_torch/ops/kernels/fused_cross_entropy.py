"""Fused LM-head cross entropy over vocab tiles: CUDA kernels for the card,
plain PyTorch for the CPU.

Counterpart of paddle_tpu/ops/pallas/fused_cross_entropy.py: the per-token
cross entropy of ``softmax(hidden @ weight^T)`` with the ``[N, vocab]``
logits streamed through vocab tiles, so they never exist in device memory
in the forward or the backward. ``hidden [N, H]``, ``weight [V, H]`` (the
tied-embedding layout), ``labels [N]`` int; losses ``[N]`` fp32, 0 where
``labels == ignore_index``, whose rows also get zero gradients.

* `fused_cross_entropy`: the differentiable entry (a
  ``torch.autograd.Function``, gradients in ``hidden`` and ``weight``).
* `fused_ce_fwd`: ``(losses, lse)``; kernel #11: in bf16 a warpgroup
  GEMM with an online-logsumexp epilogue (``fused_ce_fwd_wgmma_kernel``,
  the backward's mainloop), in fp32 ``fused_ce_fwd_kernel``.
* `fused_ce_bwd`: ``(dh, dw)`` from the lse and the effective cotangent
  ``g_eff`` (0 on ignored rows); kernel #12: in bf16 three warpgroup
  GEMMs a vocab chunk (`plan_chunks` sizes the chunks), in fp32 the dh
  and dW kernels.
* The vocab-parallel head (the reference's ``sharded_fused_cross_entropy``,
  :455-588): each rank of a model-parallel group holds the row block
  ``[vocab_start, vocab_start + V/mp)`` of the head. `sharded_fused_ce_fwd`
  runs #11 on the shard and gives the rank's ``(lse_r, picked_r)``, the
  combine kernel writing ``picked`` beside ``lse`` (``lse - loss``
  would cancel); `sharded_fused_cross_entropy` combines them over the
  group as the reference does (the max of ``lse_r``, then one all-reduce
  of ``[exp(lse_r - max), picked_r]``), and its backward runs #12 on the
  shard against the global lse (`sharded_fused_ce_bwd`): dW is exactly
  the shard's rows, dh this rank's part of the sum over the group.
  Labels become the shard's columns first (`local_labels`): a label
  outside the shard (another rank's, or ``ignore_index``) matches no
  column, the shard's padded columns included, which would otherwise
  alias the next rank's first ids. The plain versions
  `sharded_fused_ce_fwd_ref` / `sharded_fused_ce_bwd_ref` transcribe
  ``_fwd_xla_sharded`` / ``_bwd_xla_sharded``.

Routing is by the tensors' device, nothing else: CPU tensors take the
plain versions `fused_ce_fwd_ref` / `fused_ce_bwd_ref` (transcriptions of
``_fwd_xla`` / ``_bwd_xla``: the same 128-column vocab tiles in the same
order, fp32 accumulation); CUDA tensors launch the kernels of
``csrc/fused_cross_entropy.cu`` or raise. The kernels take any N and any
vocab, and ``H`` a multiple of 16. The wrappers allocate the kernels'
scratch: the forward's per-split row statistics; the bf16 backward's d
chunk ``[N, width]`` bf16 and, with more than one chunk, the fp32 sums of
dh ``[N, H]``, within `SCRATCH_BYTES`; the fp32 backward's fp32 sums of
dh (one ``[N, H]`` plane per vocab split) and of dW. Each wrapper counts
its launches in ``<wrapper>.launches``, but the bf16 forward counts in
``fused_ce_fwd.launches_wgmma``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_cross_entropy", "fused_ce_fwd", "fused_ce_bwd",
           "fused_ce_fwd_ref", "fused_ce_bwd_ref", "local_labels",
           "plan_chunks", "sharded_fused_ce_bwd", "sharded_fused_ce_bwd_ref",
           "sharded_fused_ce_fwd", "sharded_fused_ce_fwd_ref",
           "sharded_fused_cross_entropy"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # h, w, labels, loss, lse, picked (or null), part, n, vocab, hidden,
    # ignore_index, tiles_per_split, bf16, stream
    "fused_ce_fwd": (_P,) * 7 + (_I,) * 6 + (_P,),
    # bf16 on warpgroup products: h, w, labels, loss, lse, picked, part,
    # n, vocab, hidden, ignore_index, stream
    "fused_ce_fwd_bf16": (_P,) * 7 + (_I,) * 4 + (_P,),
    # fp32: h, w, labels, lse, g_eff, dh, dw, dh32, dw32, n, vocab, hidden,
    # tiles_per_split, stream
    "fused_ce_bwd": (_P,) * 9 + (_I,) * 4 + (_P,),
    # bf16: h, w, labels, lse, g_eff, dh, dw, dchunk, dh32, n, vocab,
    # hidden, width, stream
    "fused_ce_bwd_bf16": (_P,) * 9 + (_I,) * 4 + (_P,),
    # the bf16 backward's dynamic shared memory a block
    "fused_ce_bwd_bf16_smem": (),
}
_DTYPES = (torch.float32, torch.bfloat16)
BLOCK_V = 128       # the plain versions' vocab tile (_fwd_xla's _LANES)
ROWS, TILE_V = 64, 128   # the kernels' token and vocab tiles
CHUNK_TILE = 256   # the bf16 kernels' vocab tile; chunks are multiples
SCRATCH_BYTES = 256 << 20   # the bf16 backward's scratch budget


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tiles(weight, bv):
    """Vocab tiles of ``weight`` padded with zero rows to a multiple of
    ``bv``: ``[nv, bv, H]``."""
    vocab, hidden = weight.shape
    nv = -(-vocab // bv)
    pad = nv * bv - vocab
    if pad:
        weight = torch.cat([weight, weight.new_zeros(pad, hidden)])
    return weight.reshape(nv, bv, hidden), nv, pad


def _online_ref(hidden, weight, labels, block_v):
    """The online pass of `fused_ce_fwd_ref`: each row's running max,
    sum of exponentials and picked label logit, fp32 ``[N]`` each."""
    n = hidden.shape[0]
    vocab = weight.shape[0]
    wt, nv, pad = _tiles(weight, block_v)
    lbl = labels.long()[:, None]
    h32 = hidden.float()
    m = torch.full((n,), float("-inf"), device=hidden.device)
    l = torch.zeros(n, device=hidden.device)
    pk = torch.zeros(n, device=hidden.device)
    cols = torch.arange(block_v, device=hidden.device)[None]
    for t in range(nv):
        logits = h32 @ wt[t].float().T                    # [n, bv] fp32
        col = t * block_v + cols
        if pad:
            logits = logits.masked_fill(col >= vocab, float("-inf"))
        m_new = torch.maximum(m, logits.max(dim=1).values)
        corr = torch.exp(m - m_new)
        l = corr * l + torch.exp(logits - m_new[:, None]).sum(dim=1)
        pk = pk + torch.where(col == lbl, logits,
                              torch.zeros((), device=hidden.device)).sum(1)
        m = m_new
    return m, l, pk


def fused_ce_fwd_ref(hidden, weight, labels, ignore_index=-100,
                     block_v=BLOCK_V):
    """Online logsumexp over vocab tiles (_fwd_xla): ``(losses, lse)``,
    both fp32 ``[N]``."""
    m, l, pk = _online_ref(hidden, weight, labels, block_v)
    lse = m + torch.log(l)
    losses = torch.where(labels != ignore_index, lse - pk,
                         torch.zeros((), device=hidden.device))
    return losses, lse


def local_labels(labels, vocab_start, vocab_local):
    """``labels`` (global ids) as columns of the shard ``[vocab_start,
    vocab_start + vocab_local)``: ids outside it (another shard's, and
    ``ignore_index``) become -1, which matches no column."""
    rel = labels.long() - int(vocab_start)
    return torch.where((rel >= 0) & (rel < vocab_local), rel,
                       torch.full_like(rel, -1))


def sharded_fused_ce_fwd_ref(hidden, weight_local, labels, vocab_start,
                             block_v=BLOCK_V):
    """The shard's online pass (_fwd_xla_sharded): ``(lse_r, picked_r)``,
    fp32 ``[N]``: the logsumexp over the shard's vocab rows and the
    label's logit where the label lies in the shard (else 0)."""
    lbl = local_labels(labels, vocab_start, weight_local.shape[0])
    m, l, pk = _online_ref(hidden, weight_local, lbl, block_v)
    return m + torch.log(l), pk


def sharded_fused_ce_bwd_ref(hidden, weight_local, labels, vocab_start, lse,
                             g_eff, block_v=BLOCK_V):
    """The shard's tiled backward (_bwd_xla_sharded) against the global
    ``lse``: ``(dh, dw)``, dh this rank's part of the sum over the group,
    dw the shard's rows."""
    lbl = local_labels(labels, vocab_start, weight_local.shape[0])
    return fused_ce_bwd_ref(hidden, weight_local, lbl, lse, g_eff, block_v)


def fused_ce_bwd_ref(hidden, weight, labels, lse, g_eff, block_v=BLOCK_V):
    """The tiled backward (_bwd_xla): d = (softmax - onehot) * g_eff per
    vocab tile, cast to hidden's dtype before both products; fp32 sums.
    Returns ``(dh, dw)`` in hidden's and weight's dtypes."""
    n, hsz = hidden.shape
    vocab = weight.shape[0]
    wt, nv, pad = _tiles(weight, block_v)
    lbl = labels.long()[:, None]
    h32 = hidden.float()
    cols = torch.arange(block_v, device=hidden.device)[None]
    dh = torch.zeros(n, hsz, device=hidden.device)
    dws = []
    for t in range(nv):
        w32 = wt[t].float()
        logits = h32 @ w32.T
        col = t * block_v + cols
        if pad:
            logits = logits.masked_fill(col >= vocab, float("-inf"))
        p = torch.exp(logits - lse[:, None])
        d = (p - (col == lbl).float()) * g_eff[:, None]
        dlow = d.to(hidden.dtype).float()
        dh = dh + dlow @ w32
        dws.append(dlow.T @ h32)                           # [bv, H] fp32
    dw = torch.cat(dws)[:vocab]
    return dh.to(hidden.dtype), dw.to(weight.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(hidden, weight, labels):
    if hidden.dim() != 2 or weight.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"need hidden [N, H], weight [V, H], labels [N]; "
                         f"got {tuple(hidden.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(labels.shape)}")
    if weight.shape[1] != hidden.shape[1] \
            or labels.shape[0] != hidden.shape[0]:
        raise ValueError(f"shape mismatch: hidden {tuple(hidden.shape)}, "
                         f"weight {tuple(weight.shape)}, labels "
                         f"{tuple(labels.shape)}")
    devs = {t.device for t in (hidden, weight, labels)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = hidden.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cross_entropy: no kernel for {dev}")
    if dev.type == "cuda":
        if hidden.dtype not in _DTYPES or weight.dtype != hidden.dtype:
            raise TypeError(f"hidden/weight must share float32 or "
                            f"bfloat16, got {hidden.dtype}/{weight.dtype}")
        if hidden.shape[1] % 16:
            raise ValueError(f"hidden size {hidden.shape[1]}: the kernels "
                             f"take a multiple of 16")
        for name, t in (("hidden", hidden), ("weight", weight)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 f"aligned")


def _run(fn, *args):
    lib = _build.load("fused_cross_entropy", _SIGNATURES)
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def _split(n, vocab, device):
    """``(splits, tiles_per_split)``: the forward and dh kernels walk the
    vocab tiles in ``splits`` parts, enough for the grid to fill the card
    once at two blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-vocab // TILE_V)
    want = max(1, min(tiles, 2 * sms // -(-n // ROWS)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def plan_chunks(n, vocab, hidden):
    """The bf16 backward's walk over the vocab: ``(width, chunks)``, with
    ``chunks`` the ``(v0, rows)`` of each chunk in order, covering
    ``[0, vocab)``, every one ``width`` rows (a multiple of `CHUNK_TILE`)
    but the last, which may be ragged. The widths are as even as the tile
    allows, so the last chunk's grids are not a sliver. Scratch: the d
    chunk ``[n, width]`` bf16 and, with more than one chunk, the fp32 sums
    of dh ``[n, hidden]``; it stays within `SCRATCH_BYTES` unless one
    tile of d beside the dh sums already exceeds it (then one tile a
    chunk)."""
    tiles = -(-vocab // CHUNK_TILE)
    per_tile = n * CHUNK_TILE * 2
    if tiles * per_tile <= SCRATCH_BYTES:
        n_chunks = 1
    else:
        fit = max(1, (SCRATCH_BYTES - n * hidden * 4) // per_tile)
        n_chunks = -(-tiles // fit)
    width = -(-tiles // n_chunks) * CHUNK_TILE
    return width, [(v0, min(width, vocab - v0))
                   for v0 in range(0, vocab, width)]


def _fwd_tiles(hidden, weight, lbl, ignore_index, loss, lse, picked=None):
    """``fused_ce_fwd_kernel`` + combine (the fp32 route; in bf16 the
    first design, which `chip_smoke.py` times beside the warpgroup
    route)."""
    n, hsz = hidden.shape
    vocab, dev = weight.shape[0], hidden.device
    splits, per = _split(n, vocab, dev)
    part = torch.empty(3, splits, n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("fused_ce_fwd", hidden.data_ptr(), weight.data_ptr(),
             lbl.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             None if picked is None else picked.data_ptr(),
             part.data_ptr(), n, vocab, hsz, int(ignore_index), per,
             int(hidden.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)


def fused_ce_fwd(hidden, weight, labels, ignore_index=-100):
    """``(losses, lse)``, fp32 ``[N]`` each. CUDA tensors launch, in bf16,
    ``fused_ce_fwd_wgmma_kernel`` (one warpgroup GEMM tile of 128 tokens
    x 256 vocab rows a block, counted in ``.launches_wgmma``) and in fp32
    ``fused_ce_fwd_kernel`` (``.launches``), each with the combine."""
    _check(hidden, weight, labels)
    if hidden.device.type == "cpu":
        return fused_ce_fwd_ref(hidden, weight, labels, ignore_index)
    return _fwd_launch(hidden, weight, labels, ignore_index)[:2]


def _fwd_launch(hidden, weight, labels, ignore_index, picked=False):
    """The forward's launches on CUDA tensors: ``(loss, lse, picked)``
    (``picked`` None unless asked for)."""
    n, hsz = hidden.shape
    vocab, dev = weight.shape[0], hidden.device
    loss = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    pk = torch.empty(n, dtype=torch.float32, device=dev) if picked else None
    if n == 0:
        return loss, lse, pk
    lbl = labels.to(torch.int32).contiguous()
    if hidden.dtype != torch.bfloat16:
        _fwd_tiles(hidden, weight, lbl, ignore_index, loss, lse, pk)
        fused_ce_fwd.launches += 1
        return loss, lse, pk
    # the per-tile (m, l, picked) of every 256-row vocab tile
    part = torch.empty(3, -(-vocab // CHUNK_TILE), n, dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        _run("fused_ce_fwd_bf16", hidden.data_ptr(), weight.data_ptr(),
             lbl.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             None if pk is None else pk.data_ptr(), part.data_ptr(), n,
             vocab, hsz, int(ignore_index),
             torch.cuda.current_stream(dev).cuda_stream)
    fused_ce_fwd.launches_wgmma += 1
    return loss, lse, pk


def fused_ce_bwd(hidden, weight, labels, lse, g_eff):
    """``(dh, dw)`` in hidden's and weight's dtypes; ``g_eff`` is the fp32
    loss cotangent, 0 on ignored rows. CUDA tensors launch, in bf16, the
    three GEMMs of every vocab chunk, and in fp32 the dh and dW kernels
    and the cast of their fp32 sums (one count either way)."""
    _check(hidden, weight, labels)
    if hidden.device.type == "cpu":
        return fused_ce_bwd_ref(hidden, weight, labels, lse, g_eff)
    n, hsz = hidden.shape
    vocab, dev = weight.shape[0], hidden.device
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(weight)
    if n == 0:
        return dh, dw.zero_()
    lbl = labels.to(torch.int32).contiguous()
    g = g_eff.to(torch.float32).contiguous()
    lse = lse.contiguous()
    common = (hidden.data_ptr(), weight.data_ptr(), lbl.data_ptr(),
              lse.data_ptr(), g.data_ptr(), dh.data_ptr(), dw.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if hidden.dtype == torch.bfloat16:
            width, chunks = plan_chunks(n, vocab, hsz)
            dchunk = torch.empty(n, width, dtype=torch.bfloat16, device=dev)
            dh32 = torch.empty(n, hsz, dtype=torch.float32, device=dev) \
                if len(chunks) > 1 else None
            _run("fused_ce_bwd_bf16", *common, dchunk.data_ptr(),
                 None if dh32 is None else dh32.data_ptr(), n, vocab, hsz,
                 width, stream)
        else:
            splits, per = _split(n, vocab, dev)
            # the fp32 sums: dh per split, over whole token and vocab tiles
            dh32 = torch.empty(splits, -(-n // ROWS) * ROWS, hsz,
                               dtype=torch.float32, device=dev)
            dw32 = torch.empty(-(-vocab // TILE_V) * TILE_V, hsz,
                               dtype=torch.float32, device=dev)
            _run("fused_ce_bwd", *common, dh32.data_ptr(), dw32.data_ptr(),
                 n, vocab, hsz, per, stream)
    fused_ce_bwd.launches += 1
    return dh, dw


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index):
        losses, lse = fused_ce_fwd(hidden, weight, labels, ignore_index)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.ignore_index = ignore_index
        return losses

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        # ignored rows contribute a constant 0 loss: zero their cotangent
        # so the recomputed (p - onehot) term cannot leak through them
        g_eff = torch.where(labels != ctx.ignore_index, g.float(),
                            torch.zeros((), device=g.device))
        dh, dw = fused_ce_bwd(hidden, weight, labels, lse, g_eff)
        return dh, dw, None, None


def fused_cross_entropy(hidden, weight, labels, ignore_index=-100):
    """Per-token CE of ``softmax(hidden @ weight^T)`` through vocab tiles
    (see the module docstring); fp32 losses ``[N]``."""
    _check(hidden, weight, labels)
    return _FusedCE.apply(hidden, weight, labels, int(ignore_index))


# ---------------------------------------------------------------------------
# the vocab-parallel head
# ---------------------------------------------------------------------------

def sharded_fused_ce_fwd(hidden, weight_local, labels, vocab_start):
    """``(lse_r, picked_r)`` of the shard (`sharded_fused_ce_fwd_ref`'s
    contract). CUDA tensors launch #11 on the shard (counted as
    `fused_ce_fwd` counts) with the labels as the shard's columns, the
    combine writing ``picked``."""
    _check(hidden, weight_local, labels)
    if hidden.device.type == "cpu":
        return sharded_fused_ce_fwd_ref(hidden, weight_local, labels,
                                        vocab_start)
    lbl = local_labels(labels, vocab_start, weight_local.shape[0])
    _, lse, pk = _fwd_launch(hidden, weight_local, lbl, -1, picked=True)
    return lse, pk


def sharded_fused_ce_bwd(hidden, weight_local, labels, vocab_start, lse,
                         g_eff):
    """``(dh, dw)`` of the shard against the global ``lse``
    (`sharded_fused_ce_bwd_ref`'s contract); CUDA tensors launch #12 on
    the shard (counted in ``fused_ce_bwd.launches``)."""
    _check(hidden, weight_local, labels)
    lbl = local_labels(labels, vocab_start, weight_local.shape[0])
    if hidden.device.type == "cpu":
        return fused_ce_bwd_ref(hidden, weight_local, lbl, lse, g_eff)
    return fused_ce_bwd(hidden, weight_local, lbl, lse, g_eff)


class _ShardedFusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight_local, labels, vocab_start, group,
                ignore_index):
        from ...distributed.fleet.layers.mpu.mp_ops import combine_lse

        lse_r, pk_r = sharded_fused_ce_fwd(hidden, weight_local, labels,
                                           vocab_start)
        lse, pk = combine_lse(lse_r, pk_r, group)
        losses = torch.where(labels != ignore_index, lse - pk,
                             torch.zeros((), device=lse.device))
        ctx.save_for_backward(hidden, weight_local, labels, lse)
        ctx.vocab_start, ctx.ignore_index = vocab_start, ignore_index
        return losses

    @staticmethod
    def backward(ctx, g):
        hidden, weight_local, labels, lse = ctx.saved_tensors
        g_eff = torch.where(labels != ctx.ignore_index, g.float(),
                            torch.zeros((), device=g.device))
        dh, dw = sharded_fused_ce_bwd(hidden, weight_local, labels,
                                      ctx.vocab_start, lse, g_eff)
        return dh, dw, None, None, None, None


def sharded_fused_cross_entropy(hidden, weight_local, labels, vocab_start,
                                group=None, ignore_index=-100):
    """The vocab-parallel fused CE (reference :568): ``hidden [N, H]``
    (the same on every rank of ``group``), ``weight_local [V/mp, H]``
    (this rank's row block of the ``[V, H]`` head, starting at global id
    ``vocab_start``), ``labels [N]`` global ids. fp32 losses ``[N]``,
    the same on every rank, 0 at ``ignore_index``. Differentiable in
    ``hidden`` (this rank's part: the caller sums it over the group, as
    Megatron's identity-forward / all-reduce-backward operator does) and
    ``weight_local`` (exactly the shard's rows). Each rank's loss
    cotangent is the whole one: no sum over the group, whose ranks all
    hold it (the reference's psum of the seeds and its 1/mp
    normalization cancel)."""
    _check(hidden, weight_local, labels)
    return _ShardedFusedCE.apply(hidden, weight_local, labels,
                                 int(vocab_start), group, int(ignore_index))


fused_ce_fwd.launches = fused_ce_fwd.launches_wgmma = 0
fused_ce_bwd.launches = 0
