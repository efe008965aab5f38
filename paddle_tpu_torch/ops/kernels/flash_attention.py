"""Flash attention: CUDA kernels for the card, plain PyTorch for the CPU.

Counterpart of paddle_tpu/ops/pallas/flash_attention.py, in its public
layout: q, k, v ``[b, s, h, d]`` with one head count (no GQA), ``sk`` may
differ from ``sq`` when not causal; ``lse`` is ``[b, h, sq]`` fp32 (the
reference keeps it lane-replicated, ``[b*h, sq, 128]``). The two paths of
the reference:

* single-block (``s <= 1024``): `flash_attention_fwd_single` (kernel #5)
  is an exact softmax, ``P = exp(s - max) / sum`` rounded to the value
  dtype before ``P V``, with no lse (in bf16 on warpgroup products,
  ``csrc/hopper_tiles.cuh``); `flash_attention_bwd_single` (#6)
  recomputes it from q, k, v alone, with ``delta = sum(p * dP)`` (in
  bf16 on warpgroup products, ``csrc/attention_wgmma_bwd.cuh``).
* tiled: `flash_attention_fwd` (#7) is an online softmax over key tiles
  returning ``(out, lse)``: ``P`` is rounded unnormalised, after the
  running max is subtracted, and ``O`` divided by the sum at the end (in
  bf16 on warpgroup products, ``csrc/attention_wgmma.cuh``, shared with
  splash's forward);
  `flash_attention_bwd` (#8) takes ``lse`` and ``out`` from outside. Under
  ring attention they are the global ones, so ``p = exp(s - lse)`` sums to
  less than 1 over one key block; nothing renormalises, and
  ``delta = rowsum(dO * O)`` comes from the given ``out``. This is the
  contract ``ring_flash_attention`` builds on (in bf16 on the warpgroup
  backward of ``csrc/attention_wgmma_bwd.cuh``, shared with #6).

`flash_attention` picks the path as the reference does and is
differentiable (two ``torch.autograd.Function``s: the single path keeps
q, k, v for its backward, the tiled path q, k, v, out, lse). ``block_q`` /
``block_k`` only select the tiled path, as in the reference; the kernels
pick their own tiles (64 rows and keys in fp32; 128 in the bf16
forwards, 64 to 128 in the bf16 backwards), and the plain tiled forward
rounds ``P`` per 64-key tile as the fp32 kernel does.

Routing is by the tensors' device, nothing else: CPU tensors take the
plain versions (`flash_attention_single_ref`,
`flash_attention_single_bwd_ref`, `flash_attention_ref`,
`flash_attention_bwd_ref`, which transcribe the TPU kernels with their
cast points); CUDA tensors launch the kernels of
``csrc/flash_attention.cu`` or raise. On the card the kernels take
float32 and bfloat16 (float16: ROADMAP queue B), ``d`` a multiple of 16 up
to 128 (up to 64 for a float32 backward, by shared memory; larger ``d``:
ROADMAP queue B), and q/k/v as strided views (unit stride along ``d``,
16-byte aligned rows), so the qkv product's views need no copy. Each entry
counts its launches in ``<entry>.launches``, except the bf16 launches of
the tiled forward and of both backwards, which count in
``<entry>.launches_wgmma``: the route depends on the dtype alone, and a
bf16 CUDA tensor reaches its warpgroup kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["supports", "flash_attention", "flash_attention_fwd_single",
           "flash_attention_bwd_single", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_single_ref",
           "flash_attention_single_bwd_ref", "flash_attention_ref",
           "flash_attention_bwd_ref"]

_SINGLE_BLOCK_MAX = 1024  # the reference's whole-row limit
_TILE = 64                # the kernels' key tile (csrc/attention_tiles.cuh)
_MAX_HEAD_DIM = 128
_MAX_HEAD_DIM_FP32_BWD = 64

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_STRIDES = (_L,) * 9
_GEOMETRY = (_I, _I, _I, _I, _I, _I, _F, _I, _P)
_SIGNATURES = {
    # tensors | strides | b, sq, sk, nh, d, causal, scale, bf16, stream
    "flash_fwd_single": (_P,) * 4 + _STRIDES + _GEOMETRY,   # q k v out
    # q k v dout stats dq dk dv
    "flash_bwd_single": (_P,) * 8 + _STRIDES + _GEOMETRY,
    "flash_fwd": (_P,) * 5 + _STRIDES + _GEOMETRY,          # q k v out lse
    # q k v out dout lse delta dq dk dv
    "flash_bwd": (_P,) * 10 + _STRIDES + _GEOMETRY,
    # d: the bf16 single-block / tiled forward's dynamic shared memory
    "flash_fwd_single_bf16_smem": (_I,),
    "flash_fwd_bf16_smem": (_I,),
    # d: a bf16 backward's dQ / dK/dV block's dynamic shared memory
    "flash_bwd_dq_bf16_smem": (_I,),
    "flash_bwd_dkdv_bf16_smem": (_I,),
}
_DTYPES = (torch.float32, torch.bfloat16)


def supports(q_shape, dtype, causal) -> bool:
    """Whether the flash kernels take this problem (the reference's gates;
    else callers use dense attention). ``causal`` is unused there too."""
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return False
    _, s, _, d = q_shape
    if d > 256:
        return False
    if s <= _SINGLE_BLOCK_MAX:
        return s % 16 == 0
    return _pick_block(s) is not None


def _pick_block(seq: int):
    # the reference's tiled-path blocks; here they only gate the path
    for blk in (1024, 512, 256, 128):
        if seq % blk == 0:
            return blk
    return None


def _scale(q, scale):
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """fp32 ``[b, h, sq, sk]`` scores times ``scale``, -inf above the
    diagonal when causal (rows and keys from 0, as `_causal_mask`)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_single_ref(q, k, v, causal=True, scale=None):
    """`_fwd_single_kernel`: an exact softmax of the whole row, P divided
    by the row sum in fp32 and then cast to v's dtype, fp32 P.V, the
    output in q's dtype."""
    s = _scores(q, k, causal, _scale(q, scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype).float(),
                     v.float())
    return o.to(q.dtype)


def flash_attention_single_bwd_ref(q, k, v, dout, causal=True, scale=None):
    """`_bwd_single_kernel`: the softmax recomputed from q and k, P cast
    to dout's dtype for dV, ``delta = sum(p * dP)`` (not rowsum(dO * O)),
    dS cast to q's dtype before its two products, fp32 sums, each gradient
    cast to its input's dtype."""
    sc = _scale(q, scale)
    s = _scores(q, k, causal, sc)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * sc).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, causal=True, scale=None, return_lse=False,
                        block_k=_TILE):
    """`_fwd_kernel`: an online softmax over key blocks of ``block_k``
    (the kernel's 64 by default; the cast points depend on it). Per block
    the running max m is updated, ``p = exp(s - m)`` is cast to v's dtype
    unnormalised for an fp32 P.V, the running sum and output are rescaled;
    at the end ``O / l`` in q's dtype and ``lse = m + log l`` ([b, h, sq]
    fp32). A row with no visible key so far keeps the empty state (the
    kernel's rule; it cannot happen for causal or plain attention)."""
    s = _scores(q, k, causal, _scale(q, scale))
    b, h, sq, sk = s.shape
    m = torch.full((b, h, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros(b, h, sq, 1, device=q.device)
    acc = torch.zeros(b, h, sq, q.shape[-1], device=q.device)
    for k0 in range(0, sk, block_k):
        sb = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(sb - m_use)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(),
            v[:, k0:k0 + block_k].float())
        m = m_new
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)) \
        .transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("inf")))
    return out, lse[..., 0]


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                            scale=None):
    """`_bwd_fused_kernel` from an outside ``lse`` and ``out``:
    ``p = exp(s - lse)`` (no renormalisation), ``delta = rowsum(dO * O)``
    in fp32, P cast to dout's dtype for dV, dS cast to q's dtype, fp32
    sums cast once at the end."""
    sc = _scale(q, scale)
    p = torch.exp(_scores(q, k, causal, sc) - lse.float()[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = (p * (dp - delta) * sc).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, causal, backward=False):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be [b, s, heads, d], got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if tuple(v.shape) != tuple(k.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (b, h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (flash "
                         f"attention takes one head count)")
    if causal and sq != k.shape[1]:
        raise ValueError("causal flash attention needs equal q/k seq lens")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for {dev}")
    if dev.type != "cuda":
        return
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16 on the card, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype} (float16: "
                        f"ROADMAP queue B)")
    limit = _MAX_HEAD_DIM_FP32_BWD if backward and q.dtype == torch.float32 \
        else _MAX_HEAD_DIM
    if d % 16 or d > limit:
        what = " in a float32 backward" if limit < _MAX_HEAD_DIM else ""
        raise ValueError(f"head_dim={d}: the kernels take a multiple of 16 "
                         f"up to {limit}{what} (ROADMAP queue B)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (t.stride(i) * t.element_size()) % 16 for i in range(3)):
            raise ValueError(f"{name} needs unit stride along head_dim and "
                             f"16-byte aligned rows")


def _args(q, k, v, causal, scale):
    """The strides and geometry every C entry takes after its tensors."""
    b, sq, h, d = q.shape
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return [*strides, b, sq, k.shape[1], h, d, int(causal), float(scale),
            int(q.dtype == torch.bfloat16), stream]


def _run(fn, *args):
    lib = _build.load("flash_attention", _SIGNATURES)
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def _check_operand(name, t, shape, q, dtype=None):
    """A backward operand the kernel reads at q's geometry (CUDA only)."""
    if tuple(t.shape) != tuple(shape) or t.device != q.device or (
            dtype is not None and t.dtype != dtype):
        want = str(tuple(shape)) + ("" if dtype is None else f" {dtype}")
        raise ValueError(f"{name} must be {want} on {q.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _grads_like(q, k, v):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=q.device),
            torch.empty(v.shape, dtype=v.dtype, device=q.device))


def flash_attention_fwd_single(q, k, v, causal=True, scale=None):
    """The single-block forward (see the module docstring): ``out [b, sq,
    h, d]``; CUDA tensors launch ``flash_single_fwd_kernel``."""
    _check(q, k, v, causal)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_single_ref(q, k, v, causal, sc)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _run("flash_fwd_single", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *_args(q, k, v, causal, sc))
    flash_attention_fwd_single.launches += 1
    return out


def flash_attention_bwd_single(q, k, v, dout, causal=True, scale=None):
    """The single-block backward from q, k, v and dout alone: ``(dq, dk,
    dv)``; CUDA tensors launch ``flash_single_dq_wgmma_kernel`` then
    ``flash_single_dkdv_wgmma_kernel`` (bf16, one count in
    ``.launches_wgmma``) or ``flash_single_dq_kernel`` then
    ``flash_single_dkdv_kernel`` (fp32, one count in ``.launches``)."""
    _check(q, k, v, causal, backward=True)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_single_bwd_ref(q, k, v, dout, causal, sc)
    _check_operand("dout", dout, q.shape, q)
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = _grads_like(q, k, v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    b, sq, h, _ = q.shape
    stats = torch.empty(3, b, h, sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _run("flash_bwd_single", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             dout.data_ptr(), stats.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), *_args(q, k, v, causal, sc))
    if q.dtype == torch.bfloat16:
        flash_attention_bwd_single.launches_wgmma += 1
    else:
        flash_attention_bwd_single.launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """The tiled forward: ``(out [b, sq, h, d], lse [b, h, sq] fp32)``;
    CUDA tensors launch ``flash_fwd_wgmma_kernel`` (bf16) or
    ``flash_fwd_kernel`` (fp32)."""
    _check(q, k, v, causal)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sc, return_lse=True)
    b, sq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        _run("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(), *_args(q, k, v, causal, sc))
    if q.dtype == torch.bfloat16:
        flash_attention_fwd.launches_wgmma += 1
    else:
        flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, scale=None):
    """The tiled backward from an outside ``out`` and ``lse`` (the
    forward's, or a ring's global ones): ``(dq, dk, dv)``; CUDA tensors
    launch ``flash_delta_kernel``, then ``flash_dq_wgmma_kernel`` and
    ``flash_dkdv_wgmma_kernel`` (bf16, one count in ``.launches_wgmma``)
    or ``flash_dkdv_kernel`` and ``flash_dq_kernel`` (fp32, one count in
    ``.launches``)."""
    _check(q, k, v, causal, backward=True)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal, sc)
    b, sq, h, _ = q.shape
    _check_operand("out", out, q.shape, q)
    _check_operand("lse", lse, (b, h, sq), q, torch.float32)
    _check_operand("dout", dout, q.shape, q)
    out = out.to(q.dtype).contiguous()
    lse = lse.contiguous()
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = _grads_like(q, k, v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _run("flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_args(q, k, v, causal, sc))
    if q.dtype == torch.bfloat16:
        flash_attention_bwd.launches_wgmma += 1
    else:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashSingle(torch.autograd.Function):
    """`_flash_single`: residuals q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention_fwd_single(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd_single(q, k, v, dout, ctx.causal,
                                            ctx.scale), None, None)


class _Flash(torch.autograd.Function):
    """`_flash`: residuals q, k, v, out, lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                     ctx.scale), None, None)


def flash_attention(q, k, v, causal=True, scale=None, block_q=None,
                    block_k=None):
    """q/k/v ``[b, s, heads, d]`` (the reference's layout and signature).
    Returns the attention output in the same layout; differentiable. The
    single-block path at ``s <= 1024`` (a multiple of 16) unless a block
    is given, else the tiled path, whose lengths must be a multiple of 128
    (see the module docstring)."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    _check(q, k, v, causal, backward=grad)
    sq, sk = q.shape[1], k.shape[1]
    sc = float(_scale(q, scale))
    single = (sq <= _SINGLE_BLOCK_MAX and sk <= _SINGLE_BLOCK_MAX
              and sq % 16 == 0 and sk % 16 == 0
              and block_q is None and block_k is None)
    if single:
        return _FlashSingle.apply(q, k, v, bool(causal), sc)
    if (block_q or _pick_block(sq)) is None or \
            (block_k or _pick_block(sk)) is None:
        raise ValueError(f"unsupported seq lens ({sq}, {sk}) for flash "
                         f"blocks")
    return _Flash.apply(q, k, v, bool(causal), sc)


flash_attention_fwd_single.launches = 0
flash_attention_bwd_single.launches = 0
flash_attention_bwd_single.launches_wgmma = 0
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_wgmma = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_wgmma = 0
