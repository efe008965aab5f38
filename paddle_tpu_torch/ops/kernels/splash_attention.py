"""Splash training attention: CUDA kernels for the card, plain PyTorch for
the CPU.

Counterpart of paddle_tpu/ops/pallas/splash_attention.py, with its
layouts: q ``[b, sq, nh, d]``, k/v ``[b, sk, kvh, d]`` (``nh`` a multiple
of ``kvh``: GQA), segment ids ``[b, sq]`` int (packed documents attend
only within themselves; keys read ``seg[:, :sk]``). A row whose segment
matches no visible key gets zero output and zero gradients.

* `splash_attention`: the differentiable entry (a
  ``torch.autograd.Function``; segment ids get no gradient).
* `splash_attention_fwd`: ``(out, lse)``, ``lse [b, nh, sq]`` fp32 with
  ``+inf`` on empty rows; kernel #9: ``splash_fwd_wgmma_kernel`` in bf16
  (warpgroup products, ``csrc/attention_wgmma.cuh``),
  ``splash_fwd_kernel`` in fp32.
* `splash_attention_bwd`: ``(dq, dk, dv)`` from the lse; kernel #10:
  in bf16 ``splash_delta_kernel`` then ``splash_dq_wgmma_kernel`` and
  ``splash_dkdv_wgmma_kernel`` (warpgroup products,
  ``csrc/attention_wgmma_bwd.cuh``), in fp32 the ``splash_delta`` /
  ``splash_dkdv`` / ``splash_dq`` kernels.

Routing is by the tensors' device, nothing else: CPU tensors take the
plain versions (`splash_attention_ref`, a transcription of
``splash_attention_xla``, and `splash_attention_bwd_ref`, which derives
the gradients from the lse as the backward kernels do); CUDA tensors
launch the kernels of ``csrc/splash_attention.cu`` or raise. The kernels
take q/k/v as strided views (unit stride along ``d``, 16-byte aligned
rows), so ``qkv.reshape(b, s, 3, nh, d)[:, :, i]`` needs no copy; they
take ``d`` a multiple of 16 up to 128 (fp32 backward: up to 64, by shared
memory). Each forward and backward wrapper counts its fp32 launches in
``<wrapper>.launches`` and its bf16 launches (warpgroup products) in
``<wrapper>.launches_wgmma``: the route depends on the dtype alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _pick_block

__all__ = ["supports", "splash_attention", "splash_attention_fwd",
           "splash_attention_bwd", "splash_attention_ref",
           "splash_attention_bwd_ref"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_STRIDES = (_L,) * 9
_GEOMETRY = (_I, _I, _I, _I, _I, _I, _I, _F, _I, _P)
_SIGNATURES = {
    # q, k, v, out, lse, seg | strides | b, sq, sk, nh, kvh, d, causal,
    # scale, bf16, stream
    "splash_fwd": (_P,) * 6 + _STRIDES + _GEOMETRY,
    # q, k, v, out, dout, lse, seg, delta, dq, dk, dv | strides | ...
    "splash_bwd": (_P,) * 11 + _STRIDES + _GEOMETRY,
    # d, seg: the bf16 forward's dynamic shared memory
    "splash_fwd_bf16_smem": (_I, _I),
    # d, seg, which (0 dQ, 1 dK/dV): the bf16 backward's
    "splash_bwd_bf16_smem": (_I, _I, _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def supports(q_shape, num_kv_heads, dtype, sk=None) -> bool:
    """Whether the reference's splash gate takes this problem (else
    callers use dense attention): lengths a multiple of 128, ``d`` up to
    256, ``nh`` a multiple of ``num_kv_heads``. The kernels refuse more on
    the card (see the module docstring)."""
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return False
    _, sq, h, d = q_shape
    if d > 256 or h % num_kv_heads:
        return False
    return _pick_block(sq) is not None and \
        _pick_block(sq if sk is None else sk) is not None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mask(b, sq, sk, causal, segment_ids, device):
    """[b, sq, sk] bool: key j visible to row i."""
    mask = torch.ones(b, sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool,
                                 device=device).tril(sk - sq)[None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        mask = mask & (seg[:, :, None] == seg[:, None, :sk])
    return mask


def _scale(q, scale):
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def splash_attention_ref(q, k, v, causal=True, segment_ids=None,
                         scale=None, return_lse=False):
    """One dense masked attention (splash_attention_xla): fp32 scores,
    P cast to v's dtype, fp32 P.V. Rows with no visible key get zero
    output and, under autograd, zero gradients (the whole-row zeroing
    keeps the all -inf softmax from giving NaN). With ``return_lse``
    also the row logsumexp ``[b, nh, sq]`` (``+inf`` on empty rows)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    sc = _scale(q, scale)
    qg = q.reshape(b, sq, kvh, grp, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * sc
    m5 = _mask(b, sq, sk, causal, segment_ids, q.device)[:, None, None]
    any_valid = m5.any(-1, keepdim=True)
    s = s.masked_fill(~m5, float("-inf"))
    s = torch.where(any_valid, s, torch.zeros((), device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(any_valid, p, torch.zeros((), device=q.device))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(any_valid[..., 0], lse,
                      torch.full((), float("inf"), device=q.device))
    return out, lse.reshape(b, h, sq)


def splash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                             segment_ids=None, scale=None):
    """dq, dk, dv from the forward's lse, the backward kernels'
    arithmetic: p = exp(s * scale - lse) (an exact 0 on masked keys and on
    empty rows, whose lse is +inf), delta = rowsum(dO * O) in fp32,
    dS = p * (dP - delta) * scale cast to q's dtype, fp32 products, each
    gradient cast to its input's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    sc = _scale(q, scale)
    qg = q.reshape(b, sq, kvh, grp, d).float()
    dog = dout.reshape(b, sq, kvh, grp, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    m5 = _mask(b, sq, sk, causal, segment_ids, q.device)[:, None, None]
    s = s.masked_fill(~m5, float("-inf"))
    lse5 = lse.reshape(b, kvh, grp, sq)[..., None]
    p = torch.exp(s * sc - lse5)
    delta = (dout.float() * out.float()).sum(-1)           # [b, sq, h]
    delta5 = delta.reshape(b, sq, kvh, grp).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(),
                      dog.float())
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), v.float())
    ds = (p * (dp - delta5) * sc).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, causal, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be [b, s, heads, d], got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and sq != sk:
        raise ValueError("causal splash attention needs equal seq lens")
    if h % kvh:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {kvh}")
    tensors = [q, k, v]
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, sq) or sk > sq:
            raise ValueError(f"segment_ids must be [b, sq] = {(b, sq)} "
                             f"with sk <= sq, got "
                             f"{tuple(segment_ids.shape)}, sk={sk}")
        tensors.append(segment_ids)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"splash_attention: no kernel for {dev}")
    if dev.type == "cuda":
        if q.dtype not in _DTYPES or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                            f"{q.dtype}/{k.dtype}/{v.dtype}")
        if d % 16 or d > 128:
            raise ValueError(f"head_dim={d}: the kernels take a multiple "
                             f"of 16 up to 128")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                    (t.stride(i) * t.element_size()) % 16
                    for i in range(3)):
                raise ValueError(f"{name} needs unit stride along head_dim "
                                 f"and 16-byte aligned rows")


def _views(q, k, v):
    return [t.stride(i) for t in (q, k, v) for i in range(3)]


def _seg(segment_ids):
    if segment_ids is None:
        return None
    return segment_ids.to(torch.int32).contiguous()


def _geometry(q, k, causal, scale):
    b, sq, h, d = q.shape
    return [b, sq, k.shape[1], h, k.shape[2], d, int(causal), float(scale),
            int(q.dtype == torch.bfloat16)]


def _run(fn, *args):
    lib = _build.load("splash_attention", _SIGNATURES)
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def splash_attention_fwd(q, k, v, causal=True, segment_ids=None,
                         scale=None):
    """``(out [b, sq, nh, d], lse [b, nh, sq] fp32)`` (see the module
    docstring); CUDA tensors launch ``splash_fwd_wgmma_kernel`` (bf16) or
    ``splash_fwd_kernel`` (fp32)."""
    _check(q, k, v, causal, segment_ids)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return splash_attention_ref(q, k, v, causal, segment_ids, sc,
                                    return_lse=True)
    b, sq, h, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    seg = _seg(segment_ids)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _run("splash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(),
             None if seg is None else seg.data_ptr(), *_views(q, k, v),
             *_geometry(q, k, causal, sc), stream)
    if q.dtype == torch.bfloat16:
        splash_attention_fwd.launches_wgmma += 1
    else:
        splash_attention_fwd.launches += 1
    return out, lse


def splash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                         segment_ids=None, scale=None):
    """``(dq, dk, dv)`` in q/k/v's dtypes from the forward's ``out`` and
    ``lse``; CUDA tensors launch the three backward kernels (one count:
    ``launches_wgmma`` in bf16, ``launches`` in fp32)."""
    _check(q, k, v, causal, segment_ids)
    sc = _scale(q, scale)
    if q.device.type == "cpu":
        return splash_attention_bwd_ref(q, k, v, out, lse, dout, causal,
                                        segment_ids, sc)
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    b, sq, h, _ = q.shape
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    seg = _seg(segment_ids)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _run("splash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.contiguous().data_ptr(), dout.data_ptr(),
             lse.contiguous().data_ptr(),
             None if seg is None else seg.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_views(q, k, v),
             *_geometry(q, k, causal, sc), stream)
    if q.dtype == torch.bfloat16:
        splash_attention_bwd.launches_wgmma += 1
    else:
        splash_attention_bwd.launches += 1
    return dq, dk, dv


class _Splash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        out, lse = splash_attention_fwd(q, k, v, causal, segment_ids, scale)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = splash_attention_bwd(q, k, v, out, lse, dout,
                                          ctx.causal, segment_ids, ctx.scale)
        return dq, dk, dv, None, None, None


def splash_attention(q, k, v, causal=True, segment_ids=None, scale=None):
    """Splash training attention, differentiable in q/k/v (see the module
    docstring for layouts and routing)."""
    _check(q, k, v, causal, segment_ids)
    return _Splash.apply(q, k, v, segment_ids, bool(causal),
                         float(_scale(q, scale)))


splash_attention_fwd.launches = 0
splash_attention_fwd.launches_wgmma = 0
splash_attention_bwd.launches = 0
splash_attention_bwd.launches_wgmma = 0
