"""Ragged paged attention: CUDA kernels for the card, plain PyTorch for
the CPU.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py, with its
signatures and layouts (see that module's docstring):

* ``k_pages`` / ``v_pages``: ``[num_kv_heads, num_pages, page_size,
  head_dim]``, fp32 or bf16; page 0 is the trash page.
* ``page_tables``: ``[batch, pages_per_seq] int32``.
* `paged_attention`: ``q [batch, num_heads, head_dim]``, one token per
  slot, ``seq_lens [batch] int32`` valid keys per slot; an empty slot
  gives zeros, not NaN.
* `paged_attention_chunk`: ``q [batch, c, num_heads, head_dim]``, query
  t of slot i at absolute position ``start[i] + t`` attending keys at
  positions ``<= start[i] + t`` (causal only: rows past a prompt's end
  attend stale pool data and their outputs are the caller's to discard).

Routing is by the tensors' device, nothing else: CPU tensors take the
plain versions (`paged_attention_ref`, `paged_attention_chunk_ref`,
transcriptions of ``paged_attention_xla`` / ``paged_attention_chunk_xla``
and their ``_densify``); CUDA tensors launch ``paged_decode_kernel`` /
``paged_chunk_kernel`` of ``csrc/paged_attention.cu`` or raise. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_chunk",
           "paged_attention_ref", "paged_attention_chunk_ref"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, page_tables, seq_lens | start, then the geometry
    "paged_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I, _I, _P),
    "paged_chunk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _F, _I, _I, _P),
}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256     # the kernels' shared memory holds [64, d] K/V tiles


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _densify(pages, page_tables):
    """[b, kvh, pp*ps, d] dense view of each slot's pages."""
    kvh, _, page_size, d = pages.shape
    b, pp = page_tables.shape
    g = pages[:, page_tables.long()]                  # [kvh, b, pp, ps, d]
    return g.movedim(0, 1).reshape(b, kvh, pp * page_size, d)


def paged_attention_ref(q, k_pages, v_pages, page_tables, seq_lens,
                        scale=None):
    """Densify via gather, mask, one attention (paged_attention_xla)."""
    b, nh, d = q.shape
    kvh, _, page_size, _ = k_pages.shape
    grp = nh // kvh
    pp = page_tables.shape[1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    k = _densify(k_pages, page_tables)
    v = _densify(v_pages, page_tables)
    qg = q.reshape(b, kvh, grp, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k.float()) * sc
    valid = (torch.arange(pp * page_size, device=q.device)[None, :]
             < seq_lens[:, None])                          # [b, L]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    # all-masked rows (empty slots): zero output, not NaN
    p = torch.where(valid[:, None, None, :].any(-1, keepdim=True), p,
                    torch.zeros((), device=q.device))
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(b, nh, d).to(q.dtype)


def paged_attention_chunk_ref(q, k_pages, v_pages, page_tables, start,
                              scale=None):
    """c queries per slot over its paged context, causal within the
    chunk (paged_attention_chunk_xla)."""
    b, c, nh, d = q.shape
    kvh, _, page_size, _ = k_pages.shape
    grp = nh // kvh
    L = page_tables.shape[1] * page_size
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    ctx_k = _densify(k_pages, page_tables)
    ctx_v = _densify(v_pages, page_tables)
    qg = q.movedim(1, 2).reshape(b, kvh, grp, c, d)
    s = torch.einsum("bhgcd,bhld->bhgcl", qg.float(), ctx_k.float()) * sc
    jpos = torch.arange(L, dtype=torch.int32, device=q.device)
    ipos = start[:, None] + torch.arange(c, dtype=torch.int32,
                                         device=q.device)[None]
    mask = jpos[None, None, :] <= ipos[:, :, None]          # [b, c, L]
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgcl,bhld->bhgcd", p, ctx_v.float())
    o = o.reshape(b, nh, c, d).movedim(1, 2)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, q, k_pages, v_pages, page_tables, lens, k_scales,
           v_scales):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("quantized pools: not ported yet")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, name: lens}
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES:
        raise TypeError(f"q/pools must be float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k_pages and v_pages differ in dtype")
    if page_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"page_tables and {name} must be int32")
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    kvh, _, page_size, d = k_pages.shape
    b, nh = q.shape[0], q.shape[-2]
    if (v_pages.shape != k_pages.shape or q.shape[-1] != d
            or page_tables.dim() != 2 or page_tables.shape[0] != b
            or tuple(lens.shape) != (b,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, page_tables "
            f"{tuple(page_tables.shape)}, {name} {tuple(lens.shape)}")
    if nh % kvh:
        raise ValueError(f"num_heads={nh} is not a multiple of "
                         f"num_kv_heads={kvh}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim={d} beyond the kernels' "
                         f"{_MAX_HEAD_DIM}")


def _launch(fn, q, k_pages, v_pages, page_tables, lens, extra, scale):
    kvh, num_pages, page_size, d = k_pages.shape
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out, False
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), page_tables.data_ptr(), lens.data_ptr(),
            *extra, q.shape[-2], kvh, d, num_pages, page_size,
            page_tables.shape[1], float(scale),
            int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
    return out, True


def paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                    scale=None, k_scales=None, v_scales=None):
    """Ragged paged decode attention (see the module docstring)."""
    _check("seq_lens", q, k_pages, v_pages, page_tables, seq_lens,
           k_scales, v_scales)
    if q.dim() != 3:
        raise ValueError(f"q must be [b, nh, d], got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_tables,
                                   seq_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    out, launched = _launch("paged_decode", q, k_pages, v_pages,
                            page_tables, seq_lens, (q.shape[0],), scale)
    paged_attention.launches += launched
    return out


def paged_attention_chunk(q, k_pages, v_pages, page_tables, start,
                          scale=None, k_scales=None, v_scales=None):
    """Multi-token chunk attention over the paged context (see the
    module docstring); ``page_tables`` holds the b slots' gathered
    rows."""
    _check("start", q, k_pages, v_pages, page_tables, start, k_scales,
           v_scales)
    if q.dim() != 4:
        raise ValueError(f"q must be [b, c, nh, d], got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_chunk_ref(q, k_pages, v_pages, page_tables,
                                         start, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_chunk: no kernel for {q.device}")
    out, launched = _launch("paged_chunk", q, k_pages, v_pages, page_tables,
                            start, (q.shape[0], q.shape[1]), scale)
    paged_attention_chunk.launches += launched
    return out


paged_attention.launches = 0
paged_attention_chunk.launches = 0
