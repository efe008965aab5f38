"""Ragged paged attention: CUDA kernels for the card, plain PyTorch for
the CPU.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py, with its
signatures and layouts (see that module's docstring):

* ``k_pages`` / ``v_pages``: ``[num_kv_heads, num_pages, page_size,
  head_dim]``, fp32 or bf16; page 0 is the trash page.
* quantized pools, selected by passing ``k_scales`` / ``v_scales``
  (``[num_kv_heads, num_pages, page_size]`` fp32, one scale a cached
  row): int8 pools ``[..., head_dim]`` (value ``q * scale``), or uint8
  pools ``[..., head_dim // 2]`` packing two int4 values a byte (high
  nibble the even lane, ``(v >> 4) - 8`` / ``(v & 0xF) - 8``, then
  times the scale). The pool dtype names the mode.
* ``page_tables``: ``[batch, pages_per_seq] int32``.
* `paged_attention`: ``q [batch, num_heads, head_dim]``, one token per
  slot, ``seq_lens [batch] int32`` valid keys per slot; an empty slot
  gives zeros, not NaN.
* `paged_attention_chunk`: ``q [batch, c, num_heads, head_dim]``, query
  t of slot i at absolute position ``start[i] + t`` attending keys at
  positions ``<= start[i] + t`` (causal only: rows past a prompt's end
  attend stale pool data and their outputs are the caller's to discard).

Routing is by the tensors' device first: CPU tensors take the plain
versions (`paged_attention_ref`, `paged_attention_chunk_ref`,
transcriptions of ``paged_attention_xla`` / ``paged_attention_chunk_xla``
and their ``_densify``, which dequantizes); CUDA tensors launch a
kernel of ``csrc/paged_attention.cu`` or raise. Decode takes
``paged_decode_split_kernel`` (split-K over the keys with bulk page
copies, ``csrc/paged_split.cuh``) where `decode_route` says so: an fp32
or bf16 ``q`` over fp32, bf16, int8 or int4 pools, ``head_dim`` a
multiple of 8 up to 256, a page's bytes whole 16-byte words (quantized
pools: ``page_size`` a multiple of 4), the pools and scales 16-byte
aligned, and a ring of two pages that fits a block's shared memory.
`split_plan` sizes its grid from the page table's width alone; the
last split of a slot's head merges the splits in the same launch,
through int counters that the wrapper keeps per (device, stream) and
that a CUDA-graph capture gets afresh. Every
other decode call takes ``paged_decode_kernel`` over fp pools and
``paged_decode_q_kernel`` over int8 or int4 pools. The chunk takes
``paged_chunk_wgmma_kernel`` (warpgroup products,
``csrc/paged_wgmma.cuh``) where `chunk_route` says so: a bf16 ``q`` over
bf16, int8 or int4 pools, ``head_dim`` a multiple of 8 up to 128, ``q``
16-byte and the pools 4-byte aligned. Every other chunk call (fp32
``q`` or pools, ``head_dim`` past 128 or not a multiple of 8, a
misaligned ``q`` or pool) takes ``paged_chunk_kernel`` over fp pools or
``paged_chunk_q_kernel`` over int8 or int4 pools. Each wrapper counts
its launches by route: ``<wrapper>.launches`` the fp kernel's,
``<wrapper>.launches_int8`` / ``.launches_int4`` the quantized ones',
the decode's split route ``.launches_split`` (fp pools),
``.launches_split_int8`` / ``.launches_split_int4``, and the chunk's
warpgroup route ``.launches_wgmma`` (bf16 pools),
``.launches_wgmma_int8`` / ``.launches_wgmma_int4``.
"""
from __future__ import annotations

import ctypes

import torch

from ...nn.quant import unpack_q4
from . import _build

__all__ = ["paged_attention", "paged_attention_chunk",
           "paged_attention_ref", "paged_attention_chunk_ref",
           "add_counts", "chunk_route", "counters", "decode_route",
           "split_plan"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, page_tables, seq_lens | start, then the geometry
    "paged_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I, _I, _P),
    "paged_chunk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _F, _I, _I, _P),
    # q, k, v, k_scales, v_scales, out, page_tables, seq_lens | start,
    # then the geometry (head_dim is q's), q_bf16, int4
    "paged_decode_q": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _F, _I, _I, _P),
    "paged_chunk_q": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, k_scales, v_scales, out, page_tables, start | b, c, nh,
    # kvh, d, num_pages, ps, pp, scale, mode (0 bf16, 1 int8, 2 int4)
    "paged_chunk_wgmma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _F, _I, _P),
    # d, mode: the warpgroup route's dynamic shared memory
    "paged_chunk_wgmma_smem": (_I, _I),
    # q, k, v, k_scales, v_scales, out, page_tables, seq_lens, part,
    # count | b, nh, kvh, d, num_pages, ps, pp, scale, q_bf16, pool kind,
    # pages_per_split, stages
    "paged_decode_split": (_P,) * 10 + (_I,) * 7 + (_F,) + (_I,) * 4
                          + (_P,),
    # pool kind, d, ps, nh / kvh, stages: the split route's shared memory
    "paged_decode_split_smem": (_I,) * 5,
}
_WGMMA_MODES = {None: 0, "int8": 1, "int4": 2}
# The split-K decode (csrc/paged_split.cuh): its pool kinds, the keys a
# split covers (about), the most ring stages, a block's shared memory
_SPLIT_KINDS = {torch.float32: 0, torch.bfloat16: 1, "int8": 2, "int4": 3}
_SPLIT_KEYS = 128
_SPLIT_STAGES = 4
_SMEM_BYTES = 232448
_DTYPES = (torch.float32, torch.bfloat16)
_QUANT_DTYPES = (torch.int8, torch.uint8)
_MAX_HEAD_DIM = 256     # the kernels' shared memory holds [64, d] K/V tiles


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _quant_mode(pages, scales):
    """None / "int8" / "int4", read from the pool dtype when scales are
    given (uint8 is the packed-nibble form)."""
    if scales is None:
        return None
    return "int4" if pages.dtype == torch.uint8 else "int8"


def _densify(pages, page_tables, scales=None):
    """[b, kvh, pp*ps, d] dense view of each slot's pages; quantized
    pools dequantize here (int4 unpacks its nibbles first), to fp32."""
    kvh, _, page_size, d = pages.shape
    b, pp = page_tables.shape
    g = pages[:, page_tables.long()]                  # [kvh, b, pp, ps, d]
    g = g.movedim(0, 1).reshape(b, kvh, pp * page_size, d)
    if scales is not None:
        if _quant_mode(pages, scales) == "int4":
            g = unpack_q4(g)
        s = scales[:, page_tables.long()]              # [kvh, b, pp, ps]
        s = s.movedim(0, 1).reshape(b, kvh, pp * page_size)
        g = g.float() * s[..., None]
    return g


def paged_attention_ref(q, k_pages, v_pages, page_tables, seq_lens,
                        scale=None, k_scales=None, v_scales=None):
    """Densify via gather (and dequant), mask, one attention
    (paged_attention_xla)."""
    b, nh, d = q.shape
    kvh, _, page_size, _ = k_pages.shape
    grp = nh // kvh
    pp = page_tables.shape[1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    k = _densify(k_pages, page_tables, k_scales)
    v = _densify(v_pages, page_tables, v_scales)
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
                              scale=None, k_scales=None, v_scales=None):
    """c queries per slot over its paged context, causal within the
    chunk (paged_attention_chunk_xla)."""
    b, c, nh, d = q.shape
    kvh, _, page_size, _ = k_pages.shape
    grp = nh // kvh
    L = page_tables.shape[1] * page_size
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    ctx_k = _densify(k_pages, page_tables, k_scales)
    ctx_v = _densify(v_pages, page_tables, v_scales)
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
    """Validate the call; returns the quant mode (None, "int8",
    "int4")."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, name: lens}
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is not None:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    quant = _quant_mode(k_pages, k_scales)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if quant is None and k_pages.dtype not in _DTYPES:
        raise TypeError(f"q/pools must be float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype} (int8/uint8 pools "
                        f"need k_scales/v_scales)")
    if quant is not None and k_pages.dtype not in _QUANT_DTYPES:
        raise TypeError(f"quantized pools must be int8 or uint8 (int4), "
                        f"got {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k_pages and v_pages differ in dtype")
    if page_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"page_tables and {name} must be int32")
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    kvh, num_pages, page_size, pd = k_pages.shape
    b, nh, d = q.shape[0], q.shape[-2], q.shape[-1]
    if quant == "int4" and d % 2:
        raise ValueError(
            f"int4 paged attention needs an even head_dim (two values "
            f"per byte), got head_dim={d}")
    if (v_pages.shape != k_pages.shape
            or pd != (d // 2 if quant == "int4" else d)
            or page_tables.dim() != 2 or page_tables.shape[0] != b
            or tuple(lens.shape) != (b,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, page_tables "
            f"{tuple(page_tables.shape)}, {name} {tuple(lens.shape)}")
    if quant is not None:
        for n in ("k_scales", "v_scales"):
            t = tensors[n]
            if t.dtype != torch.float32:
                raise TypeError(f"{n} must be float32, got {t.dtype}")
            if tuple(t.shape) != (kvh, num_pages, page_size):
                raise ValueError(
                    f"{n} must be [kvh, num_pages, page_size] = "
                    f"{[kvh, num_pages, page_size]}, got {list(t.shape)}")
    if nh % kvh:
        raise ValueError(f"num_heads={nh} is not a multiple of "
                         f"num_kv_heads={kvh}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim={d} beyond the kernels' "
                         f"{_MAX_HEAD_DIM}")
    return quant


def _launch(fn, q, k_pages, v_pages, page_tables, lens, extra, scale,
            k_scales, v_scales, quant):
    """Launch ``fn`` (fp pools) or ``fn + "_q"`` (int8/int4 pools) on
    q's stream; returns (out, launched)."""
    kvh, num_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out, False
    lib = _build.load("paged_attention", _SIGNATURES)
    geometry = (q.shape[-2], kvh, q.shape[-1], num_pages, page_size,
                page_tables.shape[1], float(scale),
                int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant is None:
            fn_name = fn
            rc = getattr(lib, fn)(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                out.data_ptr(), page_tables.data_ptr(), lens.data_ptr(),
                *extra, *geometry, int(k_pages.dtype == torch.bfloat16),
                stream)
        else:
            fn_name = fn + "_q"
            rc = getattr(lib, fn_name)(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), out.data_ptr(),
                page_tables.data_ptr(), lens.data_ptr(), *extra,
                *geometry, int(quant == "int4"), stream)
    if rc:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
    return out, True


def chunk_route(q, k_pages, v_pages, quant):
    """``"wgmma"`` where `paged_attention_chunk` launches its warpgroup
    kernel (``paged_chunk_wgmma_kernel``), else ``"pages"`` (the
    ``paged_chunk`` / ``paged_chunk_q`` kernels): the gate named in the
    module docstring, read from dtypes, ``head_dim`` and the pools'
    addresses."""
    d = q.shape[-1]
    pools = quant is not None or k_pages.dtype == torch.bfloat16
    if (q.dtype == torch.bfloat16 and pools and d % 8 == 0 and d <= 128
            and q.data_ptr() % 16 == 0
            and (k_pages.data_ptr() | v_pages.data_ptr()) % 4 == 0):
        return "wgmma"
    return "pages"


def split_plan(pp, page_size):
    """``(pages_per_split, splits)``: the split-K decode's walk over a
    page table ``pp`` pages wide. From the table's width alone, never from
    ``seq_lens``: the grid needs no host sync."""
    per = max(1, _SPLIT_KEYS // page_size)
    return per, -(-pp // per)


def _split_rows(grp):
    """Query rows a split block takes (paged_split::rows_of)."""
    return 1 if grp <= 1 else 2 if grp <= 2 else 4 if grp <= 4 else 8


def _split_smem(kind, d, page_size, grp, stages):
    """A split block's dynamic shared memory (paged_split::smem_bytes):
    the ring of pages, the key groups' merge area, the barriers."""
    row = (4 * d, 2 * d, d, d // 2)[kind]
    stage = 2 * page_size * row + (8 * page_size if kind >= 2 else 0)
    lanes = 1 << max(0, (d // 8 - 1).bit_length())
    red = 128 // lanes * _split_rows(grp) * (d + 2) * 4
    return (stages * stage + red + 7) // 8 * 8 + 8 * stages + 16


def _split_stages(kind, d, page_size, grp, per):
    """Ring stages for the split route: up to 4 (and no more than a
    split's pages) within a block's shared memory; 0 when not even two
    (or the one page of a one-page split) fit."""
    want = min(_SPLIT_STAGES, per)
    for stages in range(want, min(2, want) - 1, -1):
        if _split_smem(kind, d, page_size, grp, stages) <= _SMEM_BYTES:
            return stages
    return 0


def _split_kind(k_pages, quant):
    return _SPLIT_KINDS[quant or k_pages.dtype]


def decode_route(q, k_pages, v_pages, quant, k_scales=None,
                 v_scales=None):
    """``"split"`` where `paged_attention` launches its split-K kernel
    (``paged_decode_split_kernel``), else ``"pages"`` (the
    ``paged_decode`` / ``paged_decode_q`` kernels): the gate named in the
    module docstring, read from dtypes, shapes and the pools' (and
    scales') addresses."""
    b, nh, d = q.shape
    kvh, _, page_size, pd = k_pages.shape
    kind = _split_kind(k_pages, quant)
    row = pd * k_pages.element_size()
    tensors = [k_pages, v_pages]
    if quant is not None:
        tensors += [k_scales, v_scales]
    grp = nh // kvh
    chunks = -(-grp // _split_rows(grp))
    per, _ = split_plan(1, page_size)        # from the page size alone
    if (d % 8 == 0 and d <= _MAX_HEAD_DIM and page_size * row % 16 == 0
            and (quant is None or page_size % 4 == 0)
            and all(t is not None and t.data_ptr() % 16 == 0
                    for t in tensors)
            and b <= 65535 and kvh * chunks <= 65535
            and _split_stages(kind, d, page_size, grp, per) > 0):
        return "split"
    return "pages"


# the split route's counters, one buffer per (device, stream): 0 between
# calls (the last split of each (slot, kv head, row chunk) resets its
# own), so the calls that share one run in stream order. A buffer only
# grows, on its own stream, and is never captured in a CUDA graph
_split_counters = {}
_MIN_COUNTERS = 1 << 16


def _counters(device, stream, n):
    """``n`` zeroed int32 counters for a split launch on ``stream``.
    Under CUDA-graph capture a fresh buffer: its zero fill is captured
    with the launch, so each replay starts from 0, and no eager call
    reads a buffer whose fill was only recorded."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    buf = _split_counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, _MIN_COUNTERS,
                              2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _split_counters[(device, stream)] = buf
    return buf


def _launch_split(q, k_pages, v_pages, page_tables, seq_lens, scale,
                  k_scales, v_scales, quant):
    """``paged_decode_split`` on q's stream; returns (out, launched)."""
    kvh, num_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    b, nh, d = q.shape
    if b == 0:
        return out, False
    lib = _build.load("paged_attention", _SIGNATURES)
    pp = page_tables.shape[1]
    per, splits = split_plan(pp, page_size)
    kind = _split_kind(k_pages, quant)
    grp = nh // kvh
    rows = _split_rows(grp)
    units = b * kvh * -(-grp // rows)
    stages = _split_stages(kind, d, page_size, grp, per)
    part = torch.empty(units * splits * rows * (d + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        count = _counters(q.device, stream, units)
        rc = lib.paged_decode_split(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            out.data_ptr(), page_tables.data_ptr(), seq_lens.data_ptr(),
            part.data_ptr(), count.data_ptr(), b, nh, kvh, d, num_pages,
            page_size, pp, float(scale), int(q.dtype == torch.bfloat16),
            kind, per, stages, stream)
    if rc:
        raise RuntimeError(f"paged_decode_split launch failed: CUDA error "
                           f"{rc}")
    return out, True


def _count(wrapper, quant, launched, route="pages"):
    attr = "launches" if route == "pages" else f"launches_{route}"
    if quant is not None:
        attr += f"_{quant}"
    setattr(wrapper, attr, getattr(wrapper, attr) + launched)


def _launch_wgmma(q, k_pages, v_pages, page_tables, start, scale,
                  k_scales, v_scales, quant):
    """``paged_chunk_wgmma`` on q's stream; returns (out, launched)."""
    kvh, num_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out, False
    lib = _build.load("paged_attention", _SIGNATURES)
    b, c, nh, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_chunk_wgmma(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            out.data_ptr(), page_tables.data_ptr(), start.data_ptr(), b, c,
            nh, kvh, d, num_pages, page_size, page_tables.shape[1],
            float(scale), _WGMMA_MODES[quant], stream)
    if rc:
        raise RuntimeError(f"paged_chunk_wgmma launch failed: CUDA error "
                           f"{rc}")
    return out, True


def paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                    scale=None, k_scales=None, v_scales=None):
    """Ragged paged decode attention (see the module docstring)."""
    quant = _check("seq_lens", q, k_pages, v_pages, page_tables, seq_lens,
                   k_scales, v_scales)
    if q.dim() != 3:
        raise ValueError(f"q must be [b, nh, d], got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_tables,
                                   seq_lens, scale=scale,
                                   k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    route = decode_route(q, k_pages, v_pages, quant, k_scales, v_scales)
    if route == "split":
        out, launched = _launch_split(q, k_pages, v_pages, page_tables,
                                      seq_lens, scale, k_scales, v_scales,
                                      quant)
    else:
        out, launched = _launch("paged_decode", q, k_pages, v_pages,
                                page_tables, seq_lens, (q.shape[0],),
                                scale, k_scales, v_scales, quant)
    _count(paged_attention, quant, launched, route)
    return out


def paged_attention_chunk(q, k_pages, v_pages, page_tables, start,
                          scale=None, k_scales=None, v_scales=None):
    """Multi-token chunk attention over the paged context (see the
    module docstring); ``page_tables`` holds the b slots' gathered
    rows."""
    quant = _check("start", q, k_pages, v_pages, page_tables, start,
                   k_scales, v_scales)
    if q.dim() != 4:
        raise ValueError(f"q must be [b, c, nh, d], got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_chunk_ref(q, k_pages, v_pages, page_tables,
                                         start, scale=scale,
                                         k_scales=k_scales,
                                         v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_chunk: no kernel for {q.device}")
    route = chunk_route(q, k_pages, v_pages, quant)
    if route == "wgmma":
        out, launched = _launch_wgmma(q, k_pages, v_pages, page_tables,
                                      start, scale, k_scales, v_scales,
                                      quant)
    else:
        out, launched = _launch("paged_chunk", q, k_pages, v_pages,
                                page_tables, start, (q.shape[0], q.shape[1]),
                                scale, k_scales, v_scales, quant)
    _count(paged_attention_chunk, quant, launched, route)
    return out


# every launch counter: (wrapper, attribute)
_COUNTERS = tuple(
    (w, f"launches{route}{quant}")
    for w, routes in ((paged_attention, ("", "_split")),
                      (paged_attention_chunk, ("", "_wgmma")))
    for route in routes for quant in ("", "_int8", "_int4"))
for _w, _attr in _COUNTERS:
    setattr(_w, _attr, 0)
del _w, _attr


def counters():
    """A snapshot of every launch counter of this module, ``{(wrapper
    name, attribute): count}``. A CUDA-graph replay calls no Python, so
    a capture records the difference of two snapshots and its replays
    add it (`add_counts`): the counters then count kernels that ran."""
    return {(w.__name__, attr): getattr(w, attr) for w, attr in _COUNTERS}


def add_counts(delta):
    """Add ``delta`` (keys as `counters` gives them) to the counters."""
    for w, attr in _COUNTERS:
        n = delta.get((w.__name__, attr), 0)
        if n:
            setattr(w, attr, getattr(w, attr) + n)
