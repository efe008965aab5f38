"""Weight-only int8 / int4 linear: a CUDA kernel for the card, plain
PyTorch for the CPU.

Counterpart of the reference's ``weight_only_linear``
(paddle_tpu/nn/quant/__init__.py:154), XLA code and not a Pallas kernel:
XLA fuses the dequantizing scale into the product's operand read, so the
int8 weight is all that crosses device memory. In PyTorch a dequantize
followed by ``F.linear`` writes and reads back a full-width weight on
every call; ``csrc/weight_only.cu`` reads the int8 weight once.

`weight_only_linear(x, weight, bias, weight_scale, weight_dtype, arch,
group_size)`: x ``[..., in]`` in fp32, bf16 or fp16; ``weight`` int8
``[out, in]`` (int4 is values in [-8, 7] in int8 bytes, as the reference
stores it); ``weight_scale`` fp32 ``[out]`` (per channel) or ``[in / g,
out]`` (grouped, g columns a group) or None; ``bias`` ``[out]`` or None.
Returns ``[..., out]`` in x's dtype: the weight ``q.to(x.dtype) *
s.to(x.dtype)`` rounded to x's dtype, the products summed in fp32, the sum
cast to x's dtype and the bias added in that dtype. ``weight_dtype``,
``arch`` and ``group_size`` are accepted and unused, as in the
reference (the scale's shape decides the grouping).

Routing is by x's device, nothing else: CPU tensors take the plain
version `weight_only_linear_ref`; CUDA tensors launch a kernel or raise.
On the card the wrapper picks one of four routes before the launch
(`route`, a pure function of x's dtype, the rows M, K, the group size
and the alignment; each counted on its own attribute of
``weight_only_linear``):

* ``mma`` (bf16 / fp16 x, M <= 16, K and the group multiples of 16, x
  and the weight 16-byte aligned): ``wo_mma_kernel``, the decode step on
  tensor cores (``mma.sync``), the weight dequantized in registers, K
  split by `mma_plan`; ``.launches_mma``.
* ``wgmma`` (the same rules, M > 16): ``wo_wgmma_kernel``, the prompt
  pass on warpgroup products fed by a TMA ring, 128 weight rows by 64,
  128 or 256 tokens, K split by `wgmma_plan` when the tiles do not fill
  the card; ``.launches_wgmma``.
* ``gemv`` / ``tiled``: the first design, for fp32 x (true fp32: TF32
  is off) and the shapes the two above refuse: ``wo_gemv_kernel`` (M <=
  16, CUDA cores, K split by `gemv_plan`; ``.launches_gemv``) and
  ``wo_tiled_kernel`` (64 x 64 tiles on ``tile_mma.cuh``;
  ``.launches_tiled``).

A failed launch raises; no route gives way to another. Launches on the
current stream, so CUDA graphs capture them (`jit.graphs` counts a
graph's replays).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["GEMV_MAX_ROWS", "ROUTES", "gemv_plan", "mma_plan", "route",
           "weight_only_linear", "weight_only_linear_ref", "wgmma_plan"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "wo_max_split": (), "wo_chunk": (), "wo_max_gemv_rows": (),
    # x, w, scale, bias, y, part, M, N, K, gs, ksplit, dtype, vec, stream
    "wo_gemv": (_P,) * 6 + (_I,) * 7 + (_P,),
    # x, w, scale, bias, y, M, N, K, gs, dtype, vec, stream
    "wo_tiled": (_P,) * 5 + (_I,) * 6 + (_P,),
    "wo_mma_rows": (), "wo_mma_step": (), "wo_mma_max_split": (),
    "wo_wgmma_rows": (), "wo_mma_smem": (_I, _I), "wo_wgmma_smem": (_I,),
    # x, w, scale, bias, y, part, M, N, K, gs, ksplit, dtype, stream
    "wo_mma": (_P,) * 6 + (_I,) * 6 + (_P,),
    # x, w, scale, bias, y, part, M, N, K, gs, bn, kper, dtype, stream
    "wo_wgmma": (_P,) * 6 + (_I,) * 7 + (_P,),
}
GEMV_MAX_ROWS = 16         # csrc/weight_only.cu kMaxM
ROWS_PER_BLOCK = 32        # kRowsPerBlock
CHUNK = 512                # kChunk: columns of one warp pass
MAX_SPLIT = 1024           # kMaxSplit: columns of K a block at most
MMA_ROWS = 64              # kMmaRows: weight rows a decode block (4 warps)
MMA_STEP = 256             # kMmaStep: columns of one pass; a split's unit
MMA_MAX_SPLIT = 2048       # kMmaMaxSplit
WGMMA_ROWS = 128           # wg::kBM: weight rows a prompt block
WGMMA_BK = 64              # wg::kBK: columns of K a stage
ROUTES = ("mma", "wgmma", "gemv", "tiled")
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x, weight, bias, weight_scale):
    if x.dtype not in _CODES:
        raise TypeError(f"weight_only_linear: x must be fp32, bf16 or fp16, "
                        f"got {x.dtype}")
    if weight.dtype != torch.int8 or weight.dim() != 2:
        raise TypeError(f"weight_only_linear: weight must be int8 [out, in], "
                        f"got {weight.dtype} {tuple(weight.shape)}")
    n, k = weight.shape
    if x.shape[-1] != k:
        raise ValueError(f"weight_only_linear: x's last dim {x.shape[-1]} "
                         f"!= the weight's in dim {k}")
    if weight_scale is not None:
        if weight_scale.dim() == 1:
            if weight_scale.shape[0] != n:
                raise ValueError(f"weight_scale [{weight_scale.shape[0]}] "
                                 f"!= the weight's out dim {n}")
        elif (weight_scale.dim() != 2 or weight_scale.shape[1] != n
              or k % weight_scale.shape[0]):
            raise ValueError(
                f"a grouped weight_scale is [in / g, out] = [{k} / g, {n}], "
                f"got {tuple(weight_scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("weight_scale", weight_scale),
                    ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"weight_only_linear: {name} on {t.device}, "
                             f"x on {x.device}")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _dequantize(weight, weight_scale, dtype):
    """The ``[out, in]`` weight in ``dtype``: ``q.to(dtype) *
    s.to(dtype)``, the product rounded to ``dtype`` (the reference's
    ``weight_only_linear`` dequantize)."""
    w = weight.to(dtype)
    if weight_scale is None:
        return w
    s = weight_scale.to(dtype)
    if s.dim() == 1:
        return w * s[:, None]
    o, k = w.shape
    g = s.shape[0]
    return (w.reshape(o, g, k // g) * s.t()[:, :, None]).reshape(o, k)


def weight_only_linear_ref(x, weight, bias=None, weight_scale=None,
                           weight_dtype="int8", arch=None, group_size=-1):
    """The plain version of `weight_only_linear`: the dequantized weight
    in x's dtype, the product in fp32 (the 16-bit products are exact in
    fp32, and fp32 is summed in fp32 with TF32 off), cast to x's dtype,
    then the bias in that dtype."""
    del weight_dtype, arch, group_size
    _check(x, weight, bias, weight_scale)
    w = _dequantize(weight, weight_scale, x.dtype)
    y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_sms = {}


def _lib():
    lib = _build.load("weight_only", _SIGNATURES)
    got = (lib.wo_max_gemv_rows(), lib.wo_chunk(), lib.wo_max_split(),
           lib.wo_mma_rows(), lib.wo_mma_step(), lib.wo_mma_max_split(),
           lib.wo_wgmma_rows())
    if got != (GEMV_MAX_ROWS, CHUNK, MAX_SPLIT, MMA_ROWS, MMA_STEP,
               MMA_MAX_SPLIT, WGMMA_ROWS):
        raise RuntimeError(f"csrc/weight_only.cu's sizes {got} differ from "
                           f"the wrapper's")
    return lib


def gemv_plan(n, k, sms):
    """(ksplit, splits) of a decode-route launch over an ``[n, k]``
    weight on a card of ``sms`` SMs: the fewest splits (each a multiple
    of `CHUNK` columns, at most `MAX_SPLIT`) that give at least two
    blocks an SM."""
    blocks = -(-n // ROWS_PER_BLOCK)
    want = max(1, -(-2 * sms // blocks))
    ksplit = -(-math.ceil(k / want) // CHUNK) * CHUNK
    ksplit = min(MAX_SPLIT, max(CHUNK, ksplit))
    return ksplit, -(-k // ksplit)


def _aligned(*ts):
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _partials(splits, m, n, dev):
    """The fp32 ``[splits, M, N]`` partials of a launch whose K is split,
    else None."""
    return (torch.empty(splits * m * n, dtype=torch.float32, device=dev)
            if splits > 1 else None)


def route(dtype, m, k, group, aligned):
    """The route of a launch over x ``[m, k]`` of ``dtype``, a weight
    grouped by ``group`` columns (0 per channel) and ``aligned`` (x and
    the weight on 16-byte boundaries): one of `ROUTES`."""
    hopper = (dtype in (torch.bfloat16, torch.float16) and k % 16 == 0
              and group % 16 == 0 and aligned)
    if m <= GEMV_MAX_ROWS:
        return "mma" if hopper else "gemv"
    return "wgmma" if hopper else "tiled"


def mma_plan(n, k, sms):
    """(ksplit, splits) of a ``mma`` launch over an ``[n, k]`` weight on
    a card of ``sms`` SMs: a power of two of splits, the fewest that give
    at least two blocks of `MMA_ROWS` rows an SM (so that a K of a power
    of two splits evenly), each a multiple of `MMA_STEP` columns and at
    most `MMA_MAX_SPLIT`."""
    blocks = -(-n // MMA_ROWS)
    want = 1 << (max(1, -(-2 * sms // blocks)) - 1).bit_length()
    ksplit = -(-math.ceil(k / want) // MMA_STEP) * MMA_STEP
    ksplit = min(MMA_MAX_SPLIT, max(MMA_STEP, ksplit))
    return ksplit, -(-k // ksplit)


def wgmma_plan(m, n, k, sms):
    """(bn, kper, splits) of a ``wgmma`` launch: token tiles of ``bn``
    (64 up to 64 rows, 128 up to 128, else 256), and K cut into
    ``splits`` pieces of ``kper`` steps of `WGMMA_BK` columns when the
    tiles alone leave SMs idle (each piece at least 4 steps)."""
    bn = 64 if m <= 64 else 128 if m <= 128 else 256
    tiles = -(-n // WGMMA_ROWS) * -(-m // bn)
    steps = -(-k // WGMMA_BK)
    want = max(1, min(sms // tiles, steps // 4))
    kper = -(-steps // want)
    return bn, kper, -(-steps // kper)


def _sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def _launch(x2, weight, bias, weight_scale):
    """One launch over x2 ``[M, K]`` (contiguous); returns y ``[M, N]``
    and the route."""
    m, k = x2.shape
    n = weight.shape[0]
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return y, None
    lib = _lib()
    w = weight.contiguous()
    s = None if weight_scale is None else weight_scale.float().contiguous()
    b = None if bias is None else bias.to(x2.dtype).contiguous()
    gs = 0 if s is None or s.dim() == 1 else k // s.shape[0]
    which = route(x2.dtype, m, k, gs, _aligned(x2, w))
    ptr = [_ptr(t) for t in (x2, w, s, b, y)]
    dev = x2.device
    code = _CODES[x2.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "mma":
            ksplit, splits = mma_plan(n, k, _sm_count(dev))
            part = _partials(splits, m, n, dev)
            rc = lib.wo_mma(*ptr, _ptr(part), m, n, k, gs, ksplit, code,
                            stream)
        elif which == "wgmma":
            bn, kper, splits = wgmma_plan(m, n, k, _sm_count(dev))
            part = _partials(splits, m, n, dev)
            rc = lib.wo_wgmma(*ptr, _ptr(part), m, n, k, gs, bn, kper, code,
                              stream)
        elif which == "gemv":
            vec = int(k % 16 == 0 and gs % 16 == 0 and _aligned(w))
            ksplit, splits = gemv_plan(n, k, _sm_count(dev))
            part = _partials(splits, m, n, dev)
            rc = lib.wo_gemv(*ptr, _ptr(part), m, n, k, gs, ksplit, code,
                             vec, stream)
        else:
            # 16-bit x comes here only with a shape `route` refuses: vec 0
            vec = int(k % 16 == 0 and gs % 16 == 0 and _aligned(w, x2))
            rc = lib.wo_tiled(*ptr, m, n, k, gs, code, vec, stream)
    if rc:
        raise RuntimeError(f"weight_only_linear's {which} route: launch "
                           f"failed, CUDA error {rc}")
    return y, which


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``x @ dequant(weight).T + bias`` (see the module docstring)."""
    if x.device.type == "cpu":
        return weight_only_linear_ref(x, weight, bias, weight_scale)
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_linear: no kernel for {x.device}")
    del weight_dtype, arch, group_size
    _check(x, weight, bias, weight_scale)
    lead = x.shape[:-1]
    y, route = _launch(x.reshape(-1, x.shape[-1]).contiguous(), weight, bias,
                       weight_scale)
    if route is not None:
        attr = f"launches_{route}"
        setattr(weight_only_linear, attr,
                getattr(weight_only_linear, attr) + 1)
    return y.reshape(*lead, weight.shape[0])


weight_only_linear.launches_mma = 0
weight_only_linear.launches_wgmma = 0
weight_only_linear.launches_gemv = 0
weight_only_linear.launches_tiled = 0
