"""Multi-tensor optimizer kernels: the global grad norm with the
non-finite check, and the whole Adam/AdamW update; CUDA kernels for the
card, plain PyTorch for the CPU.

Counterpart of the reference's fused optimizer step, XLA code and not a
Pallas kernel: ``Adam._maybe_fused_step`` (paddle_tpu/optimizer/
__init__.py:161) jits ``_build_fused_fn`` (:203) over ``_adam_math`` (:79)
for every parameter at once, and ``ClipGradByGlobalNorm`` (paddle_tpu/nn/
clip.py:50) with the guard's finiteness check and unscale (jit/
train_step.py:355-369) feed it.

* `multi_tensor_norm(grads, need_clip, inv_scale, clip_norm, write)`:
  ``(stats, found)``: ``stats`` fp32 ``[2]`` holds the sum of squares of
  the ``need_clip`` grads after the unscale and the clip scale
  ``min(clip_norm / max(sqrt(sum), 1e-12), 1)`` (1 without ``clip_norm``);
  ``found`` a 0-dim bool, some element of some grad is not finite, judged
  on the grads as given (still loss-scaled). With an ``inv_scale`` (a
  device fp32 scalar) each grad is unscaled first with the reference's
  rounding, ``(g.float() * inv).to(g.dtype)``, and written back in place
  when ``write``. One launch for up to `MAX_TENSORS` grads of any float
  dtypes (``mt_norm_kernel``).
* `multi_tensor_adam(...)`: ``_adam_math`` over every tensor in place:
  the master (fp32, where a bf16/fp16 parameter has one), the parameter
  and the moments (and ``vmax`` under amsgrad) in their own dtypes; the
  grads unscaled by ``inv_scale`` and scaled by ``clip_scale`` (on the
  ``need_clip`` tensors), each rounded to the grad's dtype as
  ``nn/clip.py`` ``scaled`` does; a per-tensor lr scale, decoupled decay
  and L2 coefficient; the bias corrections in fp32 from ``step`` (a
  device int32 counter, read as ``step + 1``, and raised by one with
  ``bump``: `jit.FusedScanTrainStep` updates one step's tensors in
  several calls and raises it in the last). With ``found_inf`` (a device
  bool) set nothing is written, the counter included. One launch per (parameter, moment) dtype group of up to
  `MAX_TENSORS` tensors (``mt_adam_kernel<P, M>``).

Routing is by the tensors' device, nothing else: CPU tensors take the
plain versions `multi_tensor_norm_ref` / `multi_tensor_adam_ref` (the
same arithmetic one tensor at a time, each step an fp32 operation; the
gate a ``torch.where`` over the old values, so nothing reads a flag
back); CUDA tensors launch the kernels of ``csrc/multi_tensor.cu`` or
raise. `adam_math` is the per-tensor rule both plain versions and the
per-parameter ``Adam`` path share, so the fused and the per-parameter
paths agree bit for bit on the CPU. The wrappers keep a device table of
each tensor list's static pointers (built once per list, rebuilt when a
pointer moves); the grads' pointers ride in the launch. Each wrapper
counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

__all__ = ["MAX_TENSORS", "AdamConsts", "adam_consts", "adam_math",
           "multi_tensor_norm", "multi_tensor_norm_ref",
           "multi_tensor_adam", "multi_tensor_adam_ref", "tensor_lr"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mt_max_tensors": (), "mt_chunk": (), "mt_norm_chunk": (),
    "mt_norm_blocks_per_sm": (), "mt_adam_blocks_per_sm": (_I, _I),
    # table, grads, n, chunks, grid, inv_scale, write, part, part_offset,
    # total_parts, final_launch, counter, stats, found, has_clip,
    # clip_norm, stream
    "mt_norm": (_P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _I,
                _F, _P),
    # pdtype, mdtype, table, grads, n, chunks, grid, lr, b1, b2, omb1,
    # omb2, eps, step, found, inv_scale, clip_scale, bump, counter, stream
    "mt_adam": (_I, _I, _P, _P, _I, _I, _I) + (_F,) * 6 + (_P,) * 4 +
               (_I, _P, _P),
}
MAX_TENSORS = 448          # csrc/multi_tensor.cu kMaxTensors
CHUNK = 2048               # elements an update chunk (kChunk)
NORM_CHUNK = 8192          # elements a norm chunk (kNormChunk)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEED_CLIP = 1
_NORM_ENTRY = np.dtype([("numel", "<i8"), ("chunk0", "<i4"),
                        ("dtype", "<i4"), ("flags", "<i4"), ("pad", "<i4")])
_ADAM_ENTRY = np.dtype([("p", "<u8"), ("master", "<u8"), ("m", "<u8"),
                        ("v", "<u8"), ("vmax", "<u8"), ("numel", "<i8"),
                        ("chunk0", "<i4"), ("flags", "<i4"),
                        ("lr_scale", "<f4"), ("wd", "<f4"), ("l2", "<f4"),
                        ("pad", "<f4")])
assert _NORM_ENTRY.itemsize == 24 and _ADAM_ENTRY.itemsize == 72


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scalar(x, device, dtype=torch.float32):
    # a fill, not a host-to-device copy: capturable in a CUDA graph
    return torch.full((), x, dtype=dtype, device=device)


def _round_to(x32, dtype):
    """fp32 ``x32`` rounded to ``dtype`` and back (identity for fp32)."""
    return x32 if dtype == torch.float32 else x32.to(dtype).float()


def multi_tensor_norm_ref(grads, need_clip=None, inv_scale=None,
                          clip_norm=None, write=False, device=None):
    """The plain version of `multi_tensor_norm` (see the module
    docstring); ``device`` places the result when ``grads`` is empty."""
    grads = list(grads)
    need_clip = [True] * len(grads) if need_clip is None else list(need_clip)
    dev = grads[0].device if grads else torch.device(device or "cpu")
    if not grads:
        return (torch.tensor([0.0, 1.0], device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    found = ~torch.stack([torch.isfinite(g).all() for g in grads]).all()
    xs = []
    for g in grads:
        x = g.float()
        if inv_scale is not None:
            x = _round_to(x * inv_scale, g.dtype)
            if write:
                g.copy_(x)
        xs.append(x)
    squares = [x.square().sum() for x, c in zip(xs, need_clip) if c]
    total = torch.stack(squares).sum() if squares else \
        torch.zeros((), device=dev)
    scale = torch.ones((), device=dev)
    if clip_norm is not None:
        norm = total.sqrt().clamp(min=1e-12)
        scale = (_scalar(clip_norm, dev) / norm).clamp(max=1.0)
    return torch.stack([total, scale]), found


@dataclass
class AdamConsts:
    """The step's fp32 scalars of `adam_math`, device tensors."""
    b1: torch.Tensor
    b2: torch.Tensor
    omb1: torch.Tensor
    omb2: torch.Tensor
    eps: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor


def adam_consts(beta1, beta2, eps, t):
    """`AdamConsts` at step ``t`` (an fp32 device scalar, the raised
    count): the bias corrections ``1 - beta ** t`` in fp32, as the
    reference's ``jnp.asarray(t, float32)`` gives them."""
    dev = t.device
    b1, b2 = _scalar(beta1, dev), _scalar(beta2, dev)
    return AdamConsts(b1=b1, b2=b2, omb1=_scalar(1.0 - beta1, dev),
                      omb2=_scalar(1.0 - beta2, dev), eps=_scalar(eps, dev),
                      bc1=1 - torch.pow(b1, t), bc2=1 - torch.pow(b2, t))


def adam_math(pv, g, m, v, vmax, lr_t, decay, l2, k):
    """The reference's ``_adam_math`` on fp32 tensors, one fp32 operation
    at a time: ``(out, m, v, vmax)`` (``vmax`` None unless amsgrad).
    ``lr_t`` is the tensor's lr (base lr times its scale), ``decay`` its
    ``1 - lr_t * wd`` (fp32 scalars), ``l2`` its L2 coefficient (a
    float; 0 adds nothing)."""
    if l2:
        g = g + _scalar(l2, g.device) * pv
    m = k.b1 * m + k.omb1 * g
    v = k.b2 * v + k.omb2 * g * g
    m_hat = m / k.bc1
    if vmax is not None:
        vmax = torch.maximum(vmax, v)
        v_hat = vmax / k.bc2
    else:
        v_hat = v / k.bc2
    update = m_hat / (torch.sqrt(v_hat) + k.eps)
    return pv * decay - lr_t * update, m, v, vmax


def tensor_lr(lr, lr_scale, wd, device):
    """``(lr_t, decay)`` of a tensor: ``lr * lr_scale`` and ``1 - lr_t *
    wd``, in fp32 as the reference's fused function computes them."""
    lr_t = _scalar(lr, device) * _scalar(lr_scale, device)
    return lr_t, 1 - lr_t * _scalar(wd, device)


def _gate(found, old, new):
    return new if found is None else torch.where(found, old, new)


def multi_tensor_adam_ref(params, grads, masters, exp_avgs, exp_avg_sqs,
                          max_exp_avg_sqs=None, *, lr, beta1, beta2, eps,
                          step, lr_scales=None, wds=None, l2s=None,
                          need_clip=None, found_inf=None, inv_scale=None,
                          clip_scale=None, bump=True):
    """The plain version of `multi_tensor_adam` (see the module
    docstring); updates in place, returns None."""
    n = len(params)
    lr_scales = [1.0] * n if lr_scales is None else lr_scales
    wds = [0.0] * n if wds is None else wds
    l2s = [0.0] * n if l2s is None else l2s
    need_clip = [True] * n if need_clip is None else need_clip
    vmaxes = [None] * n if max_exp_avg_sqs is None else max_exp_avg_sqs
    k = adam_consts(beta1, beta2, eps, (step + 1).float())
    for i in range(n):
        p, g, master = params[i], grads[i], masters[i]
        g32 = g.float()
        if inv_scale is not None:
            g32 = _round_to(g32 * inv_scale, g.dtype)
        if clip_scale is not None and need_clip[i]:
            g32 = _round_to(g32 * clip_scale, g.dtype)
        pv = master if master is not None else p.detach().float()
        lr_t, decay = tensor_lr(lr, lr_scales[i], wds[i], p.device)
        vmax = vmaxes[i]
        out, m, v, vm = adam_math(
            pv, g32, exp_avgs[i].float(), exp_avg_sqs[i].float(),
            None if vmax is None else vmax.float(), lr_t, decay, l2s[i], k)
        if master is not None:
            master.copy_(_gate(found_inf, master, out))
        p.detach().copy_(_gate(found_inf, p.detach(), out.to(p.dtype)))
        for store, new in ((exp_avgs[i], m), (exp_avg_sqs[i], v),
                           (vmax, vm)):
            if store is not None:
                store.copy_(_gate(found_inf, store, new.to(store.dtype)))
    if bump:
        _bump(step, found_inf)


def _bump(step, found_inf):
    step.add_(1 if found_inf is None else (~found_inf).to(step.dtype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_occupancy = {}
_counters = {}
_norm_plans = {}
_adam_plans = {}
# a fused-scan step updates each layer chunk's slices through a list of
# its own (25 lists a step at GPT-3 1.3B, layer_chunk=1): every list of a
# step stays cached, so the steps after the first build and upload nothing
_MAX_PLANS = 256


def _lib():
    lib = _build.load("multi_tensor", _SIGNATURES)
    got = (lib.mt_max_tensors(), lib.mt_chunk(), lib.mt_norm_chunk())
    if got != (MAX_TENSORS, CHUNK, NORM_CHUNK):
        raise RuntimeError(f"csrc/multi_tensor.cu's table and chunk sizes "
                           f"{got} differ from the wrapper's")
    return lib


def _grid(device, chunks, kind):
    """Blocks of a launch over ``chunks`` chunks: as many as the card
    holds at once (``kind``: "norm", or the (parameter, moment) dtype
    codes of an Adam launch), at most one a chunk."""
    key = (device, kind)
    if key not in _occupancy:
        with torch.cuda.device(device):
            per_sm = _lib().mt_norm_blocks_per_sm() if kind == "norm" \
                else _lib().mt_adam_blocks_per_sm(*kind)
        if per_sm <= 0:
            raise RuntimeError(f"multi_tensor: no occupancy for {kind}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _occupancy[key] = per_sm * sms
    return max(1, min(chunks, _occupancy[key]))


def _counter(device, stream):
    """A zeroed int32 counter for the last-block handshake on ``stream``
    (the last block wraps it back to 0). Under CUDA-graph capture a fresh
    one, whose zero fill the graph captures."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=device)
    buf = _counters.get((device, stream))
    if buf is None:
        buf = _counters[(device, stream)] = torch.zeros(
            1, dtype=torch.int32, device=device)
    return buf


def _cache(plans, key, build):
    plan = plans.get(key)
    if plan is None:
        if len(plans) >= _MAX_PLANS:
            plans.clear()
        plan = plans[key] = build()
    return plan


def _launches(numels, group_keys=None, chunk=CHUNK):
    """Cut tensor indices into launches: consecutive runs of one group,
    at most `MAX_TENSORS` each; empty tensors are left out. Returns
    ``[(group, [indices], [first chunks], chunks)]``, in chunks of
    ``chunk`` elements."""
    groups = {}
    for i, numel in enumerate(numels):
        if numel:
            groups.setdefault(None if group_keys is None else group_keys[i],
                              []).append(i)
    out = []
    for group, idx in groups.items():
        for s in range(0, len(idx), MAX_TENSORS):
            part = idx[s:s + MAX_TENSORS]
            firsts, c = [], 0
            for i in part:
                firsts.append(c)
                c += -(-numels[i] // chunk)
            out.append((group, part, firsts, c))
    return out


def _upload(rows, device):
    return torch.from_numpy(rows.view(np.uint8).copy()).to(device)


def _check_list(name, ts, device):
    for t in ts:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: no kernel for {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _ptr_array(ptrs):
    return ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p)


def multi_tensor_norm(grads, need_clip=None, inv_scale=None, clip_norm=None,
                      write=False, device=None):
    """``(stats, found)`` of the grads (see the module docstring). CUDA
    tensors launch ``mt_norm_kernel`` once per `MAX_TENSORS` grads (the
    last launch combines every launch's block partials in block order),
    counted in ``.launches``."""
    grads = list(grads)
    need_clip = [True] * len(grads) if need_clip is None else \
        [bool(c) for c in need_clip]
    if len(need_clip) != len(grads):
        raise ValueError("need_clip must have one flag a grad")
    if not grads or grads[0].device.type == "cpu":
        return multi_tensor_norm_ref(grads, need_clip, inv_scale, clip_norm,
                                     write, device)
    dev = grads[0].device
    _check_list("multi_tensor_norm", grads, dev)
    if inv_scale is not None and (inv_scale.device != dev or
                                  inv_scale.dtype != torch.float32):
        raise TypeError("inv_scale must be an fp32 scalar on the grads' "
                        "device")
    key = (dev, tuple((g.numel(), g.dtype, c)
                      for g, c in zip(grads, need_clip)))

    def build():
        launches = _launches([g.numel() for g in grads], chunk=NORM_CHUNK)
        rows = np.zeros(sum(len(ix) for _, ix, _, _ in launches),
                        _NORM_ENTRY)
        plan, r, parts = [], 0, 0
        for _, idx, firsts, chunks in launches:
            for i, c0 in zip(idx, firsts):
                rows[r] = (grads[i].numel(), c0, _CODES[grads[i].dtype],
                           _NEED_CLIP if need_clip[i] else 0, 0)
                r += 1
            grid = _grid(dev, chunks, "norm")
            plan.append((r - len(idx), idx, chunks, grid, parts))
            parts += grid
        return _upload(rows, dev), plan, parts

    table, plan, parts = _cache(_norm_plans, key, build)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    found = torch.empty((), dtype=torch.bool, device=dev)
    if not plan:                         # only empty grads
        stats.copy_(torch.tensor([0.0, 1.0]))
        found.zero_()
        return stats, found
    part = torch.empty(2 * parts, dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _counter(dev, stream)
        for j, (row0, idx, chunks, grid, offset) in enumerate(plan):
            rc = lib.mt_norm(
                table.data_ptr() + row0 * _NORM_ENTRY.itemsize,
                _ptr_array([grads[i].data_ptr() for i in idx]), len(idx),
                chunks, grid,
                None if inv_scale is None else inv_scale.data_ptr(),
                int(bool(write)), part.data_ptr(), offset, parts,
                int(j == len(plan) - 1), counter.data_ptr(),
                stats.data_ptr(), found.data_ptr(),
                int(clip_norm is not None),
                0.0 if clip_norm is None else float(clip_norm), stream)
            if rc:
                raise RuntimeError(f"mt_norm launch failed: CUDA error {rc}")
            multi_tensor_norm.launches += 1
    return stats, found


def multi_tensor_adam(params, grads, masters, exp_avgs, exp_avg_sqs,
                      max_exp_avg_sqs=None, *, lr, beta1, beta2, eps, step,
                      lr_scales=None, wds=None, l2s=None, need_clip=None,
                      found_inf=None, inv_scale=None, clip_scale=None,
                      bump=True):
    """``_adam_math`` over every tensor in place (see the module
    docstring). ``masters[i]`` is the fp32 master of ``params[i]`` or
    None; ``max_exp_avg_sqs`` the amsgrad ``vmax`` list or None;
    ``step`` an int32 device counter (raised only with ``bump``);
    ``found_inf``, ``inv_scale`` and
    ``clip_scale`` device scalars or None. CUDA tensors launch
    ``mt_adam_kernel<P, M>`` once per (parameter, moment) dtype group of
    up to `MAX_TENSORS` tensors, counted in ``.launches``."""
    n = len(params)
    lists = (grads, masters, exp_avgs, exp_avg_sqs)
    if any(len(x) != n for x in lists) or (
            max_exp_avg_sqs is not None and len(max_exp_avg_sqs) != n):
        raise ValueError("multi_tensor_adam: lists of different lengths")
    lr_scales = [1.0] * n if lr_scales is None else list(lr_scales)
    wds = [0.0] * n if wds is None else list(wds)
    l2s = [0.0] * n if l2s is None else list(l2s)
    need_clip = [True] * n if need_clip is None else list(need_clip)
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, step=step,
              lr_scales=lr_scales, wds=wds, l2s=l2s, need_clip=need_clip,
              found_inf=found_inf, inv_scale=inv_scale,
              clip_scale=clip_scale, bump=bump)
    if step.device.type == "cpu":
        return multi_tensor_adam_ref(params, grads, masters, exp_avgs,
                                     exp_avg_sqs, max_exp_avg_sqs, **kw)
    dev = step.device
    vmaxes = [None] * n if max_exp_avg_sqs is None else max_exp_avg_sqs
    params = [p.detach() for p in params]
    _check_list("multi_tensor_adam", params + list(grads) + list(exp_avgs) +
                list(exp_avg_sqs) + [t for t in list(masters) + vmaxes
                                     if t is not None], dev)
    for p, g, master, m, v, vm in zip(params, grads, masters, exp_avgs,
                                      exp_avg_sqs, vmaxes):
        if g.dtype != p.dtype or g.numel() != p.numel():
            raise TypeError("multi_tensor_adam: a grad must have its "
                            "parameter's dtype and size")
        if m.dtype != v.dtype or (vm is not None and vm.dtype != m.dtype) \
                or m.numel() != p.numel() or v.numel() != p.numel():
            raise TypeError("multi_tensor_adam: moments must share a dtype "
                            "and the parameter's size")
        if master is not None and (master.dtype != torch.float32 or
                                   master.numel() != p.numel()):
            raise TypeError("multi_tensor_adam: masters must be fp32 of "
                            "the parameter's size")
    for name, t, dt in (("step", step, torch.int32),
                        ("found_inf", found_inf, torch.bool),
                        ("inv_scale", inv_scale, torch.float32),
                        ("clip_scale", clip_scale, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != dt):
            raise TypeError(f"multi_tensor_adam: {name} must be a {dt} "
                            f"scalar on {dev}")

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    key = (dev, tuple((ptr(p), ptr(ms), ptr(m), ptr(v), ptr(vm), p.numel(),
                       p.dtype, m.dtype, float(s), float(w), float(l),
                       bool(c))
                      for p, ms, m, v, vm, s, w, l, c in zip(
                          params, masters, exp_avgs, exp_avg_sqs, vmaxes,
                          lr_scales, wds, l2s, need_clip)))

    def build():
        launches = _launches([p.numel() for p in params],
                             [(_CODES[p.dtype], _CODES[m.dtype])
                              for p, m in zip(params, exp_avgs)])
        rows = np.zeros(sum(len(ix) for _, ix, _, _ in launches),
                        _ADAM_ENTRY)
        plan, r = [], 0
        for group, idx, firsts, chunks in launches:
            for i, c0 in zip(idx, firsts):
                rows[r] = (ptr(params[i]), ptr(masters[i]), ptr(exp_avgs[i]),
                           ptr(exp_avg_sqs[i]), ptr(vmaxes[i]),
                           params[i].numel(), c0,
                           _NEED_CLIP if need_clip[i] else 0, lr_scales[i],
                           wds[i], l2s[i], 0.0)
                r += 1
            plan.append((group, r - len(idx), idx, chunks,
                         _grid(dev, chunks, group)))
        return _upload(rows, dev), plan

    table, plan = _cache(_adam_plans, key, build)
    if not plan:                          # nothing to update
        if bump:
            _bump(step, found_inf)
        return
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _counter(dev, stream)
        for j, ((pcode, mcode), row0, idx, chunks, grid) in enumerate(plan):
            rc = lib.mt_adam(
                pcode, mcode, table.data_ptr() + row0 * _ADAM_ENTRY.itemsize,
                _ptr_array([grads[i].data_ptr() for i in idx]), len(idx),
                chunks, grid, float(lr), float(beta1), float(beta2),
                1.0 - beta1, 1.0 - beta2, float(eps), step.data_ptr(),
                ptr(found_inf), ptr(inv_scale), ptr(clip_scale),
                int(bump and j == len(plan) - 1), counter.data_ptr(),
                stream)
            if rc:
                raise RuntimeError(f"mt_adam launch failed: CUDA error {rc}")
            multi_tensor_adam.launches += 1


multi_tensor_norm.launches = 0
multi_tensor_adam.launches = 0
