"""Where the training step's time goes on the card.

    [FLAGS_splash_attn=0] python -m paddle_tpu_torch.profile_training \\
        [--steps N] [--seq S] [--batch B] [--per-param]

Builds the configuration of ``chip_smoke.py`` phases 9-10 (GPT-3 1.3B
width, bf16 weights from seed 0, fp32 masters, bf16 AdamW moments,
global-norm clip 1.0, recompute, ``--batch`` x ``--seq`` random tokens
from seed 0, default 8 x 1024; the position table is ``--seq`` long),
takes two warm-up steps, then ``--steps`` steps (default 2) under
``torch.profiler`` and prints one JSON line: the wall time per step, the
device time summed over every kernel (one stream, so kernels never
overlap), the device's idle share of the wall, kernels launched per step,
the device time of each training kernel (splash, or with
``FLAGS_splash_attn`` off, which the registry reads from the environment,
the flash kernels of the length's path; and the fused cross entropy), of
the optimizer, of the matrix products and of everything else, and the
top kernels by device time. The optimizer's time is every kernel
launched between ``opt.step()``'s entry and its exit (a
``record_function`` range: by default the fused AdamW's two kernels,
``mt_norm_kernel`` and ``mt_adam_kernel``, also reported by name; with
``--per-param``, ``use_multi_tensor=False``, the per-parameter loop's
aten calls and the clip's norm kernel), beside the range's span on the
device, which holds the gaps between its kernels too. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .jit import TrainStep
from .models import GPTForCausalLM, gpt_config
from .nn import ClipGradByGlobalNorm
from .optimizer import AdamW
from .utils import flags

_KERNELS = ("splash_fwd_wgmma_kernel", "splash_fwd_kernel",
            "splash_delta_kernel", "splash_dq_wgmma_kernel",
            "splash_dkdv_wgmma_kernel", "splash_dkdv_kernel",
            "splash_dq_kernel",
            "flash_single_fwd_wgmma_kernel", "flash_single_fwd_kernel",
            "flash_single_dq_wgmma_kernel", "flash_single_dkdv_wgmma_kernel",
            "flash_single_dq_kernel", "flash_single_dkdv_kernel",
            "flash_fwd_wgmma_kernel", "flash_fwd_kernel",
            "flash_delta_kernel", "flash_dq_wgmma_kernel",
            "flash_dkdv_wgmma_kernel", "flash_dkdv_kernel", "flash_dq_kernel",
            "fused_ce_fwd_wgmma_kernel", "fused_ce_fwd_kernel",
            "fused_ce_combine_kernel",
            "fused_ce_bwd_wgmma_kernel<0>", "fused_ce_bwd_wgmma_kernel<1>",
            "fused_ce_bwd_wgmma_kernel<2>", "fused_ce_dh_kernel",
            "fused_ce_dw_kernel", "fused_ce_cast_kernel")
_GEMM = ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")
_OPTIMIZER = ("mt_norm_kernel", "mt_adam_kernel")
_RANGE = "optimizer.step"


def _annotate(opt):
    """Mark every ``opt.step()`` as a profiler range."""
    step = opt.step

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(_RANGE):
            return step(*args, **kwargs)

    opt.step = annotated


def build(batch=8, seq=1024, seed=0, per_param=False):
    """(step, ids, labels) of the phase-9/10 configuration (with
    ``per_param``, AdamW's ``use_multi_tensor=False``)."""
    cfg = gpt_config("gpt3-1.3b", use_recompute=True,
                     max_position_embeddings=seq)
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0),
                use_multi_tensor=not per_param)
    _annotate(opt)
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt)
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.max_position_embeddings)
    dev = next(model.parameters()).device
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    return step, ids, labels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2,
                    help="steps under the profiler")
    ap.add_argument("--seq", type=int, default=1024, help="tokens a row")
    ap.add_argument("--batch", type=int, default=8, help="rows a step")
    ap.add_argument("--per-param", action="store_true",
                    help="AdamW's per-parameter loop (use_multi_tensor="
                         "False) instead of the fused kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA card")
    step, ids, labels = build(args.batch, args.seq,
                              per_param=args.per_param)
    for _ in range(2):                                 # warm-up
        float(step(ids, labels))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # the range also shows on the device as a span: not a kernel
        if dev_us > 0 and ev.device_type == cuda and ev.key != _RANGE:
            us, n = kernels.get(ev.key, (0.0, 0))
            kernels[ev.key] = (us + dev_us, n + ev.count)
    busy = sum(us for us, _ in kernels.values()) / 1e6

    def share(names):
        return sum(us for k, (us, _) in kernels.items()
                   if any(n in k.lower() for n in names)) / 1e6

    ours = {n: t for n in _KERNELS
            if (t := share((n.lower(),)) / args.steps) > 0}
    gemm = share(_GEMM) / args.steps
    # every kernel launched inside opt.step()'s range: the aten calls'
    # (attributed to the range) and ours, which are launched through
    # ctypes, attributed to no operator and so taken by name; and the
    # range's span on the device, gaps between its kernels included
    ranges = [ev for ev in prof.events() if ev.name == _RANGE]
    fused = {n: t for n in _OPTIMIZER
             if (t := share((n.lower(),)) / args.steps) > 0}
    optimizer = sum(ev.device_time_total for ev in ranges
                    if ev.device_type == cpu) / 1e6 / args.steps \
        + sum(fused.values())
    span = sum(ev.time_range.elapsed_us() for ev in ranges
               if ev.device_type == cuda) / 1e6 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "seq": args.seq, "batch": args.batch,
        "FLAGS_splash_attn": flags.get_flag("FLAGS_splash_attn"),
        "steps": args.steps,
        "wall_s_per_step": wall / args.steps,
        "device_busy_s_per_step": busy / args.steps,
        "device_idle_share": 1.0 - busy / wall,
        "kernels_per_step": sum(n for _, n in kernels.values()) / args.steps,
        "training_kernels_s_per_step": ours,
        "optimizer": "per-parameter" if args.per_param else "fused",
        "optimizer_s_per_step": optimizer,
        "optimizer_span_s_per_step": span,
        "optimizer_kernels_s_per_step": fused,
        "gemm_s_per_step": gemm,
        "other_s_per_step": (busy / args.steps - gemm - sum(ours.values())
                             - optimizer),
        "top_kernels": [{"name": k[:90], "s": us / 1e6, "count": n}
                        for k, (us, n) in top],
    }))


if __name__ == "__main__":
    main()
