"""Where the training step's time goes on the card.

    [FLAGS_splash_attn=0] python -m paddle_tpu_torch.profile_training \\
        [--steps N] [--seq S] [--batch B]

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
the matrix products and of everything else, and the top kernels by
device time. Needs a CUDA card.
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


def build(batch=8, seq=1024, seed=0):
    """(step, ids, labels) of the phase-9/10 configuration."""
    cfg = gpt_config("gpt3-1.3b", use_recompute=True,
                     max_position_embeddings=seq)
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0))
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA card")
    step, ids, labels = build(args.batch, args.seq)
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
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(ev.key, (0.0, 0))
            kernels[ev.key] = (us + dev_us, n + ev.count)
    busy = sum(us for us, _ in kernels.values()) / 1e6

    def share(names):
        return sum(us for k, (us, _) in kernels.items()
                   if any(n in k.lower() for n in names)) / 1e6

    ours = {n: t for n in _KERNELS
            if (t := share((n.lower(),)) / args.steps) > 0}
    gemm = share(_GEMM) / args.steps
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
        "gemm_s_per_step": gemm,
        "other_s_per_step": busy / args.steps - gemm - sum(ours.values()),
        "top_kernels": [{"name": k[:90], "s": us / 1e6, "count": n}
                        for k, (us, n) in top],
    }))


if __name__ == "__main__":
    main()
