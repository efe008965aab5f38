#!/usr/bin/env python3
"""Training step times and serving figures of two checkouts, for an A/B
inside one card call.

    cd <checkout> && python3 <path to>/chip_ab.py <tag> [--no-serve]
        [--no-train]

Imports the ``chip_smoke.py`` (and so the ``paddle_tpu_torch``) of the
current directory, not of the directory this script sits in, and runs
its ``train_full_width`` as phases 9 and 10 do: splash at 8 x 1024 (5
timed steps), then with ``FLAGS_splash_attn`` off the flash pairs at 8 x
1024 and 4 x 2048 (3 timed steps each), GPT-3 1.3B width, each run
failing on a kernel launched off its path (unless ``--no-train``).
Then (unless ``--no-serve``)
its ``serve_full_width``
as phases 5 and 6 do, over bf16 and int8 pools (16 greedy requests; its
last line, the run through the engine's default path: the eager loop in
a checkout without CUDA graphs, the graphs in one with them), and the
same requests once more under ``torch.profiler`` through an engine with
the checkout's defaults, which gives the device's busy time and idle
share, and the decode and the chunk attention's device time and
launches (every kernel whose name holds ``paged_decode`` or
``paged_chunk``: either route). Prints one line, ``AB `` and a JSON
object: the tag, the card's
``nvidia-smi`` name and power limit, for each training run its step
times, median, peak device memory, tokens/s, ``mfu``, kernel launches
and, where the checkout reports them, the optimizer's launches a step
and ``opt.step()``'s kernels and device time alone, and for
each serving run its output tok/s, TTFT and inter-token latency, peak
memory, the idle share and the decode's and the chunk's device time. Run the parent checkout, this
one, this one again and the parent again in one call, and compare
within the call. Needs a CUDA card; imports torch, numpy and the port
only.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402

KEYS = ("step_ms", "step_ms_median", "max_memory_allocated",
        "tokens_per_s", "mfu", "launches", "optimizer_launches_per_step",
        "optimizer_step_alone")


def _stats_line(fn, *args, **kw) -> dict:
    """The JSON stats of the last line ``fn`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return json.loads(out.getvalue().strip().splitlines()[-1]
                      .split(": ", 1)[1])


def run(dev, **kw) -> dict:
    """One `train_full_width` run; its printed stats, the keys above."""
    stats = _stats_line(chip_smoke.train_full_width, dev, **kw)
    return {k: stats.get(k) for k in KEYS}


def serve(dev, model, kv_quant) -> dict:
    """Phase 5's (bf16) or 6's (int8) serving run: output tok/s, TTFT and
    inter-token latency; then its requests again under the profiler
    (warmed up first): the device's busy seconds and idle share, and the
    device seconds and launches of the decode and of the chunk
    kernels."""
    from paddle_tpu_torch import profile_serving
    from paddle_tpu_torch.serving import ServingEngine

    stats = _stats_line(chip_smoke.serve_full_width, dev, model, kv_quant)
    eng = ServingEngine(model, max_slots=8, max_len=1024, page_size=16,
                        chunk_size=64, prefill_batch=4,
                        cache_dtype=torch.bfloat16, kv_quant=kv_quant,
                        device=dev)
    requests = profile_serving._requests(model.config.vocab_size)
    profile_serving._serve(eng, requests)
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        _, _, wall = profile_serving._serve(eng, requests)
    us = {"decode": 0.0, "chunk": 0.0}
    n = {"decode": 0, "chunk": 0}
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        busy += t
        for kind in us:
            if f"paged_{kind}" in ev.key:
                us[kind] += t
                n[kind] += ev.count
    compiled = getattr(eng, "compiled", False)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"compiled": compiled,
            "output_tok_s": stats["output_tok_s"],
            **{k: stats.get(k) for k in (
                "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
                "max_memory_allocated", "max_memory_reserved")},
            "launches": stats["launches"],
            "profiled_wall_s": wall, "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "decode_device_s": us["decode"] / 1e6,
            "decode_kernels": n["decode"],
            "chunk_device_s": us["chunk"] / 1e6, "chunk_kernels": n["chunk"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    result = {"tree": args[0] if args else os.getcwd(),
              "smi": chip_smoke.nvidia_smi()}
    if "--no-train" not in sys.argv:
        result["splash_8x1024"] = run(dev)
        with chip_smoke.routing_flags(splash_attn=False):
            result["flash_8x1024"] = run(dev, timed=3, batch=8, seq=1024,
                                         splash=False, phase=10)
            result["flash_4x2048"] = run(dev, timed=3, batch=4, seq=2048,
                                         splash=False, phase=10)
    if "--no-serve" not in sys.argv:
        from paddle_tpu_torch.models import GPTForCausalLM, gpt_config

        model = GPTForCausalLM(gpt_config("gpt3-1.3b"), device=dev,
                               dtype=torch.bfloat16, seed=0)
        for quant in (None, "int8"):
            result[f"serve_{quant or 'bf16'}"] = serve(dev, model, quant)
    print("AB " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
