"""Where the serving path's time goes on the card.

    python -m paddle_tpu_torch.profile_serving [--timed N]
        [--kv-quant {int8,int4}] [--eager] [--spec] [--weight-only]

Serves the workload of ``chip_smoke.py`` phase 5 (GPT-3 1.3B width,
bf16 weights, bf16 pools or with ``--kv-quant`` int8 / int4 ones, 8
slots, 16 greedy requests with prompts of 64-768 tokens and 32-128 new
tokens, all from seed 0) through the engine's CUDA graphs (its
default, ``compiled=True``; ``--eager`` serves through the eager loop,
``compiled=False``): `ServingEngine.warmup`, the workload once to warm
up, then again under ``torch.profiler``, and prints one JSON line: the
path, the engine's capture counts, the wall
time, the device time summed over every kernel (one stream, so kernels
never overlap), the device's idle share of the wall time, the device
time of the paged-attention kernels, of the matrix products and of
everything else, and the top kernels by device time. ``--timed N``
instead serves the workload N more times without the profiler and
prints one JSON line per run (wall, output tok/s, TTFT and inter-token
latency percentiles). ``--spec`` profiles the strong pair instead
(`inference.spec_decode_selftest.strong_pair` at the same width: the
target's blocks past block 0 write nothing to the residual, a one-layer
draft computes its logits), through a plain engine and a speculative one
(``spec_k`` 4) of the same target, and splits each one's device time into
the draft's decode (``paged_decode_split_kernel``: only the draft
decodes in the spec run), the chunk kernel (the prompt chunks, and in the
spec run the verify too: ``verify_chunk_s`` is the spec run's chunk time
less the plain run's), GEMM and the rest, with the idle share.
``--weight-only`` profiles the decode products alone: GPT-3 1.3B's four
projections at M 1, 8 and 1024 over bf16 x, int8 per channel, each as 8
calls over 8 weights back to back in one CUDA graph (none of the weights
in L2 when its call comes, as in a decode step), and prints the device
ms a call by kernel (``weight_only_linear``'s route and, when its K is
split, the combine) beside ``F.linear``'s over the bf16 weights. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch

from .inference.spec_decode_selftest import strong_pair
from .jit.graphs import graph_of
from .models import GPTForCausalLM, gpt_config
from .nn.quant import weight_dequantize, weight_quantize
from .ops.kernels.weight_only import weight_only_linear
from .serving import ServingEngine

_ATTENTION = ("paged_decode_split_kernel", "paged_decode_kernel",
              "paged_chunk_kernel", "paged_chunk_wgmma_kernel",
              "paged_decode_q_kernel", "paged_chunk_q_kernel")
_GEMM = ("gemm", "cutlass", "cublas", "sm90_xmma", "nvjet")


def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 769, 16)
    budgets = rng.integers(32, 129, 16)
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), int(m))
            for n, m in zip(lens, budgets)]


def _serve(engine, requests):
    """Serve ``requests`` on fresh metrics; (handles, snapshot, wall)."""
    engine.reset_metrics()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(p, n) for p, n in requests]
    snap = engine.run()
    torch.cuda.synchronize()
    return handles, snap, time.perf_counter() - t0


def _profile(engine, requests):
    """Serve ``requests`` once under ``torch.profiler``: the device-time
    breakdown (one stream, so kernels never overlap)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        handles, snap, wall = _serve(engine, requests)
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (kernels.get(ev.key, (0.0, 0))[0] + dev_us,
                               kernels.get(ev.key, (0.0, 0))[1] + ev.count)
    busy = sum(us for us, _ in kernels.values()) / 1e6

    def share(names):
        return sum(us for k, (us, _) in kernels.items()
                   if any(n in k.lower() for n in names)) / 1e6

    attention = {n: share((n.lower(),)) for n in _ATTENTION}
    gemm = share(_GEMM)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "compile_counts": engine.compile_counts(),
        "requests": len(handles),
        "generated_tokens": sum(len(h.output_tokens) for h in handles),
        "wall_s": wall,
        "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "attention_s": attention,
        "gemm_s": gemm,
        "other_s": busy - gemm - sum(attention.values()),
        "kernel_launches": sum(n for _, n in kernels.values()),
        "decode_steps": snap["decode_steps"],
        "prefill_chunks": snap["prefill_chunks"],
        "spec_accept_rate": snap["spec_accept_rate"],
        "spec_tokens_per_dispatch": snap["spec_tokens_per_dispatch"],
        "top_kernels": [{"name": k[:90], "s": us / 1e6, "count": n}
                        for k, (us, n) in top],
    }


def _engine(model, args, **kw):
    return ServingEngine(model, max_slots=8, max_len=1024, page_size=16,
                         chunk_size=64, prefill_batch=4,
                         cache_dtype=torch.bfloat16, kv_quant=args.kv_quant,
                         compiled=not args.eager, **kw)


def _spec(args, cfg):
    """``--spec``: the strong pair, plain then speculative."""
    tgt, drf = strong_pair(cfg, dtype=torch.bfloat16)
    requests = _requests(cfg.vocab_size)
    out = {"device": torch.cuda.get_device_name(0), "spec_k": 4,
           "kv_quant": args.kv_quant, "compiled": not args.eager}
    for name, kw in (("plain", {}), ("spec", dict(draft_model=drf,
                                                  spec_k=4))):
        engine = _engine(tgt, args, **kw)
        engine.warmup()
        _serve(engine, requests)                   # warm-up
        out[name] = r = _profile(engine, requests)
        chunk = sum(v for k, v in r["attention_s"].items() if "chunk" in k)
        r["draft_decode_s"] = sum(v for k, v in r["attention_s"].items()
                                  if "decode" in k)
        r["chunk_s"] = chunk
        r["rest_s"] = r["device_busy_s"] - r["gemm_s"] - chunk \
            - r["draft_decode_s"]
        del engine
    out["verify_chunk_s"] = out["spec"]["chunk_s"] - out["plain"]["chunk_s"]
    out["wall_speedup"] = out["plain"]["wall_s"] / out["spec"]["wall_s"]
    return out


# GPT-3 1.3B's four projections, [out, in]
_PROJECTIONS = {"qkv": (6144, 2048), "out_proj": (2048, 2048),
                "fc1": (8192, 2048), "fc2": (2048, 8192)}


def _by_kernel(fns, replays=5):
    """{kernel: device ms a call} of ``fns`` captured back to back in
    one CUDA graph and replayed under the profiler."""
    graph = graph_of(fns)
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.sub(r"^void |<.*$|\(.*$", "", e.key)
        if e.device_time_total and name:
            out[name] = out.get(name, 0.0) + (
                e.device_time_total / 1e3 / replays / len(fns))
    return out


def _weight_only(copies=8):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for proj, (n, k) in _PROJECTIONS.items():
        ws = [weight_quantize(torch.randn(k, n, device="cuda",
                                          generator=gen) * 0.02)
              for _ in range(copies)]
        wbs = [weight_dequantize(q, s, out_dtype=torch.bfloat16)
               .t().contiguous() for q, s in ws]
        for m in (1, 8, 1024):
            x = torch.randn(m, k, device="cuda", generator=gen).to(
                torch.bfloat16)
            b = (torch.randn(n, device="cuda", generator=gen) * 0.02).to(
                torch.bfloat16)
            rows.append({
                "proj": proj, "m": m,
                "weight_only_ms": _by_kernel(
                    [lambda q=q, s=s: weight_only_linear(x, q, b, s)
                     for q, s in ws]),
                "f_linear_ms": _by_kernel(
                    [lambda w=w: torch.nn.functional.linear(x, w, b)
                     for w in wbs])})
        del ws, wbs
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=0, metavar="N",
                    help="N timed runs without the profiler instead")
    ap.add_argument("--kv-quant", choices=("int8", "int4"), default=None,
                    help="store the KV pages quantized")
    ap.add_argument("--eager", action="store_true",
                    help="the eager loop (compiled=False), not the graphs")
    ap.add_argument("--spec", action="store_true",
                    help="the strong pair, plain and speculative")
    ap.add_argument("--weight-only", action="store_true",
                    help="the decode products alone, by kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    if args.weight_only:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "weight_only": _weight_only()}))
        return
    cfg = gpt_config("gpt3-1.3b")
    if args.spec:
        print(json.dumps(_spec(args, cfg)))
        return
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=0)
    engine = _engine(model, args)
    requests = _requests(cfg.vocab_size)
    engine.warmup()
    _serve(engine, requests)                       # warm-up
    if args.timed:
        for run in range(args.timed):
            handles, snap, wall = _serve(engine, requests)
            print(json.dumps({
                "run": run, "kv_quant": args.kv_quant,
                "compiled": engine.compiled, "wall_s": wall,
                "generated_tokens": snap["generated_tokens"],
                "output_tok_s": snap["generated_tokens"] / wall,
                **{k: snap[k] for k in ("ttft_p50_s", "ttft_p99_s",
                                        "itl_p50_s", "itl_p99_s")}}),
                flush=True)
        return
    out = {"device": torch.cuda.get_device_name(0),
           "kv_quant": args.kv_quant, "compiled": engine.compiled,
           **_profile(engine, requests)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
