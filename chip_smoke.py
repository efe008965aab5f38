#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, nothing is caught):

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build every kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, in fp32 (max abs err <= 1e-4) and
   bf16 (<= 2e-2 against the plain version on the same bf16 inputs),
   then timed with CUDA events (L2 flushed between launches) beside the
   plain version and one PyTorch library call on the same inputs;
4. end-to-end parity: a tiny fp32 GPT served on the card (kernels) and
   on the CPU (plain versions) gives identical greedy tokens;
5. the serving path at GPT-3 1.3B width: 16 greedy requests through
   ``ServingEngine`` with bf16 weights and pools; the kernels' launch
   counters are zeroed just before and read just after, and must both
   be > 0;
6. one JSON line ``{"kernels": [...]}`` with each kernel's error, times,
   bound and launches.

It then prints the ``nvidia-smi`` line again and, last, ``{"ok": true,
"device": {...}}``. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # fp32 outside the tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch, the L2 cache flushed before each (the serving
    path reaches attention with other layers' weights in between)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(nbytes: float, flops: float, itemsize: int):
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, flush):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    b, nh, kvh, d, ps, pp = 8, 32, 32, 64, 16, 64   # decode at 1.3B width
    num_pages = 1 + b * pp
    L = pp * ps
    gen = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn(b, nh, d, device=dev, generator=gen)
    k32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
    v32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
    pt = (torch.randperm(num_pages - 1, device=dev, generator=gen) + 1) \
        .to(torch.int32).reshape(b, pp)
    lens = torch.tensor([0, 1, 17, 100, 333, 512, 777, L], dtype=torch.int32,
                        device=dev)
    cb, c = 4, 64                                   # one chunk-prefill call
    qc32 = torch.randn(cb, c, nh, d, device=dev, generator=gen)
    ptc = pt[:cb].contiguous()
    start = torch.tensor([0, 64, 300, L - c], dtype=torch.int32, device=dev)

    results = {}
    cases = {
        "paged_decode_kernel": (pa.paged_attention, pa.paged_attention_ref,
                                q32, pt, lens),
        "paged_chunk_kernel": (pa.paged_attention_chunk,
                               pa.paged_attention_chunk_ref, qc32, ptc,
                               start),
    }
    for name, (kernel, plain, q, table, pos) in cases.items():
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = (q.to(dtype), k32.to(dtype), v32.to(dtype), table, pos)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = float((got.float() - want.float()).abs().max())
            if not (err <= tol and torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} {dtype}: max abs err {err} > {tol}")
            errs[dtype] = err
        # times at the serving path's dtype (bf16)
        args = (q.to(torch.bfloat16), k32.to(torch.bfloat16),
                v32.to(torch.bfloat16), table, pos)
        kd = pa._densify(args[1], table)            # [b, kvh, L, d]
        vd = pa._densify(args[2], table)
        if q.dim() == 3:
            qs = args[0][:, :, None]                # [b, nh, 1, d]
            mask = (torch.arange(L, device=dev)[None] < pos[:, None]) \
                [:, None, None]
            keys = pos.clamp(max=L).double()
            rows_keys = keys * nh                   # one query per head
        else:
            qs = args[0].transpose(1, 2)            # [b, nh, c, d]
            ipos = pos[:, None] + torch.arange(c, device=dev)[None]
            mask = (torch.arange(L, device=dev)[None, None]
                    <= ipos[:, :, None])[:, None]
            keys = (pos + c).clamp(max=L).double()
            rows_keys = (ipos + 1).clamp(max=L).double().sum(1) * nh
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qs, kd, vd, attn_mask=mask)
        item = 2
        nbytes = float(2 * qs.numel() * item                 # q in, out
                       + (keys.sum() * kvh * d * 2 * item).item()
                       + ((keys / ps).ceil().sum() * 4).item()
                       + pos.numel() * 4)
        flops = float((4 * rows_keys.sum() * d).item())
        b_ms, b_by = bound_ms(nbytes, flops, item)
        results[name] = {
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "ms": time_ms(lambda: kernel(*args), flush),
            "plain_ms": time_ms(lambda: plain(*args), flush),
            "library_ms": time_ms(library, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": list(q.shape),
        }
        r = results[name]
        print(f"[3/6] {name}: q {r['shape']} max abs err fp32 "
              f"{errs[torch.float32]:.3g} bf16 {errs[torch.bfloat16]:.3g}; "
              f"bf16 kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 4: tiny model, card vs CPU
# ---------------------------------------------------------------------------

def parity(dev):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    cpu = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card = GPTForCausalLM(cfg, device=dev)
    card.load_state_dict(sd)
    prompts = [rng.integers(1, 128, (n,)).astype(np.int32)
               for n in (5, 17, 33, 64, 9, 70)]
    budgets = [int(n) for n in rng.integers(8, 17, len(prompts))]
    tokens, leaks = {}, {}
    for where, model in (("card", card), ("cpu", cpu)):
        eng = ServingEngine(model, max_slots=4, max_len=128, page_size=16,
                            chunk_size=32, prefill_batch=2,
                            device=dev if where == "card" else "cpu")
        handles = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        eng.run()
        tokens[where] = [h.output_tokens for h in handles]
        leaks[where] = eng.leak_check()
        lk = leaks[where]
        if not (lk["free_pages"] == lk["total_pages"]
                and lk["free_slots"] == lk["total_slots"]
                and lk["resident_slot_pages"] == 0):
            raise AssertionError(f"{where} engine leaked: {lk}")
    if tokens["card"] != tokens["cpu"]:
        raise AssertionError(f"card/CPU greedy tokens differ:\n"
                             f"{tokens['card']}\n{tokens['cpu']}")
    n = sum(len(t) for t in tokens["card"])
    print(f"[4/6] parity: tiny fp32 GPT, {len(prompts)} greedy requests, "
          f"{n} tokens identical on card and CPU; no leaks", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the serving path at GPT-3 1.3B width
# ---------------------------------------------------------------------------

def serve_full_width(dev):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import ServingEngine, ServingMetrics

    cfg = gpt_config("gpt3-1.3b")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    eng = ServingEngine(model, max_slots=8, max_len=1024, page_size=16,
                        chunk_size=64, prefill_batch=4,
                        cache_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up (cuBLAS heuristics, allocator): one short request, then
    # fresh metrics and step counters for the measured run
    eng.submit(np.random.default_rng(1).integers(0, cfg.vocab_size, (64,)),
               4)
    eng.run()
    eng.metrics = ServingMetrics(clock=eng.clock)
    eng.scheduler.metrics = eng.metrics
    eng.prefill_step.calls = eng.decode_step.calls = 0
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 769, 16)
    budgets = rng.integers(32, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    pa.paged_attention_chunk.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(p, int(n)) for p, n in zip(prompts, budgets)]
    snap = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_kernel": pa.paged_attention.launches,
                "paged_chunk_kernel": pa.paged_attention_chunk.launches}

    for h, n in zip(handles, budgets):
        toks = np.asarray(h.output_tokens)
        if not (h.done and len(toks) == n and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"request {h.request.rid}: done={h.done}, "
                                 f"{len(toks)} of {n} tokens")
    leaks = eng.leak_check()
    if leaks["free_pages"] != leaks["total_pages"] or \
            leaks["free_slots"] != leaks["total_slots"]:
        raise AssertionError(f"leaked pages or slots: {leaks}")
    pool = eng.cache.pool_stats()
    calls = {"paged_decode_kernel": eng.decode_step.calls,
             "paged_chunk_kernel": eng.prefill_step.calls}
    stats = {
        "model": "gpt3-1.3b", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        "vocab": cfg.vocab_size, "dtype": "bfloat16",
        "setup_s": round(setup_s, 3),
        "requests": len(handles), "finished": snap["finished"],
        "prompt_tokens": int(lens.sum()),
        "generated_tokens": snap["generated_tokens"],
        "wall_s": round(wall, 3),
        "output_tok_s": round(snap["generated_tokens"] / wall, 2),
        "ttft_p50_s": snap["ttft_p50_s"], "ttft_p99_s": snap["ttft_p99_s"],
        "itl_p50_s": snap["itl_p50_s"], "itl_p99_s": snap["itl_p99_s"],
        "decode_steps": snap["decode_steps"],
        "prefill_calls": calls["paged_chunk_kernel"],
        "preemptions": snap["preemptions"],
        "pool_bytes": pool["pool_bytes"],
        "kv_bytes_per_token": pool["bytes_per_token"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "launches_per_call": {k: launches[k] / max(calls[k], 1)
                              for k in launches},
    }
    print(f"[5/6] serve gpt3-1.3b: {json.dumps(stats)}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the path: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.framework import resolve_device
    from paddle_tpu_torch.ops.kernels import _build

    dev = resolve_device()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[1/6] device: {kind}, count {count}; nvidia-smi: {smi}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    regs = [line.strip() for info in built.values()
            for line in info["log"].splitlines() if "registers" in line]
    print(f"[2/6] build: {sorted(built) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {regs}", flush=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = check_kernels(dev, flush)
    del flush
    parity(dev)
    launches = serve_full_width(dev)

    source = "paddle_tpu_torch/csrc/paged_attention.cu"
    replaces = {
        "paged_decode_kernel": "paddle_tpu/ops/pallas/paged_attention.py:163",
        "paged_chunk_kernel": "paddle_tpu/ops/pallas/paged_attention.py:400",
    }
    line = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces[name], "launches": launches[name],
             **{k: r[k] for k in ("max_abs_err", "max_abs_err_fp32", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "shape")}}
            for name, r in kernels.items()]
    print("[6/6] kernels:", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
