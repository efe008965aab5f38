"""Synthetic serving traffic and the static-batching baseline.

The port of paddle_tpu/serving/traffic.py: Poisson arrivals over mixed
prompt and output lengths (`poisson_traffic`), served through a
`ServingEngine` with real-time arrivals (`run_continuous`), against
static generate-and-wait batching (`run_static`): requests grouped into
fixed batches in arrival order, each batch running `generate()` to its
longest budget and delivering every member's tokens only when it
returns. One seed gives the reference's arrivals, prompts, budgets and
request seeds exactly (the same numpy generators). ``run_fleet`` comes
with the fleet (ROADMAP queue A8).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np

from .metrics import percentile

__all__ = ["TrafficRequest", "poisson_traffic", "run_continuous",
           "run_static"]


@dataclass
class TrafficRequest:
    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    # the request's sampling stream, whichever replica serves it; the
    # session key drives a fleet's affinity routing
    seed: int | None = None
    session: str | None = None


def _mixed_len(rng, bounds, long_frac):
    """Short/long mixture over [lo, hi]: most draws from the lower half,
    ``long_frac`` of them from the upper half."""
    lo, hi = int(bounds[0]), int(bounds[1])
    mid = max(lo + 1, (lo + hi) // 2)
    if rng.random() < long_frac:
        return int(rng.integers(mid, hi + 1))
    return int(rng.integers(lo, mid))


def poisson_traffic(n, rate_rps, vocab_size, prompt_lens=(8, 48),
                    out_lens=(8, 32), long_frac=0.25, seed=0,
                    sessions=0):
    """``n`` requests with exponential inter-arrival times (a Poisson
    process at ``rate_rps``) and short/long mixtures over prompt lengths
    and output budgets. Each request carries a seed from a separate
    generator stream; ``sessions > 0`` tags each with one of that many
    session keys."""
    rng = np.random.default_rng(seed)
    id_rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0x7FFFFFFF, 0xF1EE7]))
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = _mixed_len(rng, prompt_lens, long_frac)
        prompt = rng.integers(1, vocab_size, (plen,)).astype(np.int32)
        rseed = int(id_rng.integers(0, 2**31 - 1))
        sid = (f"s{int(id_rng.integers(0, sessions))}"
               if sessions else None)
        out.append(TrafficRequest(
            t, prompt, _mixed_len(rng, out_lens, long_frac),
            seed=rseed, session=sid))
    return out


def run_continuous(engine, traffic, max_steps=2_000_000):
    """Serve ``traffic`` through a ServingEngine with real-time arrivals:
    each request is submitted when its arrival time passes, while earlier
    ones prefill and decode. Returns (record, handles)."""
    pending = sorted(traffic, key=lambda r: r.arrival_s)
    handles, i, steps = [], 0, 0
    # a pending full collection must not land inside the measured window
    gc.collect()
    t0 = engine.clock()
    while i < len(pending) or engine.scheduler.has_work():
        now = engine.clock() - t0
        while i < len(pending) and pending[i].arrival_s <= now:
            r = pending[i]
            handles.append(engine.submit(
                r.prompt, r.max_new_tokens, priority=r.priority,
                seed=r.seed))
            i += 1
        if engine.scheduler.has_work():
            engine.step()
        elif i < len(pending):
            time.sleep(min(0.002, max(0.0, pending[i].arrival_s - now)))
        steps += 1
        if steps >= max_steps:
            raise RuntimeError("continuous traffic run did not drain")
    elapsed = engine.clock() - t0
    rec = engine.metrics_snapshot()
    rec["elapsed_s"] = round(elapsed, 4)
    rec["tok_s"] = round(rec["generated_tokens"] / max(elapsed, 1e-9), 2)
    rec["compile"] = engine.compile_counts()
    return rec, handles


def run_static(model, traffic, concurrency, max_len, page_size=16,
               clock=time.perf_counter):
    """Generate-and-wait baseline: batches of ``concurrency`` in strict
    arrival order through a paged `GenerationEngine`; a batch starts when
    its last member has arrived and the previous batch finished, runs to
    the batch's largest budget, and delivers every member's tokens when
    it returns (so TTFT = completion - arrival)."""
    from ..jit.decode_step import GenerationEngine

    reqs = sorted(traffic, key=lambda r: r.arrival_s)
    eng = GenerationEngine(model, kind="paged", batch=concurrency,
                           max_len=max_len, page_size=page_size)
    # warm the steps (decode and every prefill bucket the traffic can
    # reach) outside the measured window
    width = max(len(r.prompt) for r in reqs)
    for b in eng.prefill_buckets:
        if b > eng._bucket(width):
            break
        eng.generate(np.ones((concurrency, b), np.int64), 2)

    gc.collect()
    t0 = clock()
    ttfts, useful_tokens = [], 0
    for g0 in range(0, len(reqs), concurrency):
        group = reqs[g0:g0 + concurrency]
        # the batch cannot form before its last member arrives
        gate = t0 + max(r.arrival_s for r in group)
        now = clock()
        if now < gate:
            time.sleep(gate - now)
        plens = [len(r.prompt) for r in group]
        width = max(plens)
        ids = np.zeros((concurrency, width), np.int64)
        lens = np.ones((concurrency,), np.int32)
        for j, r in enumerate(group):
            ids[j, :plens[j]] = r.prompt
            lens[j] = plens[j]
        ids[len(group):, 0] = 1          # padding rows (length 1)
        new = max(r.max_new_tokens for r in group)
        eng.generate(ids, new, seq_lens=lens)
        tb = clock()
        for r in group:
            ttfts.append(tb - (t0 + r.arrival_s))
            useful_tokens += r.max_new_tokens   # the rest is padding
    elapsed = clock() - t0
    return {
        "finished": len(reqs),
        "generated_tokens": useful_tokens,
        "elapsed_s": round(elapsed, 4),
        "tok_s": round(useful_tokens / max(elapsed, 1e-9), 2),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
    }
