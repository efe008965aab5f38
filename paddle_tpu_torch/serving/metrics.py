"""Serving metrics: counters and per-request latency aggregation.

One ``ServingMetrics`` lives on the engine; the scheduler and the step
loop feed it events, and ``snapshot()`` renders the surface a run
records (queue depth, running/waiting, per-request TTFT and inter-token
latency percentiles, aggregate tok/s, preemption and page-reclaim
counters). Everything is host-side and O(1) per event; no device sync
is ever added for metrics. The latency samples are ring ``Histogram``s
on a per-engine ``MetricsRegistry``, and `expose` renders that registry
as Prometheus text, with the reference's metric names and types
(paddle_tpu/serving/metrics.py). The speculative-decoding counters
count the spec dispatches; the host KV ring's (ROADMAP queue A8) are
there and stay 0 until that slice lands.
"""
from __future__ import annotations

import time

from ..observability import MetricsRegistry, percentile

__all__ = ["ServingMetrics", "percentile"]


class ServingMetrics:
    # int counters kept as plain attributes (the engine increments them
    # in place), published through lazy gauges
    _COUNTERS = ("submitted", "admitted", "resumed", "finished",
                 "preemptions", "evicted_pages", "prefill_chunks",
                 "decode_steps", "generated_tokens",
                 "spec_dispatches", "spec_proposed", "spec_accepted",
                 "spec_emitted", "kv_evictions", "kv_onloads")
    _GAUGES = ("queue_depth", "running")

    def __init__(self, clock=time.perf_counter, registry=None, slo=None):
        if slo is not None:
            raise NotImplementedError(
                "SLO tracking is not ported yet: ROADMAP queue A8 "
                "(observability)")
        self.clock = clock
        self.start_time = clock()
        self.submitted = 0
        self.admitted = 0
        self.resumed = 0          # re-admissions of preempted requests
        self.finished = 0
        self.preemptions = 0
        self.evicted_pages = 0    # pages reclaimed by preemption
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.generated_tokens = 0
        self.spec_dispatches = self.spec_proposed = 0
        self.spec_accepted = self.spec_emitted = 0
        self.kv_evictions = self.kv_onloads = 0
        # gauges (refreshed every engine step)
        self.queue_depth = 0
        self.running = 0
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ttft_s = self.registry.histogram("serving.ttft_s",
                                              window=4096)
        self.itl_s = self.registry.histogram("serving.itl_s",
                                             window=8192)
        self.request_preemptions = self.registry.histogram(
            "serving.request_preemptions", window=4096)
        for name in self._COUNTERS + self._GAUGES:
            self.registry.gauge(f"serving.{name}").set_fn(
                (lambda n: lambda: getattr(self, n))(name))
        self.registry.gauge("serving.tok_s").set_fn(
            lambda: round(self.generated_tokens
                          / max(self.clock() - self.start_time, 1e-9),
                          2))
        self.registry.gauge("serving.spec.accept_rate").set_fn(
            lambda: round(self.spec_accepted
                          / max(self.spec_proposed, 1), 4))
        self.registry.gauge("serving.spec.tokens_per_dispatch").set_fn(
            lambda: round(self.spec_emitted
                          / max(self.spec_dispatches, 1), 4))

    # -- event feeds ------------------------------------------------------
    def on_submit(self):
        self.submitted += 1

    def on_admit(self, resumed: bool):
        self.admitted += 1
        if resumed:
            self.resumed += 1

    def on_preempt(self, pages_reclaimed: int):
        self.preemptions += 1
        self.evicted_pages += int(pages_reclaimed)

    def on_token(self):
        self.generated_tokens += 1

    def on_finish(self, handle):
        self.finished += 1
        if handle.ttft is not None:
            self.ttft_s.observe(handle.ttft)
        self.itl_s.extend(handle.inter_token_latencies)
        self.request_preemptions.observe(handle.preemptions)

    def observe(self, queue_depth: int, running: int):
        self.queue_depth = queue_depth
        self.running = running

    # -- surface ----------------------------------------------------------
    def expose(self) -> str:
        """Prometheus text exposition of this engine's registry."""
        return self.registry.expose()

    def snapshot(self) -> dict:
        elapsed = max(self.clock() - self.start_time, 1e-9)
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "resumed": self.resumed,
            "finished": self.finished,
            "preemptions": self.preemptions,
            "evicted_pages": self.evicted_pages,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "generated_tokens": self.generated_tokens,
            "spec_dispatches": self.spec_dispatches,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_accept_rate": round(
                self.spec_accepted / max(self.spec_proposed, 1), 4),
            "spec_tokens_per_dispatch": round(
                self.spec_emitted / max(self.spec_dispatches, 1), 4),
            "kv_evictions": self.kv_evictions,
            "kv_onloads": self.kv_onloads,
            "queue_depth": self.queue_depth,
            "running": self.running,
            "elapsed_s": round(elapsed, 4),
            "tok_s": round(self.generated_tokens / elapsed, 2),
            "ttft_p50_s": self.ttft_s.percentile(50),
            "ttft_p99_s": self.ttft_s.percentile(99),
            "itl_p50_s": self.itl_s.percentile(50),
            "itl_p99_s": self.itl_s.percentile(99),
        }
