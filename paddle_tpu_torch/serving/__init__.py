"""Continuous-batching serving tier over the paged KV cache.

* ``ServingEngine``: the loop that admits, chunk-prefills, decodes,
  streams and retires.
* ``RequestScheduler``: admission, preemption and retirement over the
  cache's slot and page bookkeeping.
* ``ServingMetrics``: queue depth, TTFT, inter-token latency, tok/s and
  preemption counters, and their Prometheus text.
* ``traffic``: synthetic Poisson traffic, served with real-time
  arrivals, and the static generate-and-wait baseline.
"""
from .engine import ServingEngine
from .metrics import ServingMetrics, percentile
from .request import (FinishReason, Request, RequestHandle,
                      RequestState)
from .scheduler import RequestScheduler

__all__ = ["ServingEngine", "RequestScheduler", "ServingMetrics",
           "Request", "RequestHandle", "RequestState", "FinishReason",
           "percentile"]
