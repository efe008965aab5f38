"""ServingEngine: the continuous-batching loop over the serving steps.

One engine owns one (model, PagedKVCache) pair and two steps: a
`ServeDecodeStep` over the full slot batch and a `ChunkPrefillStep`
whose chunk is padded to one of a few power-of-two buckets. Every
`step()`:

1. **admit**: the scheduler moves queue-head requests into free slots
   (capacity probed via `can_allocate` before commit);
2. **chunk-prefill**: at most `prefill_chunks_per_step` calls, each
   advancing the next chunk of up to `prefill_batch` resident prompts,
   so TTFT for new arrivals stays bounded while resident sequences keep
   streaming;
3. **decode**: `decode_burst` tokens for every decode-active slot
   (per-slot RNG streams keyed on (request seed, context length): a
   request's tokens never depend on its batch neighbours);
4. **stream/retire**: tokens push to handles (callback, poll or the
   `stream()` iterator); EOS or token-budget retirement frees pages
   immediately.

``kv_quant="int8"|"int4"`` stores the KV pages quantized (one fp32
scale a row; int4 packs two values a byte): 1.88x or 3.56x the tokens
of bf16 pools in the same memory at head_dim 64, with the dequant fused
into the paged-attention kernels.

``draft_model`` (a GPT of the target's vocab, or "self": the target's
draft heads) with ``spec_k`` makes step 3 a speculative dispatch
(`ServeSpecDecodeStep`): each running slot takes 1 to spec_k + 1
tokens, its page lookahead ``min(spec_k + 1, remaining, window)`` and
its ``caps`` bound keeping acceptance inside its reserved pages. A
separate draft gets paged pools of the target's geometry (never
quantized), which its page tables map: a slot's reserve, free or
preemption moves both. The ``serving.spec.*`` gauges count the usable
proposals only.

On a CUDA device with ``compiled=True`` (the default, as the
reference's) the decode burst (or the speculative dispatch) and each
chunk bucket's prefill replay CUDA graphs (`jit.graphs`), the port's
counterpart of the reference's compiled steps: `warmup` captures them,
`compile_counts` counts them. ``compiled=False``, and any engine on the
CPU, runs the steps eagerly.

Counterpart of paddle_tpu/serving/engine.py, with its constructor.
Refused at construction until their slices land: the online tuner, the
fleet roles (``prefill_only``, ``host_kv_ring``), the debug server, SLOs
and step-failure retries (ROADMAP queue A8). The options that only
matter with one of those (``tuner_kw``, ``recover_backoff_s``) and the
request tracer's (``trace``, ``trace_capacity``, the ``exemplar_*``
options; the spec dispatch's spans with them) are accepted and record
nothing; ``donate`` is accepted and does nothing (the steps update the
pools in place).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..framework.device import resolve_device
from ..inference.kv_cache import PagedKVCache
from ..jit.decode_step import (ChunkPrefillStep, ServeDecodeStep,
                               ServeSpecDecodeStep, _draft_of, check_draft,
                               draft_cache_like, split_state)
from ..observability import registry as _global_registry
from .metrics import ServingMetrics
from .request import FinishReason, Request, RequestHandle, RequestState
from .scheduler import RequestScheduler

__all__ = ["ServingEngine"]

# constructor options of the reference that the port does not have yet,
# and the queue item that brings each; off is None or a falsy value (for
# debug_port, where 0 means "any port", only None)
_NOT_PORTED = {
    "tuner": "ROADMAP queue A8 (the online tuner)",
    "host_kv_ring": "ROADMAP queue A8 (the fleet)",
    "prefill_only": "ROADMAP queue A8 (the fleet)",
    "debug_port": "ROADMAP queue A8 (observability)",
    "slos": "ROADMAP queue A8 (observability)",
    "recover_retries": "ROADMAP queue A8 (the fleet)",
}


class ServingEngine:
    def __init__(self, model, max_slots=8, max_len=256, page_size=16,
                 num_pages=None, chunk_size=64,
                 prefill_chunks_per_step=1, prefill_batch=4,
                 decode_burst=1, do_sample=False, top_k=0, top_p=1.0,
                 temperature=1.0, compiled=True, cache_dtype=None,
                 kv_quant=None, draft_model=None, spec_k=4,
                 donate=True, admit_watermark="auto",
                 clock=time.perf_counter,
                 trace=True, trace_capacity=256, exemplar_capacity=32,
                 exemplar_quantile=99.0, exemplar_min_samples=32,
                 slos=(), debug_port=None, tuner=False, tuner_kw=None,
                 prefill_only=False, host_kv_ring=None,
                 recover_retries=0, recover_backoff_s=0.05, device=None):
        later = dict(tuner=tuner,
                     host_kv_ring=host_kv_ring, prefill_only=prefill_only,
                     debug_port=debug_port, slos=slos,
                     recover_retries=recover_retries)
        for name, value in later.items():
            if value is not None and (name == "debug_port" or value):
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: "
                    f"{_NOT_PORTED[name]}")
        # accepted; they matter only with a refused option or the tracer
        del (donate, trace, trace_capacity, exemplar_capacity,
             exemplar_quantile, exemplar_min_samples, tuner_kw,
             recover_backoff_s)
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device != self.device:
            raise ValueError(f"the model lives on {param.device}, the "
                             f"engine on {self.device}")
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len={max_len} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        if kv_quant not in (None, "int8", "int4"):
            raise ValueError(f"unknown KV quant mode {kv_quant!r}")
        self.kv_quant = kv_quant
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.chunk_size = int(chunk_size)
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        # one chunk-prefill call advances up to this many prompts (fixed
        # batch dim, padding rows routed to the trash page)
        self.prefill_batch = max(1, min(int(prefill_batch),
                                        self.max_slots))
        # decode_burst > 1 runs that many decode steps per call: one
        # host sync per k tokens. Tokens a request samples past its
        # EOS/budget inside a burst are discarded.
        self.decode_burst = max(1, int(decode_burst))
        self.do_sample = bool(do_sample)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        self.compiled = bool(compiled)
        self.clock = clock
        self._cache_dtype = cache_dtype or torch.float32
        self.pages_per_seq = -(-self.max_len // self.page_size)
        # full provisioning by default; pass a smaller pool to
        # oversubscribe (preemption reclaims pages under pressure)
        self.num_pages = int(num_pages or
                             1 + self.max_slots * self.pages_per_seq)
        self.draft_model = _draft_of(model, draft_model)
        self.spec_k = int(spec_k)
        self.cache = self._make_cache()
        self.draft_cache = None
        if self.draft_model is not None:
            check_draft(model, self.draft_model, self.spec_k, self.device)
            self.draft_cache = self._make_draft_cache()
        self.metrics = ServingMetrics(clock=clock)
        self._register_mem_gauges()
        self.scheduler = RequestScheduler(
            self.cache, self.metrics, admit_watermark=admit_watermark)
        # the "auto" admission watermark keeps one dispatch's growth a slot
        self.scheduler.token_lookahead = (
            self.spec_k + 1 if self.draft_model is not None
            else self.decode_burst)
        self.prefill_step = ChunkPrefillStep(self)
        self.decode_step = ServeDecodeStep(self)
        self.spec_step = (ServeSpecDecodeStep(self)
                          if self.draft_model is not None else None)
        bkts, b = [], 8
        while b < self.chunk_size:
            bkts.append(b)
            b *= 2
        self.chunk_buckets = tuple(bkts) + (self.chunk_size,)
        self.last_warmup_ms = None
        self._warmup_report = {}
        self._buffers = self._split_buffers()
        # per-slot host mirrors refreshed every step
        self._tokens = np.zeros((self.max_slots,), np.int32)
        self._seeds = np.zeros((self.max_slots,), np.uint32)
        self._rid = 0
        # the deadline sweep runs only once a deadline request exists
        self._has_deadlines = False

    def _make_cache(self):
        cfg = self.model.config
        nh = cfg.num_attention_heads
        return PagedKVCache(
            cfg.num_layers, nh, cfg.hidden_size // nh,
            num_pages=self.num_pages, page_size=self.page_size,
            max_slots=self.max_slots, pages_per_seq=self.pages_per_seq,
            dtype=self._cache_dtype, quant=self.kv_quant, device=self.device)

    def _make_draft_cache(self):
        """The draft's pools over the target's slots and pages (None for a
        self-draft)."""
        if getattr(self.draft_model, "is_self_draft", False):
            return None
        return draft_cache_like(self)

    def _split_buffers(self):
        return split_state("paged", self.cache.state())[0]

    # -- client surface ---------------------------------------------------
    def submit(self, prompt, max_new_tokens, priority=0,
               eos_token_id=None, seed=None, on_token=None, rid=None,
               deadline_s=None) -> RequestHandle:
        """Queue a request; returns a streaming handle immediately.
        Tokens arrive as the engine steps (`step()`/`run()`/`stream()`).
        ``seed`` (default: the request id) keys its sampling stream.
        ``rid`` overrides the engine-local request id (later ids continue
        above it). ``deadline_s`` is a wall budget from submit: a request
        still unfinished when it expires retires with finish reason
        ``deadline_exceeded`` (pages freed) at the next step."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.size) + int(max_new_tokens)
        if total > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds the engine max_len {self.max_len}")
        if self.cache.pages_needed(total) > self.num_pages - 1:
            raise ValueError(
                f"request needs {self.cache.pages_needed(total)} pages "
                f"but the pool only has {self.num_pages - 1}")
        if rid is None:
            rid = self._rid
            self._rid += 1
        else:
            rid = int(rid)
            self._rid = max(self._rid, rid + 1)
        req = Request(rid, prompt, int(max_new_tokens),
                      priority=int(priority), eos_token_id=eos_token_id,
                      seed=int(seed) if seed is not None else rid,
                      deadline_s=(float(deadline_s)
                                  if deadline_s is not None else None))
        handle = RequestHandle(req, on_token=on_token)
        handle.arrival_seq = rid
        handle.submit_time = self.clock()
        if req.deadline_s is not None:
            handle.deadline = handle.submit_time + req.deadline_s
            self._has_deadlines = True
        self.scheduler.enqueue(handle)
        self.metrics.on_submit()
        return handle

    def step(self) -> bool:
        """One scheduler iteration: admit, <=N prefill chunks, one
        decode call for all running sequences. Returns False when
        idle. A failing step requeues every resident request on a fresh
        cache before the error propagates."""
        sched = self.scheduler
        worked = False
        try:
            if self._has_deadlines:
                self._expire_deadlines()
            for h in sched.admit():
                # full-width uint32: distinct seeds stay distinct streams
                self._seeds[h.slot] = np.uint32(
                    h.request.seed & 0xFFFFFFFF)
            for _ in range(self.prefill_chunks_per_step):
                heads = sched.prefill_heads(self.prefill_batch)
                if not heads:
                    break
                self._run_prefill_chunk(heads)
                worked = True
            if sched.decode_slots():
                worked |= self._run_decode()
        except BaseException:
            self._recover()
            raise
        self.metrics.observe(len(sched.waiting), len(sched.running))
        return worked

    def run(self, max_steps=1_000_000):
        """Drive the loop until every submitted request finished."""
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"serving loop did not drain in {max_steps} steps")
        return self.metrics.snapshot()

    def stream(self, handle: RequestHandle):
        """Generator yielding `handle`'s tokens as they are produced,
        stepping the engine (and every other resident request) along."""
        while True:
            yield from handle.new_tokens()
            if handle.done:
                return
            if not self.scheduler.has_work():
                raise RuntimeError("request is not resident and the "
                                   "engine is idle")
            self.step()

    # -- deadlines --------------------------------------------------------
    def _expire_deadlines(self):
        """Retire every request whose wall deadline has passed: waiting
        handles finish straight from the queue, resident ones through
        the normal retire path (pages freed at once). Runs at the top of
        each step, so a request overruns its deadline by at most one
        dispatch."""
        now = self.clock()
        sched = self.scheduler
        expired = 0
        for h in [h for h in sched.waiting
                  if h.deadline is not None and now > h.deadline]:
            sched.waiting.remove(h)
            h.state = RequestState.FINISHED
            h.finish_reason = FinishReason.DEADLINE_EXCEEDED
            h.finish_time = now
            self.metrics.on_finish(h)
            expired += 1
        for slot, h in [(s, h) for s, h in sched.running.items()
                        if h.deadline is not None and now > h.deadline]:
            sched.retire(slot, FinishReason.DEADLINE_EXCEEDED, now)
            expired += 1
        if expired:
            _global_registry().counter("serving.deadline_exceeded").inc(
                expired)

    # -- introspection and warm-up ------------------------------------------
    def compile_counts(self) -> dict:
        """Capture probe: decode stays at one graph across any
        admit/preempt/retire churn, prefill at most one per chunk
        bucket. Counts calls instead when the steps run eagerly (on the
        CPU, or ``compiled=False``), as the reference's eager steps
        count theirs. Under speculative decoding the decode keys are the
        spec step's (greedy: one graph; sampled: a draft and a verify
        graph)."""
        dstep = self.spec_step if self.spec_step is not None \
            else self.decode_step
        return {
            "decode_traces": dstep.trace_count,
            "decode_executables": dstep.cache_size(),
            "prefill_traces": self.prefill_step.trace_count,
            "prefill_executables": self.prefill_step.cache_size(),
            "chunk_buckets": list(self.chunk_buckets),
        }

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of this engine's metrics: counters
        and gauges, and TTFT and inter-token latency summaries with
        p50/p90/p99 quantiles."""
        return self.metrics.expose()

    def reset_metrics(self):
        """Fresh metrics (after a warm-up, say): a measured window starts
        from zero. Request tracing and SLOs are not ported (ROADMAP queue
        A8), so there is nothing else to clear."""
        self.metrics = ServingMetrics(clock=self.clock)
        self.scheduler.metrics = self.metrics
        self._register_mem_gauges()

    def warmup(self):
        """Capture every graph the serving loop can replay (the decode
        burst and one chunk-prefill graph per bucket) by serving one
        request per bucket, then reset the metrics, so a measured window
        never pays a capture. Buckets warm one at a time (a joint batch
        would only reach the largest). Eager steps (the CPU,
        ``compiled=False``) just run. `last_warmup_ms` and
        `warmup_report` record the wall time and the program count; there
        is no compile cache (ROADMAP queue A8), so its hits and misses
        are 0."""
        t0 = time.perf_counter()
        for b in self.chunk_buckets:
            plen = max(1, min(b, self.max_len - 2))
            self.submit(np.ones((plen,), np.int32), 2)
            self.run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_warmup_ms = (time.perf_counter() - t0) * 1e3
        self._warmup_report = {
            "warmup_ms": round(self.last_warmup_ms, 3),
            "programs": len(self.chunk_buckets) + 1,
            "cache_hits": 0, "cache_misses": 0,
        }
        self.reset_metrics()
        return self

    @property
    def warmup_report(self) -> dict:
        """The last `warmup()`'s wall time, program count and compile
        cache hits and misses."""
        return dict(self._warmup_report)

    def set_decode_burst(self, k):
        """Change the decode burst between engine steps. The burst is
        unrolled inside the decode graph, so this builds a fresh decode
        step, which captures anew on its first call. Refused under
        speculative decoding, whose dispatch ``spec_k`` shapes."""
        k = max(1, int(k))
        if k != self.decode_burst:
            if self.spec_step is not None:
                raise ValueError(
                    "decode_burst is unused under speculative decoding "
                    "(spec_k owns the decode program); tune spec_k at "
                    "construction")
            self.decode_burst = k
            self.decode_step = ServeDecodeStep(self)
            self.scheduler.token_lookahead = k
        return self

    def _pool_stats_cached(self, ttl_s=0.2):
        """One `pool_stats()` walk shared by the gauges of one scrape;
        the serving loop never reads it. Wall-clock TTL on purpose: the
        injectable ``clock`` may be frozen in tests."""
        now = time.monotonic()
        cached = self._pool_stats_memo
        if cached is None or now - cached[0] > ttl_s:
            cached = (now, self.cache.pool_stats())
            self._pool_stats_memo = cached
        return cached[1]

    def _register_mem_gauges(self):
        """The page pool's occupancy and fragmentation as lazy gauges,
        read through ``self`` so a recovered engine's new cache stays
        covered."""
        self._pool_stats_memo = None
        reg = self.metrics.registry
        reg.gauge("serving.kv.free_pages").set_fn(
            lambda: self.cache.free_page_count)
        for stat in ("used_pages", "occupancy", "fragmentation",
                     "max_contiguous_free"):
            reg.gauge(f"serving.kv.{stat}").set_fn(
                (lambda s: lambda: self._pool_stats_cached()[s])(stat))

    # -- step mechanics ---------------------------------------------------
    def _meta(self):
        c = self.cache
        return {"page_tables": c.page_tables, "seq_lens": c.seq_lens,
                "active": c.active}

    def _commit(self, buffers, meta):
        self._buffers = buffers
        self.cache.load_state({**buffers, **meta})

    def _chunk_bucket(self, n):
        for b in self.chunk_buckets:
            if b >= n:
                return b
        return self.chunk_buckets[-1]

    def _run_prefill_chunk(self, heads: list):
        """One call advances the next chunk of up to `prefill_batch`
        prompts. Rows beyond `len(heads)` are padding: their slot id is
        max_slots (out of range: the seq_lens scatter drops it, the
        page-table gather clamps it) and their zero-length chunk routes
        every write to the trash page."""
        B = self.prefill_batch
        heads = heads[:B]
        chunks = [h.pending[h.prefill_pos:h.prefill_pos + self.chunk_size]
                  for h in heads]
        bucket = self._chunk_bucket(max(len(c) for c in chunks))
        ids = np.zeros((B, bucket), np.int32)
        slot_ids = np.full((B,), self.max_slots, np.int32)
        start = np.zeros((B,), np.int32)
        lens_new = np.zeros((B,), np.int32)
        seeds = np.zeros((B,), np.uint32)
        for j, (h, chunk) in enumerate(zip(heads, chunks)):
            ids[j, :len(chunk)] = chunk
            slot_ids[j] = h.slot
            start[j] = h.prefill_pos
            lens_new[j] = h.prefill_pos + len(chunk)
            seeds[j] = self._seeds[h.slot]
        ids_next, _logits, buffers, meta = self.prefill_step(
            self._buffers, self._meta(), ids, slot_ids, start, lens_new,
            seeds)
        self._commit(buffers, meta)
        tok = None
        for j, (h, chunk) in enumerate(zip(heads, chunks)):
            self.metrics.prefill_chunks += 1
            h.prefill_pos += len(chunk)
            if h.prefill_pos < len(h.pending):
                continue
            # prompt fully cached: the sampled token is the request's
            # next real token (its first on a fresh admission -> TTFT)
            if tok is None:
                tok = ids_next.cpu().numpy()
            self.cache.set_active(h.slot, True)
            h.state = RequestState.RUNNING
            token = int(tok[j])
            self._tokens[h.slot] = token
            self._emit(h, token)

    def _live_decode_slots(self, max_ahead):
        """The running slots one decode dispatch advances, highest
        priority first so page pressure lands on the lowest, and each
        one's page lookahead: ``min(max_ahead, remaining budget,
        window)``. Tokens sampled past the budget are discarded and their
        writes land on the trash page, so no real pages are reserved for
        them. Returns (live, {slot: lookahead})."""
        sched = self.scheduler
        order = sorted(sched.decode_slots(),
                       key=lambda s: sched._key(sched.running[s]))
        live, ahead = [], {}
        for slot in order:
            h = sched.running.get(slot)
            if h is None or h.state is not RequestState.RUNNING:
                continue   # preempted as a victim earlier in this loop
            remaining = h.request.max_new_tokens - len(h.output_tokens)
            a = max(1, min(max_ahead, remaining,
                           self.max_len - sched._context_len(h)))
            if sched.ensure_token_capacity(slot, lookahead=a):
                live.append(slot)
                ahead[slot] = a
        # a slot approved early can still be sacrificed to a later
        # slot's reservation: keep only the survivors
        live = [s for s in live
                if sched.running.get(s) is not None
                and sched.running[s].state is RequestState.RUNNING]
        return live, ahead

    def _run_decode(self) -> bool:
        if self.spec_step is not None:
            return self._run_spec_decode()
        sched = self.scheduler
        # the burst length is uniform, the page lookahead per slot
        k = self.decode_burst
        live, _ = self._live_decode_slots(k)
        if not live:
            return False
        out, _logits, buffers, meta = self.decode_step(
            self._buffers, self._meta(), self._tokens, self._seeds)
        self._commit(buffers, meta)
        # one host sync per burst: [k, b] sampled ids
        step_tokens = out.cpu().numpy()
        self.metrics.decode_steps += k
        for tok in step_tokens:
            for slot in live:
                handle = sched.running.get(slot)
                if handle is None or handle.state is not RequestState.RUNNING:
                    continue   # retired earlier in this burst
                token = int(tok[slot])
                self._tokens[slot] = token
                self._emit(handle, token)
        return True

    def _run_spec_decode(self) -> bool:
        """One speculative dispatch: each running slot takes 1 to spec_k
        + 1 tokens. Its page lookahead is the worst case, ``min(spec_k +
        1, remaining, window)``, and its cap (context + lookahead) keeps
        acceptance inside the pages it holds. The pre-dispatch lengths
        and the caps come from the scheduler's bookkeeping (a resident
        slot's context length, 0 for a free slot; a slot that does not
        take part caps at its length: no yield), so the one host read is
        the tokens and counts together."""
        sched = self.scheduler
        live, ahead = self._live_decode_slots(self.spec_k + 1)
        if not live:
            return False
        positions = np.zeros((self.max_slots,), np.int32)
        for slot, h in sched.running.items():
            positions[slot] = sched._context_len(h)
        caps = positions.copy()
        for slot in live:
            caps[slot] += ahead[slot]
        out, counts, _logits, buffers, meta = self.spec_step(
            self._buffers, self._meta(), self._tokens, self._seeds, caps,
            positions=positions)
        self._commit(buffers, meta)
        host = torch.cat([out, counts[:, None]], 1).cpu().numpy()
        self.metrics.decode_steps += 1
        # the proposals a slot could use (ahead - 1, not spec_k): a
        # request's last dispatch may have room for fewer, which is not
        # a rejection
        for slot in live:
            self.metrics.spec_dispatches += 1
            self.metrics.spec_proposed += max(ahead[slot] - 1, 0)
            self.metrics.spec_accepted += max(int(host[slot, -1]) - 1, 0)
        for slot in live:
            handle = sched.running.get(slot)
            for t in range(int(host[slot, -1])):
                if handle is None or handle.state is not RequestState.RUNNING:
                    break   # retired earlier in this dispatch
                token = int(host[slot, t])
                self._tokens[slot] = token
                self.metrics.spec_emitted += 1
                self._emit(handle, token)
        return True

    def _emit(self, handle: RequestHandle, token: int):
        now = self.clock()
        handle._push_token(token, now)
        self.metrics.on_token()
        req = handle.request
        if req.eos_token_id is not None and token == req.eos_token_id:
            self.scheduler.retire(handle.slot, FinishReason.EOS, now)
        elif len(handle.output_tokens) >= req.max_new_tokens:
            self.scheduler.retire(handle.slot, FinishReason.LENGTH, now)

    def _recover(self):
        """A failed step may leave the pools half-written: requeue every
        resident request for resume and start from a fresh cache. The
        steps' graphs hold the old pools' addresses: they drop them when
        they next see the new cache, and capture anew."""
        self.scheduler.abort_all()
        self.cache = self._make_cache()
        self.scheduler.cache = self.cache
        self._buffers = self._split_buffers()
        if self.draft_model is not None:
            self.draft_cache = self._make_draft_cache()

    # -- introspection ----------------------------------------------------
    def leak_check(self) -> dict:
        """Post-drain invariant surface: every page and slot is back in
        the pool once no request is resident."""
        c = self.cache
        return {
            "free_pages": c.free_page_count,
            "total_pages": self.num_pages - 1,   # page 0 is trash
            "free_slots": c.free_slot_count,
            "total_slots": self.max_slots,
            "resident_slot_pages": len(c._slot_pages),
        }
