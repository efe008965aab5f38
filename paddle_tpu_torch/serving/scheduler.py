"""Admission / preemption / retirement policy over the paged KV cache.

The scheduler owns the host side of continuous batching: which request
gets a slot, which running sequence is sacrificed when the page pool
runs dry, and when a slot's pages go back to the pool. It never touches
device compute: it only rewrites the cache's host bookkeeping (slots,
page tables, active flags), which the steps read on their next call.

Policy:

* **Admission**: strict FIFO within priority (higher priority first,
  then arrival order; a resumed preempted request keeps its original
  arrival rank). Only the head of the queue is considered, so a small
  request never jumps a big one still waiting for pages. Admission
  probes capacity with `can_allocate` before committing, and keeps a
  watermark of free pages per decode-active sequence so an admission
  cannot instantly force a preemption.
* **Preemption**: when a decode step needs more pages and the pool is
  dry, the lowest-priority (then youngest-arrival) decode-active
  sequence is evicted: its pages return to the pool and the request
  re-queues for resume-by-re-prefill. Mid-prefill slots are never
  victims (their prompt pages were fully reserved at admission).
* **Retirement**: EOS / max_new_tokens frees the slot immediately.
"""
from __future__ import annotations

from .request import RequestHandle, RequestState

__all__ = ["RequestScheduler"]


class RequestScheduler:
    def __init__(self, cache, metrics, admit_watermark="auto"):
        self.cache = cache
        self.metrics = metrics
        self.waiting: list[RequestHandle] = []   # kept sorted (see _key)
        self.running: dict[int, RequestHandle] = {}   # slot -> handle
        self.admit_watermark = admit_watermark
        # tokens one decode dispatch may append per slot (the engine
        # sets it to decode_burst); the "auto" watermark scales with it
        self.token_lookahead = 1

    # -- queue ------------------------------------------------------------
    @staticmethod
    def _key(h: RequestHandle):
        """Service order: min() = next to serve (highest priority,
        oldest arrival); max() = next preemption victim."""
        return (-h.request.priority, h.arrival_seq)

    def enqueue(self, handle: RequestHandle):
        self.waiting.append(handle)
        self.waiting.sort(key=self._key)

    def decode_slots(self) -> list[int]:
        """Slots with decode-active (fully prefilled) sequences."""
        return [s for s, h in self.running.items()
                if h.state is RequestState.RUNNING]

    def prefill_heads(self, k: int) -> list[RequestHandle]:
        """Up to `k` oldest mid-prefill residents (one chunk-prefill
        call advances all of their prompts)."""
        cands = [h for h in self.running.values()
                 if h.state is RequestState.PREFILL]
        return sorted(cands, key=self._key)[:k]

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission --------------------------------------------------------
    def _watermark(self) -> int:
        if self.admit_watermark == "auto":
            # one dispatch can grow each decode-active sequence by
            # `token_lookahead` tokens: keep enough free pages that every
            # live slot can take its next dispatch without a preemption
            per_slot = -(-max(1, int(self.token_lookahead))
                         // self.cache.page_size)
            return len(self.decode_slots()) * per_slot
        return int(self.admit_watermark)

    def admit(self) -> list[RequestHandle]:
        """Admit from the head of the queue while capacity allows.
        Returns the handles admitted this call (slot + pages mapped for
        their full pending prompt, so prefill can never stall)."""
        cache = self.cache
        admitted = []
        while self.waiting:
            head = self.waiting[0]
            need_len = len(head.pending)
            fits = cache.can_allocate(need_len)
            if fits and (admitted or self.decode_slots()):
                # hold the head while admitting it would leave fewer free
                # pages than the watermark: it would force preemptions
                left = (cache.free_page_count
                        - cache.pages_needed(need_len))
                fits = left >= self._watermark()
            if not fits:
                break
            self.waiting.pop(0)
            slot = cache.allocate(need_len)
            cache.set_active(slot, False)   # decode joins after prefill
            head.slot = slot
            head.prefill_pos = 0
            head.state = RequestState.PREFILL
            self.running[slot] = head
            self.metrics.on_admit(resumed=head.preemptions > 0)
            admitted.append(head)
        return admitted

    # -- preemption -------------------------------------------------------
    def _victim(self, protect: int) -> int | None:
        """Most victim-eligible decode-active slot other than `protect`
        (mid-prefill slots are never victims)."""
        cands = [s for s in self.decode_slots() if s != protect]
        if not cands:
            return None
        return max(cands, key=lambda s: self._key(self.running[s]))

    def preempt(self, slot: int) -> RequestHandle:
        """Evict `slot`: pages to the pool, request back to the queue
        (keeping its arrival rank) for resume-by-re-prefill."""
        handle = self.running.pop(slot)
        pages = len(self.cache._slot_pages.get(slot, ()))
        self.cache.free(slot)
        handle._requeue_for_resume()
        self.enqueue(handle)
        self.metrics.on_preempt(pages_reclaimed=pages)
        return handle

    def ensure_token_capacity(self, slot: int, lookahead: int = 1
                              ) -> bool:
        """Guarantee `slot` can hold `lookahead` more tokens, preempting
        victims while the pool is dry. Returns False when `slot` itself
        had to be sacrificed (it was the lowest-priority sequence)."""
        cache = self.cache
        handle = self.running[slot]
        need = self._context_len(handle) + int(lookahead)
        while not cache.can_reserve(slot, need):
            victim = self._victim(protect=slot)
            if victim is None or (self._key(handle)
                                  > self._key(self.running[victim])):
                # every other candidate outranks this sequence (or none
                # exists): it sacrifices itself rather than evict a
                # higher-priority neighbour
                self.preempt(slot)
                return False
            self.preempt(victim)
        cache.reserve(slot, need)
        return True

    @staticmethod
    def _context_len(handle: RequestHandle) -> int:
        """Tokens currently cached for a resident handle. The last
        sampled token is not cached yet (the next decode step writes
        it)."""
        if handle.state is RequestState.PREFILL:
            return handle.prefill_pos
        return len(handle.request.prompt) + len(handle.output_tokens) - 1

    # -- retirement -------------------------------------------------------
    def retire(self, slot: int, reason, now: float) -> RequestHandle:
        handle = self.running.pop(slot)
        self.cache.free(slot)
        handle.slot = None
        handle.state = RequestState.FINISHED
        handle.finish_reason = reason
        handle.finish_time = now
        self.metrics.on_finish(handle)
        return handle

    def abort_all(self) -> list[RequestHandle]:
        """Recovery path (engine step failure): every resident request
        re-queues for resume; the caller rebuilds the cache."""
        return [self.preempt(slot) for slot in list(self.running)]
