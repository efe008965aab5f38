"""Request objects and per-request streaming handles.

A ``Request`` is what a client submits: prompt tokens, a token budget,
a priority and a sampling seed. The engine wraps it in a
``RequestHandle``, the live object the client polls or receives
callbacks on while the scheduler moves the request through

    WAITING -> PREFILL -> RUNNING -> FINISHED
                 ^           |
                 +-- (preempted: back to WAITING, pages freed) --+

Preemption is invisible in the output stream: the request re-prefills
its prompt plus everything it already generated, and the per-request
RNG stream (seed, context position) makes the resumed tokens match an
uninterrupted run wherever the chunk-prefill and decode paths give the
same logits.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "RequestHandle", "RequestState", "FinishReason"]


class RequestState(enum.Enum):
    WAITING = "waiting"      # queued (fresh, or preempted awaiting resume)
    PREFILL = "prefill"      # holds a slot; prompt chunks streaming in
    RUNNING = "running"      # decode-active: one token per engine step
    FINISHED = "finished"
    FAILED = "failed"


class FinishReason(enum.Enum):
    EOS = "eos"
    LENGTH = "length"        # max_new_tokens reached
    ABORTED = "aborted"
    DEADLINE_EXCEEDED = "deadline_exceeded"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # int32 [prompt_len]
    max_new_tokens: int
    priority: int = 0                   # higher = preempted later
    eos_token_id: int | None = None
    seed: int | None = None             # defaults to rid (engine)
    deadline_s: float | None = None     # wall budget from submit


class RequestHandle:
    """Client-side view of one in-flight request.

    Streaming: either pass ``on_token(handle, token)`` at submit, or
    poll ``new_tokens()`` (drains tokens appended since the last call),
    or iterate ``ServingEngine.stream(handle)``. Timing fields
    (``ttft``, ``inter_token_latencies``) fill in as tokens arrive.
    """

    def __init__(self, request: Request, on_token=None):
        self.request = request
        self.state = RequestState.WAITING
        self.finish_reason: FinishReason | None = None
        self.output_tokens: list[int] = []
        self.on_token = on_token
        # scheduler-side fields
        self.slot: int | None = None
        self.prefill_pos = 0            # tokens of `pending` already cached
        self.pending = np.asarray(request.prompt, np.int32)
        self.preemptions = 0
        self.arrival_seq: int | None = None   # FIFO tie-break, set by engine
        # timing
        self.submit_time: float | None = None
        self.first_token_time: float | None = None
        self.finish_time: float | None = None
        # absolute wall deadline, set by the engine at submit from
        # request.deadline_s
        self.deadline: float | None = None
        self._token_times: list[float] = []
        self._stream_cursor = 0

    # -- client surface ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.FAILED)

    @property
    def ttft(self) -> float | None:
        """Seconds from submit to the first generated token."""
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def inter_token_latencies(self) -> list[float]:
        t = self._token_times
        return [b - a for a, b in zip(t, t[1:])]

    def new_tokens(self) -> list[int]:
        """Tokens appended since the last call (streaming poll)."""
        out = self.output_tokens[self._stream_cursor:]
        self._stream_cursor = len(self.output_tokens)
        return out

    # -- engine-side ------------------------------------------------------
    def _push_token(self, token: int, now: float):
        self.output_tokens.append(int(token))
        self._token_times.append(now)
        if self.first_token_time is None:
            self.first_token_time = now
        if self.on_token is not None:
            self.on_token(self, int(token))

    def _requeue_for_resume(self):
        """Preempted: the next prefill replays prompt + everything
        generated so far; its final chunk then samples the next token of
        the stream (same context length => same RNG position => same
        token)."""
        self.pending = np.concatenate(
            [np.asarray(self.request.prompt, np.int32),
             np.asarray(self.output_tokens, np.int32)])
        self.prefill_pos = 0
        self.slot = None
        self.preemptions += 1
        self.state = RequestState.WAITING

    def __repr__(self):
        return (f"<RequestHandle rid={self.request.rid} "
                f"state={self.state.value} "
                f"tokens={len(self.output_tokens)}>")
