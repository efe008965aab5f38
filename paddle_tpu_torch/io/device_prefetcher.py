"""Device-side input prefetching: the port of paddle_tpu/io/
device_prefetcher.py's ``DevicePrefetcher``, on CUDA streams.

A producer thread pulls host batches (numpy arrays or CPU tensors, in
nested lists, tuples and dicts; other leaves pass through) and stages
them on the device ahead of the consumer:

- each array leaf is copied into pinned host memory first. That copy is
  what makes a loader that reuses its host buffer safe: the batch the
  ring holds never aliases the loader's memory;
- its host-to-device copy runs on a side stream, and an event is
  recorded after it. The producer waits for the event by polling it (no
  host sync), so ``h2d_ms`` is the transfer's real time;
- the consumer makes its current stream wait on the event
  (``wait_event``: the device orders the step after the copy, the host
  does not wait) and calls ``record_stream`` on each tensor, so the
  allocator keeps a batch's memory until the step that reads it is done;
- at most ``depth`` batches are pulled from the loader ahead of the
  consumer (staged and not yet handed over), and a loader's exception is
  raised by the consumer's ``next()``.

On the CPU the same class runs without streams: the stage is a copy.
`get_stats` returns the reference's keys (``input_stall_ms``: how long
``next()`` waited for data, about 0 when the pipeline keeps up;
``h2d_ms``). ``process_local=True`` is the data-parallel form: the
loader yields only this rank's rows (a `DistributedBatchSampler`
loader) and each rank stages its own batches on its own device (default
the rank's, `distributed.env.get_device`, once the world is joined).
Staging one global batch across a mesh (``sharding``, ``mesh``,
``axis``) raises until ROADMAP A9b ports it.

    for x, y in DevicePrefetcher(batches(), depth=2):
        loss = step(x, y)
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..framework.device import resolve_device
from ..observability import registry as _obs_registry

__all__ = ["DevicePrefetcher"]

_SENTINEL = object()


def _tree_map(fn, obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


def _tree_leaves(obj, out):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _tree_leaves(o, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tree_leaves(v, out)
    else:
        out.append(obj)
    return out


class _Epoch:
    """One pass over the loader: its producer thread and the ring."""

    def __init__(self, prefetcher):
        self._pf = prefetcher
        self._q = queue.Queue()
        self._slots = threading.Semaphore(prefetcher.depth)
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(
            target=self._produce, name="DevicePrefetcher", daemon=True)
        self._thread.start()

    def _take_slot(self):
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.1):
                return True
        return False

    def _produce(self):
        pf = self._pf
        try:
            batches = iter(pf._loader)
            while self._take_slot():
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                t0 = time.perf_counter()
                with torch.profiler.record_function("DevicePrefetcher.h2d"):
                    staged, event = pf._stage(batch)
                    if event is not None:
                        while not event.query():
                            time.sleep(5e-5)
                pf._note_h2d((time.perf_counter() - t0) * 1e3)
                self._q.put((staged, event))
        except Exception as e:  # raised by the consumer's next()
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)


class DevicePrefetcher:
    """Stage host batches on ``device`` ahead of the consumer.

    Args:
      loader: any (re-)iterable of batches.
      depth: how many batches may be staged ahead of the consumer (2 is
        double buffering).
      device: where batches land; the CUDA card by default (a machine
        without one raises), ``"cpu"`` on request.
      to_tensor: accepted for the reference's signature; staged leaves
        are torch tensors either way.
      stats_window: how many per-step samples `get_stats` keeps.
    """

    def __init__(self, loader, depth=2, sharding=None, mesh=None, axis=None,
                 device=None, to_tensor=True, process_local=False,
                 stats_window=4096):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if sharding is not None or mesh is not None or axis is not None:
            raise NotImplementedError(
                "DevicePrefetcher(sharding=/mesh=/axis=) is not ported "
                "yet: ROADMAP A9b; with process_local=True each rank "
                "stages its own rows")
        if process_local and device is None:
            from ..distributed import env

            if env.is_initialized():
                device = env.get_device()
        self._loader = loader
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._stats_window = int(stats_window)
        self._epoch = None
        self._lock = threading.Lock()
        self.reset_stats()

    # -- staging ---------------------------------------------------------
    def _stage(self, batch):
        """(the batch on the device, the event after its copies or None
        on the CPU)."""
        if self._stream is None:
            return _tree_map(self._copy_leaf, batch), None
        with torch.cuda.stream(self._stream):
            staged = _tree_map(self._h2d_leaf, batch)
        event = torch.cuda.Event()
        event.record(self._stream)
        return staged, event

    @staticmethod
    def _host_tensor(leaf):
        if isinstance(leaf, (np.ndarray, np.generic)):
            return torch.from_numpy(np.asarray(leaf))
        if isinstance(leaf, torch.Tensor):
            return leaf
        return None

    def _copy_leaf(self, leaf):
        t = self._host_tensor(leaf)
        return leaf if t is None else t.to(self.device, copy=True)

    def _h2d_leaf(self, leaf):
        t = self._host_tensor(leaf)
        if t is None:
            return leaf
        if t.device.type != "cpu":
            return t.to(self.device, copy=True)
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True)

    # -- stats -----------------------------------------------------------
    def _note(self, samples, ms, what):
        with self._lock:
            samples.append(ms)
            if len(samples) > self._stats_window:
                del samples[: -self._stats_window]
            self._totals[what] += ms
            self._counts[what] += 1
        _obs_registry().histogram(f"input.{what}").observe(ms)

    def _note_h2d(self, ms):
        self._note(self._h2d_ms, ms, "h2d_ms")

    def _note_stall(self, ms):
        self._note(self._stall_ms, ms, "stall_ms")

    def reset_stats(self):
        with self._lock:
            self._stall_ms, self._h2d_ms = [], []
            self._totals = {"stall_ms": 0.0, "h2d_ms": 0.0}
            self._counts = {"stall_ms": 0, "h2d_ms": 0}

    def get_stats(self):
        """Per-step ``input_stall_ms`` / ``h2d_ms`` (the last
        ``stats_window`` steps) and their aggregates."""
        with self._lock:
            def agg(samples, what):
                total, count = self._totals[what], self._counts[what]
                return {"total": round(total, 3),
                        "mean": round(total / count, 4) if count else None,
                        "max": round(max(samples), 3) if samples else None,
                        "count": count}

            return {
                "depth": self.depth,
                "batches": self._counts["stall_ms"],
                "input_stall_ms": agg(self._stall_ms, "stall_ms"),
                "h2d_ms": agg(self._h2d_ms, "h2d_ms"),
                "per_step_input_stall_ms": [round(v, 4)
                                            for v in self._stall_ms],
                "per_step_h2d_ms": [round(v, 4) for v in self._h2d_ms],
            }

    # -- iteration -------------------------------------------------------
    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        # a fresh epoch when none is live; mid-epoch iter() continues
        if self._epoch is None:
            self._epoch = _Epoch(self)
        return self

    def __next__(self):
        ep = self._epoch
        if ep is None:
            raise StopIteration
        t0 = time.perf_counter()
        with torch.profiler.record_function("DevicePrefetcher.wait"):
            item = ep._q.get()
        if item is _SENTINEL:
            self._epoch = None
            ep._thread.join(timeout=10)
            if ep._err is not None:
                raise ep._err
            raise StopIteration
        staged, event = item
        ep._slots.release()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for leaf in _tree_leaves(staged, []):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(stream)
        self._note_stall((time.perf_counter() - t0) * 1e3)
        return staged

    def close(self):
        """Stop the producer (idempotent; also at GC). A producer blocked
        inside the loader's own ``next()`` finishes that pull first."""
        ep, self._epoch = self._epoch, None
        if ep is not None:
            ep.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
