"""Training-numerics monitor: the port of
paddle_tpu/observability/numerics.py.

Each training step (`jit.FusedScanTrainStep`, `jit.TrainStep`) fills,
on the device, a small ``[rows, NFIELDS]`` fp32 stats block: one row a
layer chunk plus one ``outer`` row (embedding, ln_f, LM head) for the
fused-scan step, one row a parameter for `TrainStep`. It hands the
device tensor to a `NumericsMonitor`, which reads nothing back until a
logging or scrape boundary asks (``summary()``, the lazy ``numerics.*``
gauges).

Field layout (`assemble_stats` builds it; every field sums across rank
partials):

  F_GRAD_SQ      squared norm of the row's unscaled grads
  F_PARAM_SQ     squared norm of the row's parameters (masters where
                 they exist) before the update
  F_UPD_SQ       squared norm of the update ``new - old`` (0 on a step
                 the guard skipped)
  F_ACT_SQ       sum of squares of the chunk's output activations
  F_ACT_N        element count behind F_ACT_SQ (RMS = sqrt(sq / n))
  F_GRAD_BAD     1 where the row's grads are not finite
  F_ACT_ORIGIN   chunk input finite and output not: the forward origin of
                 a NaN (the output's finiteness judged from its fp32
                 square-sum, which NaN and inf reach)
  F_GRAD_ORIGIN  an explicit backward origin (reserved, 0: the host rule
                 takes the highest-index non-finite-grad chunk)

Host side, `NumericsMonitor`:

- ``on_step(stats)`` enqueues the device block and starts its
  non-blocking copy to pinned host memory: O(1), no wait;
- ``flush()`` performs the deferred readback, folds rank partials,
  derives per-row grad and parameter norms, update ratios ``‖Δw‖ / ‖w‖``
  and activation RMS, and runs NaN provenance (a non-finite step is
  attributed to its first offending chunk: activation origin, else
  backward origin, else the highest-index chunk with non-finite grads)
  and an EWMA z-score spike detector on the per-row grad norms;
- ``summary``, ``latest_rows``, ``history``, ``provenance``,
  ``anomalies`` and ``payload`` read the result.

Not ported yet (ROADMAP queue A8): the flight recorder's
``nan_provenance`` / ``numerics_anomaly`` events and dump, the
``/numericsz`` debug-server endpoint, and the ``numerics`` lane of the
step timeline. The monitor keeps the provenance record and the anomaly
ring they would publish.
"""
from __future__ import annotations

import collections
import math
import os
import threading
import weakref

import numpy as np
import torch

__all__ = [
    "NFIELDS", "F_GRAD_SQ", "F_PARAM_SQ", "F_UPD_SQ", "F_ACT_SQ",
    "F_ACT_N", "F_GRAD_BAD", "F_ACT_ORIGIN", "F_GRAD_ORIGIN",
    "NumericsMonitor", "assemble_stats", "outer_row", "monitor_enabled",
    "chunk_of_layer",
]

(F_GRAD_SQ, F_PARAM_SQ, F_UPD_SQ, F_ACT_SQ, F_ACT_N, F_GRAD_BAD,
 F_ACT_ORIGIN, F_GRAD_ORIGIN) = range(8)
NFIELDS = 8


def monitor_enabled() -> bool:
    """The default: on, unless ``FLAGS_numerics_monitor`` is off or the
    telemetry kill-switch ``PADDLE_TPU_TELEMETRY=0`` is set (read from
    the environment, as the reference's ``sentinel.enabled`` reads
    it)."""
    if os.environ.get("PADDLE_TPU_TELEMETRY", "1") == "0":
        return False
    from ..utils.flags import get_flag

    return bool(get_flag("FLAGS_numerics_monitor"))


def chunk_of_layer(layer, layer_chunk=1) -> int:
    """Logical layer index -> stats row (the chunk that owns it)."""
    return int(layer) // int(layer_chunk)


# ---------------------------------------------------------------------------
# device-side assembly (called inside the steps)
# ---------------------------------------------------------------------------

def assemble_stats(grad_sq, param_sq, upd_sq, act_sq, act_n, grad_bad,
                   act_origin, grad_origin, outer=None):
    """Stack per-chunk ``[C]`` fp32 columns (field order above; None is
    zeros) into the ``[C(+1), NFIELDS]`` block; ``outer`` is the optional
    trailing ``[NFIELDS]`` row."""
    cols = [grad_sq, param_sq, upd_sq, act_sq, act_n, grad_bad,
            act_origin, grad_origin]
    ref = next((c for c in cols if isinstance(c, torch.Tensor)
                and c.dim() == 1), None)
    if ref is None:
        raise ValueError("at least one per-chunk column is required")
    z = torch.zeros(ref.shape[0], dtype=torch.float32, device=ref.device)
    block = torch.stack([z if c is None else c.to(torch.float32)
                         for c in cols], dim=1)
    if outer is not None:
        block = torch.cat([block, outer.to(torch.float32)[None]], dim=0)
    return block


def outer_row(grad_sq, param_sq, upd_sq, grad_bad):
    """The trailing ``outer`` row (embedding / ln_f / head): device
    scalars; no scanned activation and no backward origin, so those
    fields stay 0."""
    z = torch.zeros((), dtype=torch.float32, device=grad_sq.device)
    return torch.stack([t.to(torch.float32) for t in
                        (grad_sq, param_sq, upd_sq, z, z, grad_bad, z, z)])


# ---------------------------------------------------------------------------
# the host-side monitor
# ---------------------------------------------------------------------------

_monitors_lock = threading.Lock()
_live_monitor_ref = None      # the most recently stepped monitor
_gauges_registered = False


def _live_monitor():
    ref = _live_monitor_ref
    return ref() if ref is not None else None


def _register_gauges():
    """The process-global lazy ``numerics.*`` gauges over the most
    recently stepped monitor, evaluated only when read, so the readback
    happens at the logging boundary."""
    global _gauges_registered
    with _monitors_lock:
        if _gauges_registered:
            return
        _gauges_registered = True
    from .registry import registry

    reg = registry()

    def field(name):
        def get():
            m = _live_monitor()
            return None if m is None else m.summary().get(name)
        return get

    reg.gauge("numerics.global_grad_norm").set_fn(field("grad_norm"))
    for name in ("update_ratio_max", "act_rms_max", "finite_frac",
                 "first_bad_chunk"):
        reg.gauge(f"numerics.{name}").set_fn(field(name))


class NumericsMonitor:
    """Deferred-readback consumer of one step's stats blocks.

    Args:
      name: label (the step's class name).
      rows: stats rows (layer chunks + the outer row, or parameters).
      row_labels: optional per-row labels.
      ring: bounded per-row history retention (steps).
      ewma_alpha / warmup / z_threshold: the spike detector: the z-score
        of each row's grad norm against its EWMA mean and variance, off
        until ``warmup`` finite steps have been folded.
    """

    def __init__(self, name, rows, row_labels=None, ring=64,
                 ewma_alpha=0.1, warmup=10, z_threshold=8.0,
                 registry=None):
        self.name = name
        self.rows = int(rows)
        self.row_labels = (list(row_labels) if row_labels is not None
                           else [f"chunk{i}" for i in range(rows)])
        self._lock = threading.Lock()          # the queue and counters
        # serialises _ingest across threads; re-entrant, as a gauge read
        # during an ingest flushes this monitor again
        self._flush_lock = threading.RLock()
        self._depth = max(int(ring), 8)     # blocks queued before a fold
        self._pending = collections.deque()
        self._ring = collections.deque(maxlen=int(ring))
        self._bad_steps = 0
        self._auto_step = 0
        self._steps_seen = 0
        self._latest = None
        self._provenance = None
        self._anomalies = collections.deque(maxlen=32)
        self._ewma_alpha = float(ewma_alpha)
        self._warmup = int(warmup)
        self._z_threshold = float(z_threshold)
        self._ewma_n = 0
        self._ewma_mean = np.zeros(self.rows)
        self._ewma_var = np.zeros(self.rows)
        from .registry import registry as _reg

        self._registry = registry if registry is not None else _reg()

    # -- hot path --------------------------------------------------------
    def on_step(self, stats, step=None):
        """Enqueue one step's block and start its copy to the host; never
        waits for it. Past a whole ring depth with no boundary, the oldest
        blocks whose copies have landed are folded instead of dropped, so
        a bad step cannot age out unseen; one still in flight stays queued
        (the queue then runs past its depth until the card catches up)."""
        global _live_monitor_ref
        staged = self._stage(stats)
        with self._lock:
            if step is None:
                step = self._auto_step
            self._auto_step = int(step) + 1
            self._pending.append((int(step), staged))
            full = len(self._pending) > self._depth
        if full:
            with self._flush_lock:
                with self._lock:
                    ready = []
                    while (len(self._pending) > self._depth
                           and self._landed(self._pending[0][1])):
                        ready.append(self._pending.popleft())
                for old_step, old in ready:
                    self._ingest(old_step, self._fold(old))
        _live_monitor_ref = weakref.ref(self)
        _register_gauges()

    # -- the deferred readback -------------------------------------------
    @staticmethod
    def _stage(stats):
        """Start the copy of a block to the host: ``(host copy, event)``.
        A CUDA block goes to pinned memory by a non-blocking copy on the
        current stream, with an event recorded after it, so nothing waits
        for the step in flight; a host block is copied at once (event
        None)."""
        if isinstance(stats, torch.Tensor):
            stats = stats.detach()
            if stats.is_cuda:
                host = torch.empty(stats.shape, dtype=stats.dtype,
                                   pin_memory=True)
                host.copy_(stats, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(stats.device))
                return host, event
            host = np.empty(tuple(stats.shape), np.float64)
            torch.from_numpy(host).copy_(stats)
            return host, None
        return np.array(stats, dtype=np.float64), None

    @staticmethod
    def _landed(staged):
        """Whether a staged block's copy has finished (never waits)."""
        return staged[1] is None or staged[1].query()

    @staticmethod
    def _fold(staged):
        """Staged block -> host ``[rows, NFIELDS]`` float64: leading
        rank-partial axes sum away. Waits for the copy (a boundary)."""
        host, event = staged
        if event is not None:
            event.synchronize()
            host = host.numpy()
        arr = np.asarray(host, dtype=np.float64)
        while arr.ndim > 2:
            arr = arr.sum(axis=0)
        return arr

    def flush(self):
        """Fold every pending block (the one readback boundary), derive,
        run provenance and spike detection; the latest summary (None
        before any step)."""
        with self._flush_lock:
            with self._lock:
                pending = list(self._pending)
                self._pending.clear()
            for step, staged in pending:
                self._ingest(step, self._fold(staged))
            return self._latest

    def _derive(self, rows):
        out = []
        for i in range(rows.shape[0]):
            r = rows[i]

            def root(v):
                return math.sqrt(max(float(v), 0.0)) if np.isfinite(v) \
                    else float("inf")

            grad_norm, param_norm, upd = (root(r[F_GRAD_SQ]),
                                          root(r[F_PARAM_SQ]),
                                          root(r[F_UPD_SQ]))
            act_n = float(r[F_ACT_N])
            act_rms = (math.sqrt(max(float(r[F_ACT_SQ]), 0.0) / act_n)
                       if act_n > 0 and np.isfinite(r[F_ACT_SQ]) else None)
            out.append({
                "row": i,
                "label": (self.row_labels[i]
                          if i < len(self.row_labels) else f"row{i}"),
                "grad_norm": grad_norm,
                "param_norm": param_norm,
                "update_ratio": (upd / param_norm) if param_norm > 0
                else 0.0,
                "act_rms": act_rms,
                "grad_finite": bool(float(r[F_GRAD_BAD]) == 0.0
                                    and np.isfinite(r[F_GRAD_SQ])),
                "act_origin": bool(float(r[F_ACT_ORIGIN]) > 0.0),
                "grad_origin": bool(float(r[F_GRAD_ORIGIN]) > 0.0),
            })
        return out

    @staticmethod
    def _first_bad(rows, derived):
        """Provenance: the forward origin wins (the earliest chunk whose
        input was finite and output not); else an explicit backward
        origin; else the highest-index chunk with non-finite grads (NaN
        cotangents flow toward layer 0, so the bad chunk nearest the
        loss is where it started)."""
        act = [d["row"] for d in derived if d["act_origin"]]
        if act:
            return min(act), "activation"
        grad = [d["row"] for d in derived if d["grad_origin"]]
        if grad:
            return max(grad), "grad"
        bad = [d["row"] for d in derived if not d["grad_finite"]]
        if bad:
            return max(bad), "grad_nonfinite"
        return None, None

    def _ingest(self, step, rows):
        derived = self._derive(rows)
        finite = bool(np.isfinite(rows).all()) and all(
            d["grad_finite"] for d in derived)
        self._steps_seen += 1
        if not finite:
            self._bad_steps += 1
        gn = math.sqrt(max(float(rows[:, F_GRAD_SQ].sum()), 0.0)) \
            if np.isfinite(rows[:, F_GRAD_SQ]).all() else float("inf")
        self._ring.append({"step": step, "finite": finite,
                           "grad_norm": gn, "rows": derived})
        first_bad = None
        if not finite:
            first_bad, origin = self._first_bad(rows, derived)
            self._provenance = {
                "step": step, "first_bad_chunk": first_bad,
                "origin": origin,
                "label": (self.row_labels[first_bad]
                          if first_bad is not None
                          and first_bad < len(self.row_labels) else None),
                "monitor": self.name}
        else:
            self._spike_check(step, derived)
        ratios = [d["update_ratio"] for d in derived]
        rmss = [d["act_rms"] for d in derived if d["act_rms"] is not None]
        self._latest = {
            "step": step, "finite": finite, "grad_norm": gn,
            "update_ratio_max": max(ratios) if ratios else None,
            "act_rms_max": max(rmss) if rmss else None,
            # cumulative: a run with one non-finite step stays marked
            "finite_frac": ((self._steps_seen - self._bad_steps)
                            / self._steps_seen),
            "first_bad_chunk": (-1 if finite or first_bad is None
                                else first_bad),
            "steps_seen": self._steps_seen,
        }

    # -- EWMA spike detector ---------------------------------------------
    def _spike_check(self, step, derived):
        x = np.asarray([d["grad_norm"] for d in derived])
        if self._ewma_n >= self._warmup:
            std = np.sqrt(np.maximum(self._ewma_var, 0.0)) \
                + 1e-12 + 1e-3 * np.abs(self._ewma_mean)
            z = (x - self._ewma_mean) / std
            for i in np.nonzero(z > self._z_threshold)[0]:
                self._anomalies.append({
                    "step": step, "chunk": int(i),
                    "label": (self.row_labels[i]
                              if i < len(self.row_labels) else f"row{i}"),
                    "grad_norm": float(x[i]),
                    "ewma_mean": float(self._ewma_mean[i]),
                    "z": float(z[i]), "monitor": self.name})
                self._registry.counter("numerics.anomaly.count").inc()
        a = self._ewma_alpha
        if self._ewma_n == 0:
            self._ewma_mean = x.astype(np.float64)
            self._ewma_var = np.zeros_like(self._ewma_mean)
        else:
            d = x - self._ewma_mean
            self._ewma_mean = self._ewma_mean + a * d
            self._ewma_var = (1 - a) * (self._ewma_var + a * d * d)
        self._ewma_n += 1

    # -- read surface ----------------------------------------------------
    def summary(self):
        """Flush + the latest global summary ({} before any step)."""
        return self.flush() or {}

    def latest_rows(self):
        """Flush + the latest per-row table ([] before any step)."""
        self.flush()
        return list(self._ring[-1]["rows"]) if self._ring else []

    def history(self):
        """The bounded ring of recent per-step entries (flushed)."""
        self.flush()
        return list(self._ring)

    def provenance(self):
        """The most recent NaN-provenance record (None when clean)."""
        self.flush()
        return self._provenance

    def anomalies(self):
        self.flush()
        return list(self._anomalies)

    def payload(self):
        """This monitor's JSON-able block (what the reference's
        ``/numericsz`` lists for it)."""
        s = self.summary()
        return {"name": self.name, "rows": self.rows,
                "summary": s, "per_chunk": self.latest_rows(),
                "provenance": self._provenance,
                "anomalies": list(self._anomalies),
                "ring_depth": len(self._ring)}
