"""Metrics registry: lazy gauges and ring histograms.

The pieces of paddle_tpu/observability/registry.py that the serving
metrics need: ``percentile`` (the one nearest-rank implementation),
``Gauge`` (a callable evaluated only when the gauge is read),
``Histogram`` (O(1) ring buffer, percentiles computed on demand) and a
get-or-create ``MetricsRegistry``. Nothing here touches a tensor, so no
instrument adds a device sync to a step.
"""
from __future__ import annotations

import threading

__all__ = ["Gauge", "Histogram", "MetricsRegistry", "percentile"]


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a sequence, None if
    empty."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


class Gauge:
    """Lazy gauge: ``set_fn`` installs a callable that runs only when
    ``value`` is read (None if it raises)."""

    __slots__ = ("name", "_fn")

    def __init__(self, name):
        self.name = name
        self._fn = None

    def set_fn(self, fn):
        self._fn = fn

    @property
    def value(self):
        if self._fn is None:
            return None
        try:
            return self._fn()
        except Exception:
            return None


class Histogram:
    """Ring buffer of the last ``window`` samples plus a count over all
    of them; percentiles are taken over the ring."""

    __slots__ = ("name", "window", "_lock", "_ring", "_idx", "_count")

    def __init__(self, name, window=1024):
        self.name = name
        self.window = int(window)
        self._lock = threading.Lock()
        self._ring = [0.0] * self.window
        self._idx = 0
        self._count = 0

    def observe(self, v):
        with self._lock:
            self._ring[self._idx % self.window] = float(v)
            self._idx += 1
            self._count += 1

    def extend(self, values):
        for v in values:
            self.observe(v)

    def samples(self):
        """The ring window, oldest first."""
        with self._lock:
            if self._count <= self.window:
                return self._ring[:self._count]
            start = self._idx % self.window
            return self._ring[start:] + self._ring[:start]

    @property
    def count(self):
        return self._count

    def percentile(self, q):
        return percentile(self.samples(), q)


class MetricsRegistry:
    """Named instruments, get-or-create; one per serving engine."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}

    def _get(self, name, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, window=1024) -> Histogram:
        return self._get(name, Histogram, window=window)

    def get(self, name):
        with self._lock:
            return self._instruments.get(name)
