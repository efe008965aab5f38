"""Metrics registry: counters, lazy gauges, ring histograms, and their
Prometheus text.

The port of paddle_tpu/observability/registry.py that the serving
metrics need: ``percentile`` (the one nearest-rank implementation),
``Counter``, ``Gauge`` (a callable evaluated only when the gauge is
read), ``Histogram`` (O(1) ring buffer with running count and
sum, percentiles computed on demand), a get-or-create
``MetricsRegistry`` with the reference's ``expose()`` (Prometheus text
0.0.4: counters and gauges as single samples, histograms as summaries
with the 0.5 / 0.9 / 0.99 quantiles, ``_sum`` and ``_count``), and the
process-global ``registry()``. Nothing here touches a tensor, so no
instrument adds a device sync to a step.
"""
from __future__ import annotations

import math
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "percentile", "registry"]


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a sequence, None if
    empty."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n=1.0):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


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
    """Ring buffer of the last ``window`` samples plus a count and a sum
    over all of them; percentiles are taken over the ring."""

    __slots__ = ("name", "window", "_lock", "_ring", "_idx", "_count",
                 "_sum")

    def __init__(self, name, window=1024):
        self.name = name
        self.window = int(window)
        self._lock = threading.Lock()
        self._ring = [0.0] * self.window
        self._idx = 0
        self._count = 0
        self._sum = 0.0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._ring[self._idx % self.window] = v
            self._idx += 1
            self._count += 1
            self._sum += v

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

    @property
    def total(self):
        return self._sum

    def percentile(self, q):
        return percentile(self.samples(), q)


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    """A valid Prometheus metric name: invalid characters become ``_``,
    a leading digit gets a ``_`` prefix."""
    n = _NAME_RE.sub("_", str(name)) or "_"
    return "_" + n if n[0].isdigit() else n


def _prom_value(v):
    """One sample value in the text format (``+Inf``, ``-Inf``, ``NaN``
    for non-finite and missing values)."""
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


class MetricsRegistry:
    """Named instruments, get-or-create; one per serving engine, and the
    process-global one of `registry`."""

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

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, window=1024) -> Histogram:
        return self._get(name, Histogram, window=window)

    def get(self, name):
        with self._lock:
            return self._instruments.get(name)

    def names(self, prefix=None):
        with self._lock:
            return sorted(n for n in self._instruments
                          if prefix is None or n.startswith(prefix))

    def expose(self, prefix=None) -> str:
        """Prometheus text exposition of the instruments (all, or those
        under ``prefix``), in name order."""
        lines, seen = [], set()
        for name in self.names(prefix):
            inst = self.get(name)
            pn = _prom_name(name)
            # two names may sanitize alike ("a.b", "a/b"): later ones get
            # a suffix, since duplicate samples break the format
            if pn in seen:
                k = 2
                while f"{pn}_{k}" in seen:
                    k += 1
                pn = f"{pn}_{k}"
            seen.add(pn)
            if isinstance(inst, Histogram):
                xs = inst.samples()
                lines.append(f"# TYPE {pn} summary")
                for q in (0.5, 0.9, 0.99):
                    lines.append(f'{pn}{{quantile="{q}"}} '
                                 f"{_prom_value(percentile(xs, q * 100))}")
                lines.append(f"{pn}_sum {_prom_value(inst.total)}")
                lines.append(f"{pn}_count {inst.count}")
            else:
                kind = "counter" if isinstance(inst, Counter) else "gauge"
                lines.append(f"# TYPE {pn} {kind}")
                lines.append(f"{pn} {_prom_value(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


_global_lock = threading.Lock()
_global_registry = None


def registry() -> MetricsRegistry:
    """The process-global registry (the serving engines count expired
    deadlines there)."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
        return _global_registry
