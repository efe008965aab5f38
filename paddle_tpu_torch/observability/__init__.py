from .numerics import NumericsMonitor
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       percentile, registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NumericsMonitor", "percentile", "registry"]
