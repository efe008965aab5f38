from .registry import Gauge, Histogram, MetricsRegistry, percentile

__all__ = ["Gauge", "Histogram", "MetricsRegistry", "percentile"]
