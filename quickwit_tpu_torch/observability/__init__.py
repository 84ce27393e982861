from .metrics import Counter, Gauge, Histogram, MetricsRegistry, METRICS

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "METRICS"]
