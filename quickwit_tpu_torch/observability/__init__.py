from .metrics import Counter, MetricsRegistry, METRICS

__all__ = ["Counter", "MetricsRegistry", "METRICS"]
