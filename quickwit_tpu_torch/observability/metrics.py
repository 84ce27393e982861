"""Prometheus-style metrics registry.

Role of the reference's `quickwit-metrics` macro registry
(`quickwit-metrics/src/lib.rs:44-343`): lazily-registered counters with
labels, exposed in Prometheus text format. The port registers only what its
modules bump: the predicate-cache counters below and the split cache's
counters (`storage/split_cache.py`). Gauges, histograms and the other
subsystems' counters come with the modules that use them.
"""

from __future__ import annotations

import threading


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or the exposition line is unparseable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, value in sorted(self._values.items()):
            lines.append(f"{self.name}{_format_labels(key)} {value:g}")
        return lines


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, Counter] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = Counter(name, help_text)
                self._metrics[name] = metric
            return metric

    def expose_text(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            lines.extend(metric.expose())
        return "\n".join(lines) + "\n"


METRICS = MetricsRegistry()

# Term-absence negative cache (search/predicate_cache.py).
PREDICATE_CACHE_HITS_TOTAL = METRICS.counter(
    "qw_predicate_cache_hits_total",
    "Splits proven empty by the term-absence negative cache")
PREDICATE_CACHE_MISSES_TOTAL = METRICS.counter(
    "qw_predicate_cache_misses_total",
    "Negative-cache consults that could not prove the split empty")
PREDICATE_CACHE_EVICTED_BYTES_TOTAL = METRICS.counter(
    "qw_predicate_cache_evicted_bytes_total",
    "Absence-proof bytes evicted from the predicate cache under its "
    "byte/entry bounds")
