"""Ring-buffer slow-query log.

Role of the reference's slow-request logging (`quickwit-serve` request
logging + `rate_limited_tracing`): queries whose wall time exceeds a
configurable threshold — or that were shed / timed out — retain their full
execution profile in a bounded in-memory ring buffer, inspectable at
`/api/v1/developer/slowlog` and dumped by the soak test. FIFO eviction:
the buffer holds the most recent `capacity` slow queries.

Arming: the threshold comes from the constructor or the
`QW_SLOWLOG_THRESHOLD_MS` environment variable. While armed, the root
searcher profiles EVERY query (the profile is cheap; capture must not
require re-running the slow query with `"profile": true`). Unarmed — the
default — nothing is allocated.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Optional

from .metrics import SEARCH_SLOWLOG_RECORDED_TOTAL


def _env_threshold_ms() -> Optional[float]:
    raw = os.environ.get("QW_SLOWLOG_THRESHOLD_MS")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class SlowQueryLog:
    """Thread-safe FIFO ring buffer of slow-query profile entries."""

    def __init__(self, capacity: int = 64,
                 threshold_ms: Optional[float] = None):
        self.capacity = capacity
        self._threshold_ms = threshold_ms
        self._entries: deque[dict[str, Any]] = deque(maxlen=capacity)
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    @property
    def threshold_ms(self) -> Optional[float]:
        return self._threshold_ms if self._threshold_ms is not None \
            else _env_threshold_ms()

    def configure(self, threshold_ms: Optional[float]) -> None:
        self._threshold_ms = threshold_ms

    @property
    def armed(self) -> bool:
        return self.threshold_ms is not None

    def should_capture(self, elapsed_ms: float, timed_out: bool) -> bool:
        """Shed/timed-out queries are always slowlog-worthy when armed —
        they are the queries whose waterfall matters most."""
        threshold = self.threshold_ms
        if threshold is None:
            return False
        return timed_out or elapsed_ms >= threshold

    def record(self, entry: dict[str, Any]) -> None:
        entry = dict(entry)
        entry.setdefault("recorded_at", time.time())
        # automatic flight-recorder tail capture: the slow query's device
        # timeline (group formation, staging, dispatch, chunk boundaries,
        # readback) rides along with its profile waterfall
        query_id = entry.get("query_id")
        if query_id and "flight" not in entry:
            from .flight import FLIGHT
            entry["flight"] = FLIGHT.tail_for_query(query_id)
        with self._lock:
            self._entries.append(entry)
        SEARCH_SLOWLOG_RECORDED_TOTAL.inc()

    def entries(self) -> list[dict[str, Any]]:
        """Oldest → newest (deque evicts from the left when full)."""
        with self._lock:
            return [dict(e) for e in self._entries]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# Process-global instance: REST endpoint, root searcher and tests share it
# (per-node isolation is by query_id / index attribution, matching the
# process-global TRACER and METRICS).
SLOW_QUERY_LOG = SlowQueryLog()
