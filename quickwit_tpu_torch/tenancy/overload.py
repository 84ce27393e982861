"""Adaptive overload control: shed lowest-priority-first.

The serving stack already sheds *expired* queries at checkpoints
(admission, batcher dispatch, group boundaries). That protects each query's
deadline but not the system: under sustained overload every tenant's queue
wait degrades together until everything is shed at random by expiry.

`OverloadController` watches the queue waits the stack already measures
(admission wait, batcher queue wait — the same signals behind
`qw_search_batcher_queue_wait_seconds`) as an EWMA. When the smoothed wait
breaches the target, the established checkpoints start rejecting the
lowest priority class up front with a typed, retryable error instead of
letting it burn queue slots it will lose anyway; if waits keep climbing a
second rung sheds the standard class too. The top class is never shed by
the controller — its protection is the point of having classes.

Disabled by default (`enabled=False`): with the controller off,
`should_shed` is constant-false and the serving path is byte-for-byte the
pre-tenancy behavior.
"""

from __future__ import annotations


from ..common.clock import monotonic
from .context import MAX_PRIORITY
from ..common import sync


class OverloadShed(Exception):
    """A query was rejected up front by the overload controller. Maps to
    HTTP 429 with a Retry-After hint (the smoothed queue wait — the time
    after which a retry plausibly meets a drained queue)."""

    def __init__(self, stage: str, retry_after_secs: float):
        self.stage = stage
        self.retry_after_secs = max(retry_after_secs, 0.0)
        super().__init__(
            f"overload shed at {stage} (retry after "
            f"{self.retry_after_secs:.2f}s)")


class OverloadController:
    """EWMA queue-wait tracker with a priority shed ladder."""

    def __init__(self, target_wait_secs: float = 0.5, alpha: float = 0.3,
                 idle_reset_secs: float = 10.0, enabled: bool = False):
        self.target_wait_secs = float(target_wait_secs)
        self.alpha = float(alpha)
        self.idle_reset_secs = float(idle_reset_secs)
        self.enabled = bool(enabled)
        self._lock = sync.lock("OverloadController._lock")
        self._ewma = 0.0
        self._last_update = 0.0
        self._last_floor = 0

    def configure(self, target_wait_secs=None, enabled=None,
                  alpha=None) -> None:
        with self._lock:
            if target_wait_secs is not None:
                self.target_wait_secs = float(target_wait_secs)
            if enabled is not None:
                self.enabled = bool(enabled)
            if alpha is not None:
                self.alpha = float(alpha)

    def reset(self) -> None:
        with self._lock:
            self._ewma = 0.0
            self._last_update = 0.0

    def note_wait(self, wait_secs: float) -> None:
        """Feed one observed queue wait (admission or batcher). Zero waits
        count too — an uncontended system must pull the EWMA back down."""
        with self._lock:
            self._ewma = (self.alpha * max(wait_secs, 0.0)
                          + (1.0 - self.alpha) * self._ewma)
            self._last_update = monotonic()
        self._note_floor_transition()

    def _note_floor_transition(self) -> None:
        """Flight-record ladder rung changes (0 → shed background → shed
        standard and back). Lazy import: flight → tenancy.context would
        cycle at module scope through tenancy/__init__."""
        floor = self.shed_floor()
        if floor != self._last_floor:
            from ..observability import flight
            flight.emit("overload.ladder",
                        attrs={"floor": floor, "from": self._last_floor,
                               "severity": round(self.severity(), 4)})
            self._last_floor = floor

    def severity(self) -> float:
        """Smoothed wait over target; 0 when disabled or idle. Staleness
        guard: if nothing has been admitted for `idle_reset_secs`, the old
        EWMA says nothing about the current queue — treat as calm."""
        with self._lock:
            if not self.enabled or self._last_update == 0.0:
                return 0.0
            if monotonic() - self._last_update > self.idle_reset_secs:
                self._ewma = 0.0
                return 0.0
            if self.target_wait_secs <= 0.0:
                return 0.0
            return self._ewma / self.target_wait_secs

    def shed_floor(self) -> int:
        """Priorities strictly below this rank are shed. severity <= 1:
        nothing; 1 < severity < 2: the bottom class; >= 2: everything but
        the top class (which is never shed)."""
        severity = self.severity()
        if severity <= 1.0:
            return 0
        return min(int(severity), MAX_PRIORITY)

    def should_shed(self, priority: int) -> bool:
        return priority < self.shed_floor()

    def retry_after_secs(self) -> float:
        with self._lock:
            return max(self._ewma, self.target_wait_secs, 0.1)

    def state(self) -> dict:
        with self._lock:
            ewma = self._ewma
        return {"enabled": self.enabled,
                "target_wait_secs": self.target_wait_secs,
                "ewma_wait_secs": round(ewma, 6),
                "severity": round(self.severity(), 4),
                "shed_floor": self.shed_floor()}


# Process-global controller, matching the process-global METRICS /
# SLOW_QUERY_LOG pattern: admission and the batcher feed it, the node
# config arms it.
OVERLOAD = OverloadController()
