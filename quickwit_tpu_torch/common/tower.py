"""Service middleware: rate limiting.

Role of the reference's tower layer stack (`quickwit-common/src/tower/`):
the token bucket behind the tenant quotas (`tenancy/registry.py`). The
circuit breaker comes with the cluster clients that use it.
"""

from __future__ import annotations

import threading

from .clock import monotonic


class RateLimitExceeded(Exception):
    pass


class TokenBucket:
    """Token-bucket rate limiter (reference `tower/rate.rs` /
    `rate_limit.rs`): capacity `burst`, refilled at `rate_per_sec`."""

    def __init__(self, rate_per_sec: float, burst: float,
                 clock=monotonic):
        self.rate = float(rate_per_sec)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = float(burst)
        self._last = clock()
        # qwlint: disable-next-line=QW008 - middleware leaf locks
        # (rate/concurrency counters); no instrumented ops inside their
        # critical sections
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = self.clock()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False

    def time_to_available(self, cost: float = 1.0) -> float:
        """Seconds until `cost` tokens will have refilled — the honest
        value for a 429 `Retry-After` header. Costs above the burst are
        clamped (they can never be fully banked; the caller charges them
        as a full-bucket drain instead)."""
        with self._lock:
            now = self.clock()
            tokens = min(self.burst,
                         self._tokens + (now - self._last) * self.rate)
            needed = min(cost, self.burst) - tokens
            if needed <= 0.0:
                return 0.0
            if self.rate <= 0.0:
                return float("inf")
            return needed / self.rate

    def release(self, cost: float = 1.0) -> None:
        """Refund tokens a failed operation did not really consume."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + cost)

    def acquire_or_raise(self, cost: float = 1.0) -> None:
        if not self.try_acquire(cost):
            raise RateLimitExceeded(
                f"rate limit exceeded ({self.rate}/s, burst {self.burst})")
