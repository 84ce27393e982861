"""Service middleware: rate limiting + circuit breaking.

Role of the reference's tower layer stack (`quickwit-common/src/tower/` —
rate-limit, circuit-breaker, load-shed wrapped around every codegen'd
client): protect services from overload and stop hammering dead peers.
"""

from __future__ import annotations

import threading
from typing import Callable, TypeVar

from .clock import monotonic

T = TypeVar("T")


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


class CircuitOpen(Exception):
    pass


class CircuitBreaker:
    """Consecutive-failure circuit breaker (reference
    `tower/circuit_breaker.rs:47`): after `failure_threshold` consecutive
    failures the circuit opens for `cooldown_secs`; the first call after the
    cooldown is the half-open probe."""

    def __init__(self, failure_threshold: int = 5, cooldown_secs: float = 10.0,
                 counts_as_failure: Callable[[BaseException], bool] = None):
        self.failure_threshold = failure_threshold
        self.cooldown_secs = cooldown_secs
        # which exceptions indicate a DEAD peer (connection-level); peer
        # application errors (4xx) must not open the circuit
        self.counts_as_failure = counts_as_failure or (lambda exc: True)
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        # qwlint: disable-next-line=QW008 - middleware leaf locks
        # (rate/concurrency counters); no instrumented ops inside their
        # critical sections
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if monotonic() - self._opened_at >= self.cooldown_secs:
                return "half-open"
            return "open"

    def call(self, fn: Callable[[], T]) -> T:
        with self._lock:
            if self._opened_at is not None:
                if monotonic() - self._opened_at < self.cooldown_secs:
                    raise CircuitOpen(
                        f"circuit open ({self._consecutive_failures} consecutive failures)")
                # half-open: admit a SINGLE probe — re-arm the cooldown so
                # concurrent callers keep failing fast instead of piling
                # timeouts onto a possibly-dead peer
                self._opened_at = monotonic()
        try:
            result = fn()
        except Exception as exc:
            if self.counts_as_failure(exc):
                with self._lock:
                    self._consecutive_failures += 1
                    if self._consecutive_failures >= self.failure_threshold:
                        self._opened_at = monotonic()
            raise
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None
        return result
