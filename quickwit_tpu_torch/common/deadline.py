"""End-to-end query deadlines and retry budgets.

Role of the reference's request-scoped timeouts (`search_job_placer` retry
budget + per-request tower timeouts): a query enters the cluster with one
wall-clock budget, and every downstream actor — root fan-out, leaf split
groups, the convoy batcher, HBM admission, storage hedging — checks the
*remaining* time instead of holding its own unrelated timeout. On expiry the
query fails partially and on time (`timed_out: true` + per-split errors),
never hangs.

`Deadline` is an absolute point on the monotonic clock; `QueryBudget` couples
a deadline with a bounded retry allowance and exponential backoff capped by
the remaining time. The ambient deadline travels through the stack via a
`contextvars.ContextVar` so deep layers (admission, storage wrappers) need no
signature changes; thread-pool hops must rebind explicitly with
`bind_deadline` because contextvars do not propagate into worker threads.
"""

from __future__ import annotations

import contextvars
import math
import threading
from contextlib import contextmanager
from typing import Callable, Optional

from .clock import get_clock

# Canonical marker for "ran out of time" errors. Split/storage error strings
# embed it so the root can tell deadline failures (-> timed_out partial
# response) apart from query-level failures (-> hard error).
DEADLINE_ERROR_MARK = "deadline exceeded"

# Canonical marker for "explicitly cancelled" errors — the caller asked for
# the query to stop, so the root answers with a typed cancelled/partial
# response instead of a timeout or a hard error.
CANCEL_ERROR_MARK = "query cancelled"


class DeadlineExceeded(Exception):
    """A step was attempted (or abandoned) after the query budget ran out."""

    def __init__(self, operation: str = ""):
        self.operation = operation
        suffix = f" during {operation}" if operation else ""
        super().__init__(f"{DEADLINE_ERROR_MARK}{suffix}")


class CancelledQuery(Exception):
    """The query was explicitly cancelled (REST DELETE, scroll teardown).

    Distinct from `DeadlineExceeded`: a cancel is a *success* of the control
    plane, not a budget failure — the root maps it to a typed
    `cancelled: true` partial response, never a retry."""

    def __init__(self, operation: str = "", reason: str = ""):
        self.operation = operation
        self.reason = reason
        suffix = f" during {operation}" if operation else ""
        why = f": {reason}" if reason else ""
        super().__init__(f"{CANCEL_ERROR_MARK}{suffix}{why}")


def is_deadline_error(message: str) -> bool:
    return DEADLINE_ERROR_MARK in (message or "")


def is_cancel_error(message: str) -> bool:
    return CANCEL_ERROR_MARK in (message or "")


class CancellationToken:
    """One query's cooperative cancel flag.

    Thread-safe and monotonic (once cancelled, forever cancelled). Deep
    layers — the batcher's readback shed, the chunked leaf loop's boundary
    checks — poll `cancelled` / call `check()`; the REST DELETE surface
    flips it from another thread via the query registry. Polling sites are
    read-only on the hot path: a single bool read, no lock."""

    __slots__ = ("_cancelled", "_reason")

    def __init__(self):
        self._cancelled = False
        self._reason = ""

    def cancel(self, reason: str = "") -> None:
        # bool store is atomic under the GIL; last reason wins (benign)
        self._reason = reason
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def reason(self) -> str:
        return self._reason

    def check(self, operation: str = "") -> None:
        if self._cancelled:
            raise CancelledQuery(operation, self._reason)


class Deadline:
    """Absolute expiry instant on the monotonic clock (or unbounded)."""

    __slots__ = ("_expires_at",)

    def __init__(self, expires_at: float):
        self._expires_at = expires_at

    @classmethod
    def after(cls, timeout_secs: float) -> "Deadline":
        return cls(get_clock().monotonic() + max(timeout_secs, 0.0))

    @classmethod
    def never(cls) -> "Deadline":
        return cls(math.inf)

    @classmethod
    def from_millis(cls, timeout_millis: Optional[int]) -> "Deadline":
        """Wire helper: a missing/zero-or-negative budget means unbounded /
        already expired respectively (a leaf receiving `deadline_millis=0`
        must shed immediately, not inherit forever)."""
        if timeout_millis is None:
            return cls.never()
        return cls.after(timeout_millis / 1000.0)

    @property
    def bounded(self) -> bool:
        return self._expires_at != math.inf

    def remaining(self) -> float:
        """Seconds left; `inf` when unbounded, clamped at 0 after expiry."""
        if not self.bounded:
            return math.inf
        return max(self._expires_at - get_clock().monotonic(), 0.0)

    @property
    def expired(self) -> bool:
        return self.bounded and get_clock().monotonic() >= self._expires_at

    def check(self, operation: str = "") -> None:
        if self.expired:
            raise DeadlineExceeded(operation)

    def clamp(self, timeout_secs: Optional[float]) -> Optional[float]:
        """Smallest of `timeout_secs` and the remaining budget; `None` stays
        `None` for unbounded deadlines (blocking-call semantics)."""
        if not self.bounded:
            return timeout_secs
        remaining = self.remaining()
        if timeout_secs is None:
            return remaining
        return min(timeout_secs, remaining)

    def timeout_millis(self) -> Optional[int]:
        """Remaining budget as integer millis for the wire (None = unbounded).

        Serializing the *remaining* time (not the original budget) means root
        queue time is not silently re-granted to the leaf."""
        if not self.bounded:
            return None
        return max(int(self.remaining() * 1000.0), 0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if not self.bounded:
            return "Deadline(never)"
        return f"Deadline(remaining={self.remaining():.3f}s)"


class QueryBudget:
    """A deadline plus a bounded, thread-safe retry allowance.

    Retries across a root fan-out share one pool so a query with many failing
    splits cannot amplify into unbounded duplicate work. Backoff is
    exponential from the second retry on (the first retry stays immediate,
    preserving fast single-failure recovery) and always capped by the
    remaining deadline.
    """

    BACKOFF_BASE_SECS = 0.05
    BACKOFF_CAP_SECS = 2.0

    def __init__(self, deadline: Deadline, max_retries: int = 8):
        self.deadline = deadline
        self.max_retries = max_retries
        self._retries_used = 0
        # qwlint: disable-next-line=QW008 - leaf lock over deadline
        # bookkeeping; no instrumented ops inside, so it is never contended
        # under the gated scheduler
        self._lock = threading.Lock()

    @classmethod
    def for_timeout_millis(cls, timeout_millis: Optional[int],
                           max_retries: int = 8) -> "QueryBudget":
        return cls(Deadline.from_millis(timeout_millis), max_retries=max_retries)

    @property
    def retries_used(self) -> int:
        with self._lock:
            return self._retries_used

    def try_acquire_retry(self) -> Optional[int]:
        """Claim one retry slot; returns the 0-based retry index, or None when
        the pool is drained or the deadline has already passed."""
        if self.deadline.expired:
            return None
        with self._lock:
            if self._retries_used >= self.max_retries:
                return None
            index = self._retries_used
            self._retries_used += 1
            return index

    def backoff_secs(self, retry_index: int) -> float:
        """Pre-retry sleep: 0 for the first retry, then exponential, always
        capped by both the ceiling and the remaining budget."""
        if retry_index <= 0:
            return 0.0
        delay = min(self.BACKOFF_BASE_SECS * (2.0 ** (retry_index - 1)),
                    self.BACKOFF_CAP_SECS)
        remaining = self.deadline.remaining()
        if remaining == math.inf:
            return delay
        return min(delay, remaining)

    def sleep_before_retry(self, retry_index: int) -> bool:
        """Sleep the backoff; returns False when the deadline expired (the
        retry should be abandoned)."""
        delay = self.backoff_secs(retry_index)
        if delay > 0.0:
            get_clock().sleep(delay)
        return not self.deadline.expired


# --- ambient propagation --------------------------------------------------

_CURRENT_DEADLINE: contextvars.ContextVar[Optional[Deadline]] = (
    contextvars.ContextVar("quickwit_tpu_deadline", default=None))


def current_deadline() -> Optional[Deadline]:
    """The deadline bound to this thread of execution, if any."""
    return _CURRENT_DEADLINE.get()


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    token = _CURRENT_DEADLINE.set(deadline)
    try:
        yield deadline
    finally:
        _CURRENT_DEADLINE.reset(token)


_CURRENT_CANCEL: contextvars.ContextVar[Optional[CancellationToken]] = (
    contextvars.ContextVar("quickwit_tpu_cancel", default=None))


def current_cancel_token() -> Optional[CancellationToken]:
    """The cancellation token bound to this thread of execution, if any."""
    return _CURRENT_CANCEL.get()


@contextmanager
def cancel_scope(token: Optional[CancellationToken]):
    ctx_token = _CURRENT_CANCEL.set(token)
    try:
        yield token
    finally:
        _CURRENT_CANCEL.reset(ctx_token)


def check_cancelled(operation: str = "") -> None:
    """Raise `CancelledQuery` when the ambient token has been cancelled;
    no-op when no token is bound (non-cancellable execution)."""
    token = _CURRENT_CANCEL.get()
    if token is not None:
        token.check(operation)


def bind_deadline(fn: Callable, deadline: Optional[Deadline] = None) -> Callable:
    """Wrap `fn` so it runs under `deadline` (default: the caller's current
    deadline) AND the caller's cancellation token. Needed for
    ThreadPoolExecutor hops — contextvars do not propagate into pool worker
    threads automatically. The cancel token rides along because every hop
    that must honor the deadline must honor an explicit cancel too."""
    captured = deadline if deadline is not None else current_deadline()
    captured_cancel = current_cancel_token()

    def wrapper(*args, **kwargs):
        with deadline_scope(captured), cancel_scope(captured_cancel):
            return fn(*args, **kwargs)

    return wrapper
