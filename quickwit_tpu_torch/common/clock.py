"""Process time seam.

Role of the reference's `quickwit-dst` time virtualization: deadline reads
and retry sleeps (`common/deadline.py`) go through the process clock that
`get_clock()` returns, so a test harness can later install a virtual one
without touching its callers; `monotonic()` is the drop-in for
`time.monotonic()` on those paths (HBM admission's flight events, the
overload controller, token buckets). The port ships only the real clock;
the settable, scaled and fake clocks and the RNG seam come with the
cluster modules that need them.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class Clock:
    """Time source interface. `monotonic()` is the scheduling clock (all
    deadlines compare against it); `time()` is the epoch clock; `sleep()`
    blocks the caller; `wait(event, timeout)` is `event.wait` routed through
    the clock."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def time(self) -> float:
        raise NotImplementedError

    def time_ns(self) -> int:
        return int(self.time() * 1e9)

    def sleep(self, secs: float) -> None:
        raise NotImplementedError

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        return event.wait(timeout)


class SystemClock(Clock):
    """The real clock; behaviorally identical to calling the `time` module
    directly."""

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def time_ns(self) -> int:
        return time.time_ns()

    def sleep(self, secs: float) -> None:
        time.sleep(secs)


_SYSTEM_CLOCK = SystemClock()


def get_clock() -> Clock:
    return _SYSTEM_CLOCK


def monotonic() -> float:
    """Shorthand for `get_clock().monotonic()`."""
    return get_clock().monotonic()
