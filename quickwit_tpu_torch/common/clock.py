"""Process-injectable time and randomness seams.

Role of the reference's `quickwit-dst` time virtualization: every
wall-clock read, sleep and un-seeded random draw on a cluster path
(deadline reads and retry sleeps in `common/deadline.py`, HBM admission's
flight events, the overload controller, token buckets, the metastore's
timestamps, split-id minting) routes through the process clock and RNG
installed here, so a test can substitute a virtual clock and a seeded RNG
and get the same bytes on every run.

Contract:

- `get_clock()` / `get_rng()` return the process-installed instances;
  the defaults (`SystemClock`, an entropy-seeded `random.Random`) behave
  exactly like the `time` and `random` modules.
- `set_clock` / `set_rng` swap the process instance and return the
  previous one; `use_clock` / `use_rng` are the context-managed form
  tests use (always restores, even on failure).
- Implementations must be thread-safe: the root's fan-out threads and the
  service's prefetch pool read the clock concurrently.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional


class Clock:
    """Time source interface. `monotonic()` is the scheduling clock (all
    deadlines, TTLs, and liveness ages compare against it); `time()` is
    the epoch clock (persisted timestamps); `sleep()` blocks the caller;
    `wait(event, timeout)` is `event.wait` routed through the clock so an
    accelerated implementation can compress interval loops."""

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
    """The real clock — production default; behaviorally identical to
    calling the `time` module directly."""

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def time_ns(self) -> int:
        return time.time_ns()

    def sleep(self, secs: float) -> None:
        time.sleep(secs)


class ScaledClock(Clock):
    """Accelerated clock for interval-loop tests (gossip, convergence):
    sleeps and event waits run at `factor` of their requested duration in
    real time, while `monotonic()` reports the FULL requested durations as
    elapsed — so liveness aging, dead_after thresholds, and cooldowns see
    the virtual timeline. A 50ms gossip interval runs in 1ms of wall time
    yet ages peers by the full 50ms.

    Waits that return early (event set) advance virtual time by the real
    elapsed portion only, scaled back up, so a stop() does not fast-forward
    liveness past a peer's death threshold."""

    def __init__(self, factor: float = 0.02):
        if not 0.0 < factor <= 1.0:
            raise ValueError("factor must be in (0, 1]")
        self.factor = float(factor)
        # qwlint: disable-next-line=QW008 - clock infrastructure underpins the
        # seam itself; raw leaf primitive with no instrumented ops inside its
        # critical sections
        self._lock = threading.Lock()
        self._offset = 0.0  # virtual seconds ahead of the real clock

    def monotonic(self) -> float:
        with self._lock:
            return time.monotonic() + self._offset

    def time(self) -> float:
        with self._lock:
            return time.time() + self._offset

    def _advance(self, virtual_elapsed: float, real_elapsed: float) -> None:
        with self._lock:
            self._offset += max(virtual_elapsed - real_elapsed, 0.0)

    def sleep(self, secs: float) -> None:
        real = max(secs, 0.0) * self.factor
        time.sleep(real)
        self._advance(max(secs, 0.0), real)

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        if timeout is None:
            return event.wait(None)
        start = time.monotonic()
        fired = event.wait(max(timeout, 0.0) * self.factor)
        real = time.monotonic() - start
        # early fire: only the portion actually waited ages the timeline
        virtual = real / self.factor if fired else max(timeout, 0.0)
        self._advance(virtual, real)
        return fired


class FakeClock(Clock):
    """Manually-advanced clock for unit tests: time moves only through
    `advance()` (or `sleep`, which advances by the requested amount and
    returns immediately)."""

    def __init__(self, start: float = 1000.0, epoch: float = 1_600_000_000.0):
        # qwlint: disable-next-line=QW008 - clock infrastructure underpins the
        # seam itself; raw leaf primitive with no instrumented ops inside its
        # critical sections
        self._lock = threading.Lock()
        self._now = float(start)
        self._epoch_skew = float(epoch) - float(start)

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def time(self) -> float:
        with self._lock:
            return self._now + self._epoch_skew

    def sleep(self, secs: float) -> None:
        self.advance(secs)

    def advance(self, secs: float) -> float:
        with self._lock:
            self._now += max(float(secs), 0.0)
            return self._now

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        # a timed wait against frozen time: consume the timeout virtually,
        # yield the GIL so other threads progress, report the event state
        if timeout is not None:
            self.advance(timeout)
        time.sleep(0)
        return event.is_set()


_SYSTEM_CLOCK = SystemClock()
# qwlint: disable-next-line=QW008 - clock infrastructure underpins the seam
# itself; raw leaf primitive with no instrumented ops inside its critical
# sections
_clock_lock = threading.Lock()
_process_clock: Clock = _SYSTEM_CLOCK
# default RNG: entropy-seeded, exactly what bare `random.*` calls used
_process_rng: random.Random = random.Random()


def get_clock() -> Clock:
    return _process_clock


def set_clock(clock: Optional[Clock]) -> Clock:
    """Install `clock` process-wide (None restores the system clock);
    returns the previously installed clock."""
    global _process_clock
    with _clock_lock:
        previous = _process_clock
        _process_clock = clock if clock is not None else _SYSTEM_CLOCK
        return previous


@contextmanager
def use_clock(clock: Clock) -> Iterator[Clock]:
    previous = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(previous)


def get_rng() -> random.Random:
    return _process_rng


def set_rng(rng: Optional[random.Random]) -> random.Random:
    """Install a process RNG (None restores an entropy-seeded one);
    returns the previous instance."""
    global _process_rng
    with _clock_lock:
        previous = _process_rng
        _process_rng = rng if rng is not None else random.Random()
        return previous


@contextmanager
def use_rng(rng: random.Random) -> Iterator[random.Random]:
    previous = set_rng(rng)
    try:
        yield rng
    finally:
        set_rng(previous)


def monotonic() -> float:
    """Shorthand for `get_clock().monotonic()` — the drop-in replacement
    for `time.monotonic()` on simulation-scoped paths."""
    return _process_clock.monotonic()


def wall_time() -> float:
    """Shorthand for `get_clock().time()`."""
    return _process_clock.time()


def sleep(secs: float) -> None:
    """Shorthand for `get_clock().sleep(secs)`."""
    _process_clock.sleep(secs)
