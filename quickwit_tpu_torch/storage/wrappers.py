"""Storage wrappers: tail-latency hedging, debouncing, IO counting.

Roles of the reference's `quickwit-storage` proxies:

- `TimeoutAndRetryStorage` (`timeout_and_retry_storage.rs:1`): S3 tail
  latency is long-tailed; AWS's own guidance is to retry aggressively
  rather than wait. Each `get_slice` attempt gets a deadline of
  `timeout + num_bytes / min_throughput`; on deadline a **hedge**
  request is launched while the first keeps running (strictly better
  than the reference's abort-and-retry, which its own TODO #5468 calls
  out) — whichever attempt finishes first wins.
- `DebouncedStorage` (`debouncer.rs:1`): concurrent identical GETs
  (e.g. two queries warming the same hotcache) share one underlying
  fetch.
- `CountingStorage` (`counting_storage.rs:1`): per-operation counters
  for tests and the IO metrics surface.

Carried over from the JAX package's `storage/wrappers.py`; the per-query
profile counter of hedged requests is left out until the port has
`observability/profile.py`.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from ..common.ctx import run_with_context
from ..common.deadline import DEADLINE_ERROR_MARK, current_deadline
from .base import Storage, StorageError


@dataclass
class StorageTimeoutPolicy:
    """Per-attempt deadline for ranged reads (reference:
    `node_config/mod.rs:612` — same defaults)."""
    min_throughput_bytes_per_sec: int = 100_000
    timeout_millis: int = 2_000
    max_num_retries: int = 1

    def attempt_timeouts(self, num_bytes: int) -> Iterator[float]:
        floor = (num_bytes / self.min_throughput_bytes_per_sec
                 if self.min_throughput_bytes_per_sec else 0.0)
        timeout = self.timeout_millis / 1000.0 + floor
        for _ in range(self.max_num_retries + 1):
            yield timeout


class TimeoutAndRetryStorage(Storage):
    """Hedged ranged reads: a slow attempt is raced against a fresh one
    instead of waited on; a failed attempt consumes the retry budget while
    in-flight hedges keep racing. Attempts run on dedicated threads (not a
    bounded pool) so wedged requests cannot starve later reads into
    spurious timeouts — the wrapper fronts network storage, where request
    latency dwarfs thread spawn cost."""

    def __init__(self, underlying: Storage,
                 policy: StorageTimeoutPolicy | None = None):
        super().__init__(underlying.uri)
        self.underlying = underlying
        self.policy = policy or StorageTimeoutPolicy()

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        results: "queue.Queue[tuple[bool, object]]" = queue.Queue()

        def attempt() -> None:
            try:
                results.put((True, self.underlying.get_slice(path, start,
                                                             end)))
            # qwlint: disable-next-line=QW004 - every attempt's error is
            # shipped across the queue and re-raised by the racing caller
            except Exception as exc:  # noqa: BLE001 - raced; re-raised below
                results.put((False, exc))

        def launch() -> None:
            # the hedge thread must see the query's deadline/tenant so the
            # underlying storage (fault injection, rate accounting) attributes
            # the read to the right query instead of an ambient default
            # qwlint: disable-next-line=QW008 - hedge attempts rendezvous
            # through queue.Queue, which the qwrace scheduler cannot
            # instrument; gating only the thread would stall the gated
            # schedule on an invisible queue.get, so the whole hedge path
            # stays on raw primitives (leaf machinery, no seam locks held)
            threading.Thread(target=run_with_context(attempt),
                             name="storage-hedge", daemon=True).start()

        timeouts = list(self.policy.attempt_timeouts(end - start))
        max_attempts = len(timeouts)
        per_attempt_timeout = timeouts[0]
        # hedge waits never extend past the query's own budget: a read the
        # caller can no longer use must fail now, not at the policy timeout
        query_deadline = current_deadline()
        launched, failed = 1, 0
        last_error: Exception | None = None
        launch()
        while True:
            wait_timeout = per_attempt_timeout
            if query_deadline is not None and query_deadline.bounded:
                if query_deadline.expired:
                    raise StorageError(
                        f"get_slice {path}[{start}:{end}] "
                        f"{DEADLINE_ERROR_MARK}", kind="deadline")
                wait_timeout = min(wait_timeout,
                                   max(query_deadline.remaining(), 0.001))
            try:
                ok, value = results.get(timeout=wait_timeout)
            except queue.Empty:
                if query_deadline is not None and query_deadline.expired:
                    raise StorageError(
                        f"get_slice {path}[{start}:{end}] "
                        f"{DEADLINE_ERROR_MARK} after {launched} attempts",
                        kind="deadline")
                if launched < max_attempts:
                    launch()  # hedge: race a fresh attempt, keep waiting
                    launched += 1
                    continue
                raise StorageError(
                    f"get_slice {path}[{start}:{end}] timed out after "
                    f"{launched} hedged attempts", kind="timeout")
            if ok:
                return value  # type: ignore[return-value]
            failed += 1
            last_error = value  # type: ignore[assignment]
            if launched < max_attempts:
                launch()  # a failure consumes the retry budget too
                launched += 1
                continue
            if failed >= launched:
                raise last_error  # every attempt has failed
            # budget exhausted but attempts are still in flight: keep waiting

    # non-latency-critical operations pass through
    def put(self, path: str, payload: bytes) -> None:
        self.underlying.put(path, payload)

    def delete(self, path: str) -> None:
        self.underlying.delete(path)

    def bulk_delete(self, paths: Iterable[str]) -> None:
        self.underlying.bulk_delete(paths)

    def get_all(self, path: str) -> bytes:
        return self.underlying.get_all(path)

    def file_num_bytes(self, path: str) -> int:
        return self.underlying.file_num_bytes(path)

    def list_files(self) -> list[str]:
        return self.underlying.list_files()


class DebouncedStorage(Storage):
    """Concurrent identical `get_slice` calls share one underlying fetch."""

    def __init__(self, underlying: Storage):
        super().__init__(underlying.uri)
        self.underlying = underlying
        # qwlint: disable-next-line=QW008 - leaf lock: the critical
        # sections are pure dict ops with no instrumented sync inside, so
        # under the gated scheduler the lock is never even contended
        self._lock = threading.Lock()
        self._inflight: dict[tuple, "_Cell"] = {}

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        key = (path, start, end)
        with self._lock:
            cell = self._inflight.get(key)
            if cell is None:
                cell = _Cell()
                self._inflight[key] = cell
                leader = True
            else:
                leader = False
        if leader:
            try:
                cell.value = self.underlying.get_slice(path, start, end)
            # qwlint: disable-next-line=QW004 - the error is published via
            # the cell and re-raised by the leader AND every waiter below
            except Exception as exc:  # noqa: BLE001 - published to waiters
                cell.error = exc
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                cell.done.set()
        else:
            cell.done.wait()
        if cell.error is not None:
            raise cell.error
        return cell.value  # type: ignore[return-value]

    def put(self, path: str, payload: bytes) -> None:
        self.underlying.put(path, payload)

    def delete(self, path: str) -> None:
        self.underlying.delete(path)

    def bulk_delete(self, paths: Iterable[str]) -> None:
        self.underlying.bulk_delete(paths)

    def get_all(self, path: str) -> bytes:
        return self.underlying.get_all(path)

    def file_num_bytes(self, path: str) -> int:
        return self.underlying.file_num_bytes(path)

    def list_files(self) -> list[str]:
        return self.underlying.list_files()


class _Cell:
    __slots__ = ("done", "value", "error")

    def __init__(self) -> None:
        # qwlint: disable-next-line=QW008 - paired with the raw hedge
        # machinery above (set by an uninstrumented leader thread)
        self.done = threading.Event()
        self.value: bytes | None = None
        self.error: Exception | None = None


@dataclass
class IOCounters:
    get_slice: int = 0
    get_slice_bytes: int = 0
    get_all: int = 0
    put: int = 0
    put_bytes: int = 0
    delete: int = 0
    # qwlint: disable-next-line=QW008 - leaf counter lock, no
    # instrumented ops inside its critical sections
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)


class CountingStorage(Storage):
    def __init__(self, underlying: Storage):
        super().__init__(underlying.uri)
        self.underlying = underlying
        self.counters = IOCounters()

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        data = self.underlying.get_slice(path, start, end)
        with self.counters._lock:
            self.counters.get_slice += 1
            self.counters.get_slice_bytes += len(data)
        return data

    def get_all(self, path: str) -> bytes:
        data = self.underlying.get_all(path)
        with self.counters._lock:
            self.counters.get_all += 1
        return data

    def put(self, path: str, payload: bytes) -> None:
        self.underlying.put(path, payload)
        with self.counters._lock:
            self.counters.put += 1
            self.counters.put_bytes += len(payload)

    def delete(self, path: str) -> None:
        self.underlying.delete(path)
        with self.counters._lock:
            self.counters.delete += 1

    def bulk_delete(self, paths: Iterable[str]) -> None:
        paths = list(paths)
        self.underlying.bulk_delete(paths)
        with self.counters._lock:
            self.counters.delete += len(paths)

    def file_num_bytes(self, path: str) -> int:
        return self.underlying.file_num_bytes(path)

    def list_files(self) -> list[str]:
        return self.underlying.list_files()
