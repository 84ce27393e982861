"""Elastic offload worker pool: dynamic registry + passive health.

Role of the reference's lambda worker fleet bookkeeping
(`quickwit-lambda-client`): the set of leaf-search workers is *elastic* —
workers are added and removed at runtime (static config endpoints, an
autoscaler's launches, operator action) — and *unreliable* — a worker that
times out or errors must stop receiving work without any active health
checker. Health here is purely passive, derived from dispatch outcomes:

    healthy --failure--> suspect --more failures--> ejected
       ^                    |                          |
       +----- success ------+        backoff elapses   |
       +------------- (half-open probe) <--------------+

An ejected worker is excluded from placement until an exponential
re-admission backoff elapses; it then re-enters as SUSPECT (half-open):
one success restores HEALTHY and resets the backoff, one more failure
re-ejects with the backoff doubled.

The pool also keeps the per-worker inflight/cost accounting the dispatcher's
stealing + hedging decisions read, and a pool-wide rolling latency window
whose p95 sets the hedge delay.

Counterpart of the JAX package's `offload/pool.py`.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Optional

from ..common import sync
from ..common.clock import monotonic
from ..observability.metrics import OFFLOAD_POOL_WORKERS

HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"

_STATES = (HEALTHY, SUSPECT, EJECTED)


class _Worker:
    __slots__ = ("worker_id", "client", "state", "consecutive_failures",
                 "eject_count", "ejected_until", "inflight", "dispatches",
                 "failures", "busy_secs")

    def __init__(self, worker_id: str, client):
        self.worker_id = worker_id
        self.client = client
        self.state = HEALTHY
        self.consecutive_failures = 0
        # how many times this worker has been ejected without an
        # intervening success — the exponent of the re-admission backoff
        self.eject_count = 0
        self.ejected_until = 0.0
        self.inflight = 0
        self.dispatches = 0
        self.failures = 0
        self.busy_secs = 0.0


class WorkerPool:
    """Thread-safe worker registry with passive health tracking.

    `clock` is injectable so the health/backoff state machine is testable
    without sleeping.
    """

    def __init__(self, suspect_after: int = 1, eject_after: int = 3,
                 readmit_backoff_secs: float = 0.5,
                 readmit_backoff_max_secs: float = 30.0,
                 latency_window: int = 128,
                 clock: Callable[[], float] = monotonic):
        if suspect_after < 1 or eject_after < suspect_after:
            raise ValueError("need 1 <= suspect_after <= eject_after")
        self.suspect_after = suspect_after
        self.eject_after = eject_after
        self.readmit_backoff_secs = float(readmit_backoff_secs)
        self.readmit_backoff_max_secs = float(readmit_backoff_max_secs)
        self._clock = clock
        self._lock = sync.lock("WorkerPool._lock")
        sync.register_shared(self, "WorkerPool")
        # qwrace planted race (mandatory self-test): with
        # QW_RACE_BREAK_POOL set, note_result mutates health state WITHOUT
        # the pool lock — racing begin_dispatch/candidates on any schedule
        # where the accesses are unordered
        self._break_unlocked = os.environ.get(
            "QW_RACE_BREAK_POOL", "").strip().lower() in ("1", "true", "yes")
        self._workers: dict[str, _Worker] = {}
        # pool-wide rolling window of successful-dispatch latencies; its
        # p95 is the hedge trigger ("this attempt is slower than 95% of
        # recent ones → launch a backup")
        self._latencies: deque[float] = deque(maxlen=latency_window)

    # --- membership -------------------------------------------------------
    def add_worker(self, worker_id: str, client) -> None:
        with self._lock:
            if worker_id in self._workers:
                raise ValueError(f"worker {worker_id!r} already registered")
            self._workers[worker_id] = _Worker(worker_id, client)
            self._refresh_gauges_locked()

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
            self._refresh_gauges_locked()

    def __contains__(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._workers

    def size(self) -> int:
        with self._lock:
            return len(self._workers)

    def worker_ids(self) -> list[str]:
        """Every registered worker, any state (sorted for determinism)."""
        with self._lock:
            return sorted(self._workers)

    def client(self, worker_id: str):
        with self._lock:
            return self._workers[worker_id].client

    # --- placement candidates --------------------------------------------
    def candidates(self) -> list[str]:
        """Workers eligible for new dispatches, sorted for deterministic
        placement: healthy + suspect, plus ejected workers whose backoff
        has elapsed — those transition to SUSPECT here (half-open probe:
        the next dispatch outcome decides re-eject vs recovery)."""
        now = self._clock()
        with self._lock:
            sync.note_write(self, "workers")
            eligible = []
            for worker in self._workers.values():
                if worker.state == EJECTED:
                    if now < worker.ejected_until:
                        continue
                    worker.state = SUSPECT
                    # one more failure re-ejects immediately
                    worker.consecutive_failures = self.eject_after - 1
                eligible.append(worker.worker_id)
            self._refresh_gauges_locked()
            return sorted(eligible)

    # --- dispatch accounting ---------------------------------------------
    def begin_dispatch(self, worker_id: str) -> None:
        with self._lock:
            sync.note_write(self, "workers")
            worker = self._workers.get(worker_id)
            if worker is None:
                return
            worker.inflight += 1
            worker.dispatches += 1

    def note_result(self, worker_id: str, ok: bool,
                    latency_secs: Optional[float] = None) -> None:
        """End-of-attempt accounting: inflight release + the passive
        health transition this outcome implies."""
        if self._break_unlocked:
            self._note_result_locked(worker_id, ok, latency_secs)
            return
        with self._lock:
            self._note_result_locked(worker_id, ok, latency_secs)

    def _note_result_locked(self, worker_id: str, ok: bool,
                            latency_secs: Optional[float]) -> None:
        sync.note_write(self, "workers")
        worker = self._workers.get(worker_id)
        if worker is None:
            return  # removed while the attempt was in flight
        worker.inflight = max(worker.inflight - 1, 0)
        if latency_secs is not None:
            worker.busy_secs += latency_secs
        if ok:
            worker.consecutive_failures = 0
            worker.eject_count = 0
            worker.state = HEALTHY
            if latency_secs is not None:
                self._latencies.append(latency_secs)
        else:
            worker.failures += 1
            worker.consecutive_failures += 1
            if worker.consecutive_failures >= self.eject_after:
                worker.state = EJECTED
                backoff = min(
                    self.readmit_backoff_secs * (2 ** worker.eject_count),
                    self.readmit_backoff_max_secs)
                worker.ejected_until = self._clock() + backoff
                worker.eject_count += 1
            elif worker.consecutive_failures >= self.suspect_after:
                worker.state = SUSPECT
        self._refresh_gauges_locked()

    def inflight(self, worker_id: str) -> int:
        with self._lock:
            sync.note_read(self, "workers")
            worker = self._workers.get(worker_id)
            return worker.inflight if worker is not None else 0

    def p95_latency(self) -> Optional[float]:
        """p95 of the rolling successful-latency window; None until enough
        samples exist to make the percentile meaningful."""
        with self._lock:
            if len(self._latencies) < 5:
                return None
            ordered = sorted(self._latencies)
            return ordered[min(int(0.95 * len(ordered)),
                               len(ordered) - 1)]

    # --- introspection ----------------------------------------------------
    def state_of(self, worker_id: str) -> Optional[str]:
        with self._lock:
            sync.note_read(self, "workers")
            worker = self._workers.get(worker_id)
            return worker.state if worker is not None else None

    def snapshot(self) -> dict:
        """Full pool state for tests / developer endpoints."""
        with self._lock:
            return {
                worker_id: {
                    "state": w.state,
                    "inflight": w.inflight,
                    "dispatches": w.dispatches,
                    "failures": w.failures,
                    "consecutive_failures": w.consecutive_failures,
                    "eject_count": w.eject_count,
                    "busy_secs": round(w.busy_secs, 6),
                }
                for worker_id, w in self._workers.items()
            }

    def _refresh_gauges_locked(self) -> None:
        counts = {state: 0 for state in _STATES}
        for worker in self._workers.values():
            counts[worker.state] += 1
        for state, count in counts.items():
            OFFLOAD_POOL_WORKERS.set(count, state=state)
