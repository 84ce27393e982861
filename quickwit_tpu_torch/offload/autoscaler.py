"""Overload-driven pool autoscaling.

Role of the serverless substrate the reference leans on (AWS scales the
lambda fleet for it): derive a desired worker count from the signals this
stack already measures — the tenancy overload controller's EWMA queue-wait
severity (`tenancy/overload.py`) plus the offload queue depth — and drive a
pluggable `WorkerLauncher` to converge the pool toward it.

Scaling is asymmetric on purpose: up immediately (an overloaded pool sheds
real queries *now*), down only after a cooldown with calm signals (workers
carry warm split caches; churning them re-pays every warmup). The
autoscaler only ever terminates workers it launched itself — statically
configured endpoints are membership, not capacity.

Counterpart of the JAX package's `offload/autoscaler.py`. The in-process
launcher takes the device its workers run on.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from ..common.clock import monotonic
from ..observability.metrics import OFFLOAD_AUTOSCALE_TOTAL
from .pool import WorkerPool
from ..common import sync


class WorkerLauncher:
    """Pluggable worker substrate. `launch` returns a leaf-search client
    (anything with `.leaf_search(LeafSearchRequest)`); `terminate` releases
    whatever `launch` created. Real deployments back this with their pod /
    FaaS control plane; tests and bench use `InProcessWorkerLauncher`."""

    def launch(self, worker_id: str):  # pragma: no cover - interface
        raise NotImplementedError

    def terminate(self, worker_id: str) -> None:  # pragma: no cover
        raise NotImplementedError


class InProcessWorkerLauncher(WorkerLauncher):
    """Fake workers for tests/bench: each launch builds a full
    `SearchService` over a shared storage resolver and hands back its
    in-process client — real leaf execution, zero network. `device` is
    the one device every worker's `SearcherContext` runs on; it is
    required unless a `service_factory` builds the workers."""

    def __init__(self, storage_resolver=None, service_factory=None,
                 device=None):
        # service_factory(worker_id) -> object with .leaf_search, for tests
        # that want perturbed/instrumented workers
        if service_factory is None and device is None:
            raise ValueError("InProcessWorkerLauncher needs a device for "
                             "its workers' SearcherContext")
        self._storage_resolver = storage_resolver
        self._service_factory = service_factory
        self._device = device
        self._services: dict[str, object] = {}

    def launch(self, worker_id: str):
        if self._service_factory is not None:
            client = self._service_factory(worker_id)
        else:
            from ..search.service import (
                LocalSearchClient, SearcherContext, SearchService,
            )
            client = LocalSearchClient(SearchService(
                SearcherContext(self._storage_resolver, prefetch=False,
                                device=self._device),
                node_id=worker_id))
        self._services[worker_id] = client
        return client

    def terminate(self, worker_id: str) -> None:
        self._services.pop(worker_id, None)

    def live_workers(self) -> list[str]:
        return sorted(self._services)


class Autoscaler:
    """Converges pool size toward the overload/queue-depth demand signal.

    `tick(queue_depth)` is called by the dispatcher at dispatch entry (and
    by tests/bench directly); it is cheap and idempotent when the pool is
    already at the desired size.
    """

    def __init__(self, pool: WorkerPool, launcher: WorkerLauncher,
                 min_workers: int = 1, max_workers: int = 8,
                 queue_per_worker: int = 16,
                 scale_down_cooldown_secs: float = 10.0,
                 overload=None,
                 clock: Callable[[], float] = monotonic):
        if min_workers < 0 or max_workers < max(min_workers, 1):
            raise ValueError("need 0 <= min_workers <= max_workers, "
                             "max_workers >= 1")
        self.pool = pool
        self.launcher = launcher
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.queue_per_worker = max(int(queue_per_worker), 1)
        self.scale_down_cooldown_secs = float(scale_down_cooldown_secs)
        if overload is None:
            from ..tenancy.overload import OVERLOAD
            overload = OVERLOAD
        self.overload = overload
        self._clock = clock
        self._lock = sync.lock("Autoscaler._lock")
        self._counter = 0
        self._managed: set[str] = set()
        self._last_scale_up = 0.0

    def desired_size(self, queue_depth: int) -> int:
        """Demand = workers needed to keep per-worker queues at
        `queue_per_worker`, pushed further up by overload severity: when
        the node is shedding (severity > 1), queue depth alone understates
        demand — rejected queries never reach the queue."""
        current = self.pool.size()
        demand = math.ceil(max(queue_depth, 0) / self.queue_per_worker)
        severity = self.overload.severity()
        if severity > 1.0:
            demand = max(demand, current + math.ceil(severity - 1.0))
        return min(self.max_workers, max(self.min_workers, demand))

    def tick(self, queue_depth: int) -> int:
        """One reconcile step; returns the pool size after it."""
        with self._lock:
            desired = self.desired_size(queue_depth)
            current = self.pool.size()
            if desired > current:
                for _ in range(desired - current):
                    self._counter += 1
                    worker_id = f"auto-{self._counter}"
                    self.pool.add_worker(worker_id,
                                         self.launcher.launch(worker_id))
                    self._managed.add(worker_id)
                self._last_scale_up = self._clock()
                OFFLOAD_AUTOSCALE_TOTAL.inc(desired - current,
                                            direction="up")
            elif desired < current:
                calm = (self.overload.severity() <= 1.0
                        and (self._clock() - self._last_scale_up
                             >= self.scale_down_cooldown_secs))
                if calm:
                    removed = self._pick_removals(current - desired)
                    for worker_id in removed:
                        self.pool.remove_worker(worker_id)
                        self.launcher.terminate(worker_id)
                        self._managed.discard(worker_id)
                    if removed:
                        OFFLOAD_AUTOSCALE_TOTAL.inc(len(removed),
                                                    direction="down")
            return self.pool.size()

    def _pick_removals(self, count: int) -> list[str]:
        """Shrink managed workers only, sickest first (ejected, then
        suspect, then idle healthy) — never a worker with inflight work."""
        rank = {"ejected": 0, "suspect": 1, "healthy": 2}
        snapshot = self.pool.snapshot()
        candidates = sorted(
            (worker_id for worker_id in self._managed
             if worker_id in snapshot
             and snapshot[worker_id]["inflight"] == 0),
            key=lambda w: (rank.get(snapshot[w]["state"], 3),
                           -snapshot[w]["failures"], w))
        return candidates[:count]
