"""Offload dispatcher: rendezvous-affine placement with deadline-budgeted
retry, hedged dispatch, and work stealing.

Role of the reference's lambda invoker + `ClusterClient` retry policy
(`quickwit-lambda-client/src/invoker.rs`, `cluster_client.rs`): fan a batch
of offloaded splits across the worker pool and get every split answered
exactly once, inside the query deadline, despite slow and dying workers.

Placement is the existing rendezvous placer (`search/placer.py`,
`nodes_for_split`): each split's task goes to its top-ranked *candidate*
worker, so the same split lands on the same worker across queries (device/
reader cache affinity) and one membership change moves only ~1/n of the
splits. Placement is deliberately pure affinity — no static cost spill —
because load balance is done *dynamically* here instead: an idle worker
steals queued tasks from the longest queue, which rebalances exactly when
imbalance is real rather than predicted.

Recovery ladder, all deadline-budgeted:

- retry: a failed task re-enqueues on the next rendezvous-ranked worker
  that has not tried it yet;
- hedge: a task in flight longer than the pool's rolling p95 latency gets
  a duplicate attempt on another worker — first response wins, the loser
  is discarded (first-writer-wins at the result board);
- steal: tasks still *queued* on a busy worker move to an idle one.

Typed backpressure (`OverloadShed` / `TenantRateLimited`, or a remote
HTTP 429 carrying the same semantics) is never retried and never falls
back to local execution: it re-raises out of `dispatch` so the query fails
as a whole-query 429 — a worker's rate limits must bind the root too.

Counterpart of the JAX package's `offload/dispatcher.py`: the same
placement, so the same split lands on the same worker in both packages.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..common import sync
from ..common.clock import monotonic
from ..common.ctx import run_with_context
from ..common.deadline import Deadline, current_deadline
from ..observability import flight
from ..observability.metrics import (
    OFFLOAD_DISPATCHES_TOTAL, OFFLOAD_DISPATCH_SECONDS, OFFLOAD_HEDGES_TOTAL,
    OFFLOAD_QUEUE_DEPTH, OFFLOAD_RETRIES_TOTAL, OFFLOAD_SPLITS_TOTAL,
    OFFLOAD_STEALS_TOTAL,
)
from ..observability.tracing import TRACER
from ..search.models import (
    LeafSearchRequest, LeafSearchResponse, SplitIdAndFooter,
)
from ..search.placer import nodes_for_split
from ..tenancy.overload import OverloadShed
from ..tenancy.registry import TenantRateLimited


def typed_backpressure_of(exc: BaseException) -> Optional[Exception]:
    """Classify a worker failure as typed backpressure (to re-raise) or
    None (a generic failure: retry / steal / fall back locally).

    In-process workers raise the real `OverloadShed`/`TenantRateLimited`;
    HTTP workers answer 429 with the ES-style body `serve/rest.py`'s
    `_throttle_error` writes — reconstruct the typed exception from it so
    the root's 429 + Retry-After contract survives the extra hop."""
    if isinstance(exc, (OverloadShed, TenantRateLimited)):
        return exc
    status = getattr(exc, "status", None)
    if status != 429:
        return None
    retry_after = 1.0
    kind = "overloaded"
    try:
        payload = json.loads(getattr(exc, "body", b"") or b"{}")
        kind = payload.get("error", {}).get("type", kind)
    except (ValueError, AttributeError):
        pass
    if kind == "rate_limit_exceeded":
        return TenantRateLimited(tenant_id="offload-worker", limit="remote",
                                 retry_after_secs=retry_after)
    return OverloadShed("offload_worker", retry_after_secs=retry_after)


@dataclass
class OffloadOutcome:
    """What `dispatch` could and could not get served remotely.

    `responses` are per-task worker responses (already deduplicated:
    exactly one per completed task). `unserved` splits belong to the
    caller again — the service runs them on the local path."""
    responses: list[LeafSearchResponse] = field(default_factory=list)
    unserved: list[SplitIdAndFooter] = field(default_factory=list)
    stats: dict[str, int] = field(default_factory=dict)


class _Task:
    """One dispatch unit: a chunk of splits bound for one worker, with the
    rendezvous preference order its retries walk."""

    __slots__ = ("splits", "preference", "tried", "attempts_inflight",
                 "first_dispatch_at", "hedged", "done", "response",
                 "winner_kind", "failed")

    def __init__(self, splits: list[SplitIdAndFooter],
                 preference: list[str]):
        self.splits = splits
        self.preference = preference
        self.tried: set[str] = set()
        self.attempts_inflight = 0
        self.first_dispatch_at: Optional[float] = None
        self.hedged = False
        self.done = False
        self.response: Optional[LeafSearchResponse] = None
        self.winner_kind: Optional[str] = None
        self.failed = False


class OffloadDispatcher:
    """Schedules one query's offloaded splits over the worker pool.

    The dispatcher is long-lived (per SearcherContext) and stateless
    across calls except for the pool it reads; each `dispatch` call runs
    its own little scheduler loop over per-worker FIFO queues.
    """

    def __init__(self, pool, task_splits: int = 8,
                 max_inflight_per_worker: int = 1,
                 hedge_min_delay_secs: float = 0.05,
                 hedge_max_delay_secs: float = 5.0,
                 min_attempt_budget_secs: float = 0.02,
                 injector=None, autoscaler=None,
                 clock: Callable[[], float] = monotonic):
        self.pool = pool
        self.task_splits = max(int(task_splits), 1)
        self.max_inflight_per_worker = max(int(max_inflight_per_worker), 1)
        self.hedge_min_delay_secs = float(hedge_min_delay_secs)
        self.hedge_max_delay_secs = float(hedge_max_delay_secs)
        self.min_attempt_budget_secs = float(min_attempt_budget_secs)
        # chaos hook: FaultInjector perturbing `offload.dispatch@<worker>`
        # before every worker RPC (common/faults.py determinism contract)
        self.injector = injector
        self.autoscaler = autoscaler
        self._clock = clock

    # --- placement --------------------------------------------------------
    def plan_tasks(self, splits: list[SplitIdAndFooter],
                   workers: list[str]) -> dict[str, list[_Task]]:
        """Rendezvous-affine assignment: each split's primary worker is its
        top-ranked candidate; each worker's run is chunked into tasks of
        `task_splits` so stealing/hedging operate on bounded units.
        Deterministic given (splits, workers) — the property test pins
        both determinism and the ~1/n reassignment bound."""
        by_worker: dict[str, list[SplitIdAndFooter]] = {}
        for split in splits:
            primary = nodes_for_split(split.split_id, workers)[0]
            by_worker.setdefault(primary, []).append(split)
        queues: dict[str, list[_Task]] = {}
        for worker_id, run in by_worker.items():
            for start in range(0, len(run), self.task_splits):
                chunk = run[start:start + self.task_splits]
                preference = nodes_for_split(chunk[0].split_id, workers)
                queues.setdefault(worker_id, []).append(
                    _Task(chunk, preference))
        return queues

    # --- the scheduler ----------------------------------------------------
    def dispatch(self, request: LeafSearchRequest,
                 deadline: Optional[Deadline] = None,
                 traceparent: Optional[str] = None) -> OffloadOutcome:
        """Run `request.splits` over the pool; returns served responses +
        the splits the caller must run locally. Raises typed backpressure
        (`OverloadShed` / `TenantRateLimited`) without retrying it."""
        deadline = deadline or current_deadline() or Deadline.never()
        if self.autoscaler is not None:
            self.autoscaler.tick(queue_depth=len(request.splits))
        workers = self.pool.candidates()
        if not workers:
            OFFLOAD_SPLITS_TOTAL.inc(len(request.splits),
                                     outcome="fallback_local")
            return OffloadOutcome(unserved=list(request.splits),
                                  stats={"no_workers": 1})

        # per-call condition: the result board's only synchronization.
        # Deliberately NOT a `*_lock`-named lock: the bridge reports it as
        # anonymous (QW007's static graph never claims to see per-call
        # primitives)
        cv = sync.condition(name="offload_cv")
        queues: dict[str, deque[_Task]] = {
            worker_id: deque(tasks) for worker_id, tasks
            in self.plan_tasks(request.splits, workers).items()}
        tasks: list[_Task] = [t for q in queues.values() for t in q]
        state: dict[str, Any] = {
            "backpressure": None, "sealed": False,
            "stats": {"retries": 0, "hedges": 0, "hedges_won": 0,
                      "steals": 0, "tasks_failed": 0}}
        OFFLOAD_QUEUE_DEPTH.set(len(request.splits))

        def _sub_request(task: _Task) -> LeafSearchRequest:
            # remaining budget re-serialized at ATTEMPT time: queue time on
            # this node is not silently re-granted to the worker
            return LeafSearchRequest(
                search_request=request.search_request,
                index_uid=request.index_uid,
                doc_mapping=request.doc_mapping,
                splits=task.splits,
                deadline_millis=deadline.timeout_millis(),
                tenant=request.tenant,
                sort_value_threshold=request.sort_value_threshold)

        def _attempt(task: _Task, worker_id: str, kind: str) -> None:
            t0 = self._clock()
            error: Optional[BaseException] = None
            response = None
            try:
                if self.injector is not None:
                    self.injector.perturb(f"offload.dispatch@{worker_id}")
                with TRACER.span("offload_dispatch",
                                 {"worker": worker_id, "kind": kind,
                                  "num_splits": len(task.splits)},
                                 remote_parent=traceparent):
                    response = self.pool.client(worker_id).leaf_search(
                        _sub_request(task))
            # qwlint: disable-next-line=QW004 - every failure is classified
            # below: typed backpressure re-raises out of dispatch(), the
            # rest drive the retry/steal/fallback ladder — nothing is
            # swallowed
            except Exception as exc:  # noqa: BLE001 - classified below
                error = exc
            latency = self._clock() - t0
            self.pool.note_result(worker_id, ok=error is None,
                                  latency_secs=latency)
            if flight.recording():
                flight.emit("offload.dispatch",
                            attrs={"worker": worker_id, "kind": kind,
                                   "ok": int(error is None),
                                   "splits": len(task.splits),
                                   "dur_ms": round(latency * 1000.0, 3)})
            with cv:
                task.attempts_inflight -= 1
                if error is None:
                    if task.done or state["sealed"]:
                        # hedge/steal race lost (or the query moved on):
                        # first writer already owns this task's splits
                        OFFLOAD_DISPATCHES_TOTAL.inc(outcome="discarded")
                        if kind == "hedge":
                            OFFLOAD_HEDGES_TOTAL.inc(outcome="lost")
                    else:
                        task.done = True
                        task.response = response
                        task.winner_kind = kind
                        OFFLOAD_DISPATCHES_TOTAL.inc(outcome="ok")
                        OFFLOAD_DISPATCH_SECONDS.observe(latency)
                        if kind == "hedge":
                            state["stats"]["hedges_won"] += 1
                            OFFLOAD_HEDGES_TOTAL.inc(outcome="won")
                    cv.notify_all()
                    return
                typed = typed_backpressure_of(error)
                if typed is not None:
                    OFFLOAD_DISPATCHES_TOTAL.inc(outcome="backpressure")
                    if state["backpressure"] is None:
                        state["backpressure"] = typed
                    cv.notify_all()
                    return
                OFFLOAD_DISPATCHES_TOTAL.inc(outcome="error")
                if task.done or state["sealed"]:
                    cv.notify_all()
                    return
                # deadline-budgeted retry on the next-ranked worker that
                # has not seen this task (and is still placeable)
                live = set(self.pool.candidates())
                next_worker = next(
                    (w for w in task.preference
                     if w not in task.tried and w in live), None)
                if (next_worker is not None and not deadline.expired
                        and (deadline.remaining()
                             > self.min_attempt_budget_secs)):
                    state["stats"]["retries"] += 1
                    OFFLOAD_RETRIES_TOTAL.inc()
                    queues.setdefault(next_worker,
                                      deque()).append(task)
                elif task.attempts_inflight == 0:
                    task.failed = True
                    state["stats"]["tasks_failed"] += 1
                cv.notify_all()

        def _launch(task: _Task, worker_id: str, kind: str) -> None:
            # cv is held here; pool + thread start are safe under it (the
            # pool never takes cv, lock order is always cv -> pool)
            task.tried.add(worker_id)
            task.attempts_inflight += 1
            if task.first_dispatch_at is None:
                task.first_dispatch_at = self._clock()
            self.pool.begin_dispatch(worker_id)
            sync.thread(
                target=run_with_context(_attempt),
                args=(task, worker_id, kind),
                name=f"offload-{worker_id}", daemon=True).start()

        def _hedge_delay() -> float:
            p95 = self.pool.p95_latency()
            if p95 is None:
                return self.hedge_min_delay_secs
            return min(max(p95, self.hedge_min_delay_secs),
                       self.hedge_max_delay_secs)

        with cv:
            while True:
                if state["backpressure"] is not None:
                    break
                if all(t.done or t.failed for t in tasks):
                    break
                if deadline.expired:
                    break
                live = self.pool.candidates()
                # 1) start queued work, FIFO per worker, bounded inflight
                for worker_id in live:
                    queue = queues.get(worker_id)
                    while (queue
                           and (self.pool.inflight(worker_id)
                                < self.max_inflight_per_worker)):
                        task = queue.popleft()
                        if task.done or task.failed:
                            continue
                        _launch(task, worker_id,
                                "retry" if task.tried else "primary")
                # 2) work stealing: an idle worker drains the tail of the
                # longest queue — affinity yields to liveness only when a
                # queue actually lags
                if (not deadline.expired and deadline.remaining()
                        > self.min_attempt_budget_secs):
                    for worker_id in live:
                        if (self.pool.inflight(worker_id) > 0
                                or queues.get(worker_id)):
                            continue
                        donor = max(
                            (w for w in queues
                             if w != worker_id and queues[w]),
                            key=lambda w: len(queues[w]), default=None)
                        if donor is None:
                            continue
                        task = queues[donor].pop()
                        if task.done or task.failed:
                            continue
                        state["stats"]["steals"] += 1
                        OFFLOAD_STEALS_TOTAL.inc()
                        _launch(task, worker_id, "steal")
                # 3) hedging: duplicate in-flight stragglers once
                hedge_delay = _hedge_delay()
                now = self._clock()
                for task in tasks:
                    if (task.done or task.failed or task.hedged
                            or task.attempts_inflight == 0
                            or task.first_dispatch_at is None
                            or now - task.first_dispatch_at < hedge_delay):
                        continue
                    if deadline.remaining() <= self.min_attempt_budget_secs:
                        continue
                    backup = next(
                        (w for w in task.preference
                         if w not in task.tried and w in live
                         and self.pool.inflight(w)
                         < self.max_inflight_per_worker), None)
                    if backup is None:
                        continue
                    task.hedged = True
                    state["stats"]["hedges"] += 1
                    OFFLOAD_HEDGES_TOTAL.inc(outcome="launched")
                    _launch(task, backup, "hedge")
                cv.wait(timeout=0.01)
            state["sealed"] = True
            backpressure = state["backpressure"]
            responses = [t.response for t in tasks
                         if t.done and t.response is not None]
            unserved = [s for t in tasks if not t.done for s in t.splits]
            stats = dict(state["stats"])
        OFFLOAD_QUEUE_DEPTH.set(0)
        served = sum(len(t.splits) for t in tasks if t.done)
        if served:
            OFFLOAD_SPLITS_TOTAL.inc(served, outcome="remote")
        if backpressure is not None:
            raise backpressure
        if unserved:
            OFFLOAD_SPLITS_TOTAL.inc(len(unserved), outcome="fallback_local")
        return OffloadOutcome(responses=responses, unserved=unserved,
                              stats=stats)
