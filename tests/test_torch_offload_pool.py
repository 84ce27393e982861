"""The port's elastic offload pool (quickwit_tpu_torch/offload/).

`tests/test_offload_pool.py`'s cases run against the port: the
WorkerPool's passive health state machine and backoff, the
OffloadDispatcher's placement/retry/hedge/steal/dedup ladder, and the
Autoscaler's overload+queue-depth sizing, with fake workers and an
injectable clock. Then the same scenarios in both packages: placement,
health transitions, dispatch outcomes and the `qw_offload_*` metric
deltas must be equal. The port's in-process launcher takes the device
its workers run on.
"""

from __future__ import annotations

import json
import time

import pytest

from quickwit_tpu_torch.common.deadline import Deadline
from quickwit_tpu_torch.offload import (
    Autoscaler, EJECTED, HEALTHY, InProcessWorkerLauncher, OffloadDispatcher,
    SUSPECT, WorkerPool, typed_backpressure_of,
)
from quickwit_tpu_torch.query.ast import MatchAll
from quickwit_tpu_torch.search.models import (
    LeafSearchRequest, LeafSearchResponse, SearchRequest, SplitIdAndFooter,
)
from quickwit_tpu_torch.search.placer import nodes_for_split
from quickwit_tpu_torch.serve.http_client import HttpStatusError
from quickwit_tpu_torch.tenancy.overload import OverloadShed
from quickwit_tpu_torch.tenancy.registry import TenantRateLimited


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, secs):
        self.now += secs


class FakeWorker:
    """In-memory worker: answers one LeafSearchResponse per request, with
    optional per-call delay or a raised exception."""

    def __init__(self, worker_id, exc=None, delay=0.0):
        self.worker_id = worker_id
        self.exc = exc
        self.delay = delay
        self.requests = []

    def leaf_search(self, request):
        self.requests.append(request)
        if self.delay:
            time.sleep(self.delay)
        if self.exc is not None:
            raise self.exc
        return LeafSearchResponse(
            num_hits=10 * len(request.splits),
            num_successful_splits=len(request.splits))


def make_splits(count, prefix="split"):
    return [SplitIdAndFooter(split_id=f"{prefix}-{i:03d}",
                             storage_uri="ram:///offload")
            for i in range(count)]


def make_request(splits):
    return LeafSearchRequest(
        search_request=SearchRequest(index_ids=["i"], query_ast=MatchAll()),
        index_uid="i:01", doc_mapping={}, splits=splits)


def build_pool(workers, **kwargs):
    pool = WorkerPool(**kwargs)
    for worker in workers:
        pool.add_worker(worker.worker_id, worker)
    return pool


# --- placement property -----------------------------------------------------


def test_placement_deterministic_and_minimal_disruption():
    splits = make_splits(200)
    workers = [f"w{i}" for i in range(5)]
    dispatcher = OffloadDispatcher(WorkerPool(), task_splits=1)

    def assignment(members):
        plan = dispatcher.plan_tasks(splits, members)
        return {task.splits[0].split_id: worker_id
                for worker_id, tasks in plan.items() for task in tasks}

    before = assignment(workers)
    assert before == assignment(workers), "placement not deterministic"
    assert set(before) == {s.split_id for s in splits}

    removed = "w2"
    after = assignment([w for w in workers if w != removed])
    # rendezvous guarantee: EVERY split whose primary survives keeps it —
    # at least (n-1)/n of assignments in expectation, exactly the removed
    # worker's share moves
    moved = [s for s in before if after[s] != before[s]]
    assert all(before[s] == removed for s in moved), \
        "a surviving worker's split moved on unrelated membership change"
    orphaned = [s for s in before if before[s] == removed]
    assert sorted(moved) == sorted(orphaned)
    # the removed worker's share is ~1/n of the corpus, not a hot spot
    assert 0 < len(orphaned) < 2 * len(splits) / len(workers)


def test_plan_tasks_chunks_runs_and_keeps_affinity():
    splits = make_splits(30)
    workers = ["w0", "w1", "w2"]
    dispatcher = OffloadDispatcher(WorkerPool(), task_splits=4)
    plan = dispatcher.plan_tasks(splits, workers)
    planned = [s.split_id for tasks in plan.values()
               for t in tasks for s in t.splits]
    assert sorted(planned) == sorted(s.split_id for s in splits)
    for worker_id, tasks in plan.items():
        for task in tasks:
            assert len(task.splits) <= 4
            assert task.preference[0] == worker_id
            for split in task.splits:
                assert nodes_for_split(split.split_id,
                                       workers)[0] == worker_id


# --- pool health state machine ----------------------------------------------


def test_health_escalation_and_exponential_readmission():
    clock = FakeClock()
    pool = build_pool([FakeWorker("w0")], suspect_after=1, eject_after=2,
                      readmit_backoff_secs=1.0, readmit_backoff_max_secs=8.0,
                      clock=clock)
    pool.note_result("w0", ok=False)
    assert pool.state_of("w0") == SUSPECT
    pool.note_result("w0", ok=False)
    assert pool.state_of("w0") == EJECTED
    assert pool.candidates() == []          # backoff pending
    clock.advance(1.0)
    assert pool.candidates() == ["w0"]      # half-open probe
    assert pool.state_of("w0") == SUSPECT
    pool.note_result("w0", ok=False)        # probe fails: re-eject, 2x
    assert pool.state_of("w0") == EJECTED
    clock.advance(1.0)
    assert pool.candidates() == []          # doubled backoff not elapsed
    clock.advance(1.0)
    assert pool.candidates() == ["w0"]
    pool.note_result("w0", ok=True)         # probe succeeds: full recovery
    assert pool.state_of("w0") == HEALTHY
    # the success reset the exponent: next ejection uses the base backoff
    pool.note_result("w0", ok=False)
    pool.note_result("w0", ok=False)
    clock.advance(1.0)
    assert pool.candidates() == ["w0"]


def test_readmission_backoff_is_capped():
    clock = FakeClock()
    pool = build_pool([FakeWorker("w0")], suspect_after=1, eject_after=1,
                      readmit_backoff_secs=1.0, readmit_backoff_max_secs=4.0,
                      clock=clock)
    for _ in range(6):  # uncapped would be 2^6 = 64s by now
        pool.note_result("w0", ok=False)
        clock.advance(4.0)
        assert pool.candidates() == ["w0"], "backoff exceeded the cap"


def test_membership_and_inflight_accounting():
    pool = build_pool([FakeWorker("w0")])
    with pytest.raises(ValueError):
        pool.add_worker("w0", FakeWorker("w0"))
    pool.begin_dispatch("w0")
    assert pool.inflight("w0") == 1
    pool.remove_worker("w0")
    pool.note_result("w0", ok=True)  # attempt outlives removal: no crash
    assert pool.size() == 0
    assert "w0" not in pool


def test_p95_needs_samples_then_tracks_tail():
    pool = build_pool([FakeWorker("w0")])
    for latency in (0.01, 0.01, 0.01, 0.01):
        pool.begin_dispatch("w0")
        pool.note_result("w0", ok=True, latency_secs=latency)
    assert pool.p95_latency() is None  # 4 samples: too few to trust
    pool.begin_dispatch("w0")
    pool.note_result("w0", ok=True, latency_secs=1.0)
    assert pool.p95_latency() == 1.0


# --- dispatcher: happy path, retry, hedge, steal, dedup ---------------------


def test_dispatch_serves_every_split():
    workers = [FakeWorker(f"w{i}") for i in range(3)]
    dispatcher = OffloadDispatcher(build_pool(workers))
    splits = make_splits(10)
    outcome = dispatcher.dispatch(make_request(splits),
                                  deadline=Deadline.after(10.0))
    assert outcome.unserved == []
    assert sum(r.num_successful_splits for r in outcome.responses) == 10
    assert outcome.stats["retries"] == 0
    assert outcome.stats["tasks_failed"] == 0


def test_dead_worker_recovered_on_next_ranked(caplog):
    member_ids = ["w0", "w1", "w2"]
    splits = make_splits(9)
    dead_id = nodes_for_split(splits[0].split_id, member_ids)[0]
    workers = [FakeWorker(w, exc=RuntimeError("worker down")
                          if w == dead_id else None)
               for w in member_ids]
    pool = build_pool(workers, suspect_after=1, eject_after=2)
    dispatcher = OffloadDispatcher(pool, task_splits=2)
    outcome = dispatcher.dispatch(make_request(splits),
                                  deadline=Deadline.after(10.0))
    assert outcome.unserved == []
    assert sum(r.num_successful_splits for r in outcome.responses) == 9
    assert outcome.stats["retries"] >= 1
    assert pool.state_of(dead_id) in (SUSPECT, EJECTED)


def test_hedge_recovers_straggler_and_dedups_first_writer():
    member_ids = ["w0", "w1", "w2"]
    splits = make_splits(3)
    slow_id = nodes_for_split(splits[0].split_id, member_ids)[0]
    workers = [FakeWorker(w, delay=3.0 if w == slow_id else 0.0)
               for w in member_ids]
    dispatcher = OffloadDispatcher(build_pool(workers), task_splits=1,
                                   hedge_min_delay_secs=0.05)
    t0 = time.monotonic()
    outcome = dispatcher.dispatch(make_request(splits),
                                  deadline=Deadline.after(10.0))
    elapsed = time.monotonic() - t0
    assert elapsed < 2.0, "hedge never cut off the 3s straggler"
    assert outcome.unserved == []
    assert outcome.stats["hedges"] >= 1
    assert outcome.stats["hedges_won"] >= 1
    # first-writer-wins: the straggler's late response is discarded, every
    # split counted exactly once
    assert sum(r.num_successful_splits for r in outcome.responses) == 3


def test_idle_worker_steals_queued_backlog():
    member_ids = ["w0", "w1"]
    # craft splits that ALL hash to one primary so the other starts idle
    victims = [s for s in make_splits(200, prefix="steal")
               if nodes_for_split(s.split_id, member_ids)[0] == "w0"][:6]
    assert len(victims) == 6
    workers = [FakeWorker("w0", delay=0.15), FakeWorker("w1")]
    dispatcher = OffloadDispatcher(build_pool(workers), task_splits=1)
    outcome = dispatcher.dispatch(make_request(victims),
                                  deadline=Deadline.after(10.0))
    assert outcome.unserved == []
    assert outcome.stats["steals"] >= 1
    assert workers[1].requests, "idle worker never received stolen work"
    assert sum(r.num_successful_splits for r in outcome.responses) == 6


def test_dispatch_with_no_workers_returns_everything_unserved():
    dispatcher = OffloadDispatcher(WorkerPool())
    splits = make_splits(4)
    outcome = dispatcher.dispatch(make_request(splits),
                                  deadline=Deadline.after(1.0))
    assert [s.split_id for s in outcome.unserved] == \
        [s.split_id for s in splits]
    assert outcome.stats.get("no_workers") == 1


def test_expired_deadline_dispatches_nothing():
    worker = FakeWorker("w0")
    dispatcher = OffloadDispatcher(build_pool([worker]))
    outcome = dispatcher.dispatch(make_request(make_splits(4)),
                                  deadline=Deadline.after(0.0))
    assert len(outcome.unserved) == 4
    assert worker.requests == []


def test_all_workers_dead_leaves_splits_unserved_not_raised():
    workers = [FakeWorker(f"w{i}", exc=RuntimeError("down"))
               for i in range(2)]
    dispatcher = OffloadDispatcher(build_pool(workers), task_splits=2)
    outcome = dispatcher.dispatch(make_request(make_splits(6)),
                                  deadline=Deadline.after(5.0))
    assert len(outcome.unserved) == 6  # caller falls back locally
    assert outcome.stats["tasks_failed"] >= 1


def test_subrequest_reserializes_remaining_budget():
    worker = FakeWorker("w0")
    dispatcher = OffloadDispatcher(build_pool([worker]))
    dispatcher.dispatch(make_request(make_splits(2)),
                        deadline=Deadline.after(5.0))
    assert worker.requests
    for request in worker.requests:
        assert request.deadline_millis is not None
        assert request.deadline_millis <= 5_000


# --- typed backpressure ------------------------------------------------------


def test_backpressure_raises_out_of_dispatch_untried():
    workers = [FakeWorker("w0", exc=OverloadShed("worker", 0.5)),
               FakeWorker("w1", exc=OverloadShed("worker", 0.5))]
    dispatcher = OffloadDispatcher(build_pool(workers))
    with pytest.raises(OverloadShed):
        dispatcher.dispatch(make_request(make_splits(4)),
                            deadline=Deadline.after(5.0))


def test_typed_backpressure_classifier():
    shed = OverloadShed("queue", 0.5)
    limited = TenantRateLimited("t1", "qps", 0.5)
    assert typed_backpressure_of(shed) is shed
    assert typed_backpressure_of(limited) is limited
    assert typed_backpressure_of(RuntimeError("boom")) is None
    assert typed_backpressure_of(
        HttpStatusError("500", status=500, body=b"")) is None
    # remote 429s reconstruct the typed exception from the wire body
    rate_body = json.dumps({"status": 429, "error": {
        "type": "rate_limit_exceeded", "reason": "tenant t1"}}).encode()
    assert isinstance(
        typed_backpressure_of(HttpStatusError("429", 429, rate_body)),
        TenantRateLimited)
    shed_body = json.dumps({"status": 429, "error": {
        "type": "overloaded", "reason": "queue"}}).encode()
    assert isinstance(
        typed_backpressure_of(HttpStatusError("429", 429, shed_body)),
        OverloadShed)
    # unparseable 429 body still counts as backpressure, not a retry
    assert isinstance(
        typed_backpressure_of(HttpStatusError("429", 429, b"\xff")),
        OverloadShed)


# --- autoscaler --------------------------------------------------------------


class FakeOverload:
    def __init__(self, value=0.0):
        self.value = value

    def severity(self):
        return self.value


def scaler_fixture(max_workers=4, queue_per_worker=4, cooldown=5.0,
                   static=()):
    clock = FakeClock()
    overload = FakeOverload()
    pool = WorkerPool(clock=clock)
    for worker_id in static:
        pool.add_worker(worker_id, FakeWorker(worker_id))
    launcher = InProcessWorkerLauncher(service_factory=FakeWorker)
    scaler = Autoscaler(pool, launcher, min_workers=1,
                        max_workers=max_workers,
                        queue_per_worker=queue_per_worker,
                        scale_down_cooldown_secs=cooldown,
                        overload=overload, clock=clock)
    return pool, launcher, scaler, overload, clock


def test_autoscaler_tracks_queue_depth_with_cooldown():
    pool, launcher, scaler, overload, clock = scaler_fixture()
    assert scaler.tick(0) == 1                 # min floor
    assert scaler.tick(16) == 4                # ceil(16/4)
    assert scaler.tick(0) == 4                 # cooldown holds the fleet
    clock.advance(5.0)
    assert scaler.tick(0) == 1                 # calm + cooled: shrink
    assert launcher.live_workers() == pool.worker_ids()


def test_autoscaler_overload_severity_forces_growth():
    pool, _, scaler, overload, _ = scaler_fixture()
    scaler.tick(0)
    overload.value = 2.5  # shedding: queue depth understates demand
    assert scaler.tick(0) == 1 + 2  # current + ceil(severity - 1)
    overload.value = 1.5
    assert scaler.tick(0) == 4      # keeps climbing while severity > 1
    # severity > 1 also BLOCKS scale-down regardless of cooldown
    overload.value = 1.2
    assert scaler.tick(0) == 4


def test_autoscaler_spares_static_and_busy_workers():
    pool, launcher, scaler, overload, clock = scaler_fixture(
        static=("static-0",))
    assert scaler.tick(12) == 3  # static-0 + auto-1 + auto-2
    managed = [w for w in pool.worker_ids() if w.startswith("auto-")]
    busy = managed[0]
    pool.begin_dispatch(busy)
    clock.advance(5.0)
    scaler.tick(0)
    # desired=1 but only the idle managed worker was removable
    assert "static-0" in pool
    assert busy in pool
    assert pool.size() == 2
    pool.note_result(busy, ok=True)
    clock.advance(5.0)
    assert scaler.tick(0) == 1
    assert "static-0" in pool  # never terminates configured membership


def test_autoscaler_rejects_inverted_bounds():
    pool = WorkerPool()
    with pytest.raises(ValueError):
        Autoscaler(pool, InProcessWorkerLauncher(device="cpu"),
                   min_workers=4, max_workers=2)


# --- the port's launcher takes its workers' device ---------------------------


def test_in_process_launcher_needs_and_passes_its_device():
    from quickwit_tpu_torch.storage import StorageResolver
    with pytest.raises(ValueError, match="device"):
        InProcessWorkerLauncher(StorageResolver.for_test())
    launcher = InProcessWorkerLauncher(StorageResolver.for_test(),
                                       device="cpu")
    client = launcher.launch("auto-1")
    assert str(client.service.context.device) == "cpu"
    assert client.service.context.prefetch is False
    assert launcher.live_workers() == ["auto-1"]
    launcher.terminate("auto-1")
    assert launcher.live_workers() == []


# --- both packages, one scenario --------------------------------------------

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def package(root):
    import importlib
    from types import SimpleNamespace

    def mod(path):
        return importlib.import_module(f"{root}.{path}")
    offload = mod("offload")
    return SimpleNamespace(
        offload=offload, metrics=mod("observability.metrics"),
        models=mod("search.models"), ast=mod("query.ast"),
        Deadline=mod("common.deadline").Deadline)


def splits_of(q, count, prefix="split"):
    return [q.models.SplitIdAndFooter(split_id=f"{prefix}-{i:03d}",
                                      storage_uri="ram:///offload")
            for i in range(count)]


class PackageWorker:
    """`FakeWorker` answering with its own package's response type."""

    def __init__(self, q, worker_id, exc=None):
        self.q, self.worker_id, self.exc = q, worker_id, exc
        self.splits = []

    def leaf_search(self, request):
        self.splits += [s.split_id for s in request.splits]
        if self.exc is not None:
            raise self.exc
        return self.q.models.LeafSearchResponse(
            num_hits=10 * len(request.splits),
            num_successful_splits=len(request.splits))


def on_both(scenario):
    out = {root: scenario(package(root)) for root in PACKAGES}
    assert out["quickwit_tpu_torch"] == out["quickwit_tpu"]
    return out["quickwit_tpu_torch"]


def test_placement_equal_across_packages():
    def plan(q):
        dispatcher = q.offload.OffloadDispatcher(q.offload.WorkerPool(),
                                                 task_splits=3)
        return {worker: [[s.split_id for s in task.splits]
                         + [task.preference] for task in tasks]
                for worker, tasks in dispatcher.plan_tasks(
                    splits_of(q, 200), [f"w{i}" for i in range(7)]).items()}
    planned = on_both(plan)
    assert sum(len(run) - 1 for tasks in planned.values()
               for run in tasks) == 200


def test_health_transitions_and_gauge_equal_across_packages():
    def transitions(q):
        clock = FakeClock()
        pool = q.offload.WorkerPool(suspect_after=1, eject_after=2,
                                    readmit_backoff_secs=1.0,
                                    readmit_backoff_max_secs=8.0,
                                    clock=clock)
        for worker_id in ("w0", "w1"):
            pool.add_worker(worker_id, PackageWorker(q, worker_id))
        seen = []
        for ok, advance in ((False, 0), (False, 0), (True, 0), (False, 1.0),
                            (False, 1.0), (False, 2.0), (True, 0)):
            clock.advance(advance)
            candidates = pool.candidates()
            if "w0" in candidates:
                pool.note_result("w0", ok=ok)
            seen.append((tuple(candidates), pool.state_of("w0"),
                         tuple(q.metrics.OFFLOAD_POOL_WORKERS.get(state=s)
                               for s in ("healthy", "suspect", "ejected"))))
        return seen, pool.snapshot()
    on_both(transitions)


def test_dispatch_outcomes_and_metric_deltas_equal_across_packages():
    series = (("OFFLOAD_SPLITS_TOTAL", {"outcome": "remote"}),
              ("OFFLOAD_SPLITS_TOTAL", {"outcome": "fallback_local"}),
              ("OFFLOAD_DISPATCHES_TOTAL", {"outcome": "ok"}),
              ("OFFLOAD_DISPATCHES_TOTAL", {"outcome": "error"}),
              ("OFFLOAD_HEDGES_TOTAL", {"outcome": "launched"}),
              ("OFFLOAD_QUEUE_DEPTH", {}))

    def values(q):
        return [getattr(q.metrics, name).get(**labels)
                for name, labels in series]

    def scenarios(q):
        out = []
        # three healthy workers, every task started at once (no queue to
        # steal from) and no hedge inside the run
        workers = [PackageWorker(q, f"w{i}") for i in range(3)]
        pool = q.offload.WorkerPool()
        for w in workers:
            pool.add_worker(w.worker_id, w)
        dispatcher = q.offload.OffloadDispatcher(
            pool, task_splits=2, max_inflight_per_worker=8,
            hedge_min_delay_secs=30.0)
        req = q.models.LeafSearchRequest(
            search_request=q.models.SearchRequest(
                index_ids=["i"], query_ast=q.ast.MatchAll()),
            index_uid="i:01", doc_mapping={}, splits=splits_of(q, 10))
        before = values(q)
        outcome = dispatcher.dispatch(req, deadline=q.Deadline.after(10.0))
        out.append(("healthy", [a - b for a, b in zip(values(q), before)],
                    sorted(sorted(w.splits) for w in workers),
                    [s.split_id for s in outcome.unserved],
                    sum(r.num_successful_splits for r in outcome.responses),
                    outcome.stats))
        # no workers, then an expired deadline: everything comes back
        for name, pool, deadline in (
                ("no_workers", q.offload.WorkerPool(), 1.0),
                ("expired", pool, 0.0)):
            before = values(q)
            outcome = q.offload.OffloadDispatcher(pool).dispatch(
                req, deadline=q.Deadline.after(deadline))
            out.append((name, [a - b for a, b in zip(values(q), before)],
                        [s.split_id for s in outcome.unserved],
                        outcome.stats))
        return out

    got = on_both(scenarios)
    healthy = got[0]
    # 5, 3 and 2 splits by rendezvous: tasks of at most 2 splits
    assert healthy[1][:4] == [10, 0, 6, 0] and healthy[3] == []
    assert healthy[4] == 10
    assert got[1][1][:2] == [0, 10] and got[2][1][:2] == [0, 10]


def test_autoscaler_decisions_equal_across_packages():
    def decisions(q):
        clock = FakeClock()
        overload = FakeOverload()
        pool = q.offload.WorkerPool(clock=clock)
        pool.add_worker("static-0", PackageWorker(q, "static-0"))
        launcher = q.offload.InProcessWorkerLauncher(
            service_factory=lambda worker_id: PackageWorker(q, worker_id))
        scaler = q.offload.Autoscaler(
            pool, launcher, min_workers=1, max_workers=6,
            queue_per_worker=4, scale_down_cooldown_secs=5.0,
            overload=overload, clock=clock)
        before = [q.metrics.OFFLOAD_AUTOSCALE_TOTAL.get(direction=d)
                  for d in ("up", "down")]
        sizes = []
        for depth, severity, advance in ((0, 0.0, 0), (16, 0.0, 0),
                                         (0, 2.5, 0), (0, 1.2, 5.0),
                                         (0, 0.0, 5.0), (40, 0.0, 0),
                                         (0, 0.0, 1.0), (0, 0.0, 5.0)):
            overload.value = severity
            clock.advance(advance)
            sizes.append((scaler.tick(depth), tuple(pool.worker_ids())))
        return sizes, [q.metrics.OFFLOAD_AUTOSCALE_TOTAL.get(direction=d) - b
                       for d, b in zip(("up", "down"), before)]
    sizes, events = on_both(decisions)
    assert sizes[-1][1] == ("static-0",) and events[0] == events[1]
