"""The port's threaded `QueryBatcher` (search/batcher.py) on the CPU.

Concurrent queries on one split coalesce: distinct shape-compatible queries
into one stacked dispatch, same-array queries into a convoy under
`QW_DISABLE_QBATCH`. Every rider's result equals its solo run, of the port
and of the JAX package. The shed rules (deadline, cancel, overload) at
enqueue, wait, dispatch and readback, the priority handoff of the dispatch
lock, the per-rider profile phases and the waiter error copies follow the
JAX package's `tests/test_query_batcher.py` and the batcher cases of
`tests/test_query_batching.py` / `tests/test_chunked_execution.py`.

Every thread join and event wait takes a timeout: a deadlock fails its
test instead of stalling the suite.
"""

import threading
import time

import pytest

from quickwit_tpu_torch.common.deadline import (
    CancellationToken, CancelledQuery, Deadline, DeadlineExceeded,
    cancel_scope, deadline_scope,
)
from quickwit_tpu_torch.observability.metrics import (
    QBATCH_GROUPS_TOTAL, QBATCH_MASKED_RIDERS_TOTAL,
    QBATCH_QUERIES_PER_DISPATCH, RESIDENT_READBACKS_SHED,
    SEARCH_KERNEL_LAUNCHES_TOTAL, SEARCH_SHED_TOTAL,
)
from quickwit_tpu_torch.observability.profile import (
    PHASE_BATCHER_QUEUE, PHASE_QBATCH_GROUP, QueryProfile, profile_scope,
)
from quickwit_tpu_torch.search import batcher as batcher_mod
from quickwit_tpu_torch.search import executor as t_ex
from quickwit_tpu_torch.search.batcher import (
    QueryBatcher, _Pending, _PriorityLock, _waiter_error, qbatch_enabled,
)
from quickwit_tpu_torch.tenancy.overload import OVERLOAD, OverloadShed

from test_torch_chunked import assert_same_result
from test_torch_query_batching import (
    SEVS, T0, Query, sev, window, write_split,
)

JOIN_SECS = 60.0


@pytest.fixture(scope="module")
def split():
    return write_split(300, 9, "batcher")


@pytest.fixture(autouse=True)
def calm_overload():
    yield
    OVERLOAD.reset()
    OVERLOAD.configure(enabled=False, target_wait_secs=0.5)


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_SECS)
    assert not any(t.is_alive() for t in threads), "a rider never returned"


def _windows(split, n, **kw):
    kw.setdefault("max_hits", 5)
    return [Query(split, window(T0 + 300 * i, T0 + 300 * (i + 3)), **kw)
            for i in range(n)]


def run_group(batcher, queries, k, cancel_idx=None, profiles=None,
              split_key="s"):
    """Deterministic group formation: hold the key's dispatch lock so the
    riders pile into one queue, optionally cancel one AFTER it joined,
    then release and let the leader dispatch. Returns each rider's result
    or exception."""
    key = batcher.planner.key_for(queries[0].plan, k, split_key,
                                  qbatch_enabled())
    assert all(batcher.planner.key_for(q.plan, k, split_key,
                                       qbatch_enabled()) == key
               for q in queries)
    entry = batcher._dispatch_locks.setdefault(key, [_PriorityLock(), 1])
    entry[0].acquire()
    results = [None] * len(queries)
    tokens = [CancellationToken() for _ in queries]

    def rider(i):
        q = queries[i]
        try:
            with cancel_scope(tokens[i]), profile_scope(
                    profiles[i] if profiles is not None else None):
                results[i] = batcher.execute(q.plan, k, q.arrays,
                                             split_key=split_key,
                                             device="cpu")
        except Exception as exc:  # noqa: BLE001 - recorded for asserts
            results[i] = exc

    threads = [threading.Thread(target=rider, args=(i,), daemon=True)
               for i in range(len(queries))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10.0
    while (len(batcher._queues.get(key, ())) < len(queries)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert len(batcher._queues.get(key, ())) == len(queries)
    if cancel_idx is not None:
        tokens[cancel_idx].cancel("shed after group formation")
    entry[0].release()
    _join(threads)
    with batcher._lock:
        entry[1] -= 1
        if entry[1] <= 0:
            batcher._dispatch_locks.pop(key, None)
    return results


def assert_matches_solo(results, queries, k):
    for lane, (got, q) in enumerate(zip(results, queries)):
        assert not isinstance(got, Exception), got
        assert_same_result(q.solo(k), got, f"rider {lane} vs port solo")
        assert_same_result(q.jax_solo(k), got, f"rider {lane} vs jax solo")


# --- coalescing ---------------------------------------------------------------

def test_concurrent_queries_coalesce_and_match(split):
    queries = _windows(split, 12)
    batcher = QueryBatcher(max_batch=8)
    results = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def worker(i):
        try:
            barrier.wait(timeout=JOIN_SECS)
            q = queries[i]
            results[i] = batcher.execute(q.plan, 5, q.arrays,
                                         split_key="s", device="cpu")
        except Exception as exc:  # noqa: BLE001 - recorded for asserts
            results[i] = exc

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(queries))]
    for t in threads:
        t.start()
    _join(threads)
    assert_matches_solo(results, queries, 5)
    assert batcher.num_queries == len(queries)
    assert batcher.num_dispatches <= batcher.num_queries
    assert not batcher._dispatch_locks


@pytest.mark.parametrize("stacking", [True, False])
def test_queries_coalesce_under_slow_dispatch(split, monkeypatch, stacking):
    """With dispatch latency injected, queries arriving during an in-flight
    dispatch MUST ride a shared one: a stacked group with stacking on, a
    convoy with it off."""
    if not stacking:
        monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    real_single = t_ex.execute_plan
    real_multi = t_ex.dispatch_plan_multi
    real_stacked = t_ex.dispatch_plan_stacked

    def slow(fn):
        def wrapped(*args, **kw):
            time.sleep(0.15)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(t_ex, "execute_plan", slow(real_single))
    monkeypatch.setattr(t_ex, "dispatch_plan_multi", slow(real_multi))
    monkeypatch.setattr(t_ex, "dispatch_plan_stacked", slow(real_stacked))
    q = _windows(split, 1)[0]
    single = q.solo(5)
    batcher = QueryBatcher()
    results = [None] * 8
    started = threading.Event()

    def worker(i):
        if i == 0:
            started.set()
        else:
            assert started.wait(timeout=JOIN_SECS)
        results[i] = batcher.execute(q.plan, 5, q.arrays, split_key="s",
                                     device="cpu")

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(8)]
    threads[0].start()
    time.sleep(0.03)   # leader 0 is now inside its slow dispatch
    for t in threads[1:]:
        t.start()
    _join(threads)
    assert batcher.num_dispatches < batcher.num_queries == 8
    for got in results:
        assert_same_result(single, got)
    assert not batcher._dispatch_locks


def test_different_arrays_never_share_a_convoy(split, monkeypatch):
    """Term ERROR vs INFO under the kill switch: one structure, different
    arrays; the convoy key separates them and results stay exact."""
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    batcher = QueryBatcher()
    total = 0
    for term in SEVS:
        q = Query(split, sev(term), max_hits=3)
        got = batcher.execute(q.plan, 3, q.arrays, split_key="s",
                              device="cpu")
        assert_same_result(q.solo(3), got)
        total += got["count"]
    assert total == 300   # the three terms partition the corpus
    assert batcher.num_dispatches == batcher.num_queries == 3


def test_batcher_propagates_errors():
    class BoomPlan:
        array_keys = ("x",)
        scalars = ()

        def signature(self, k):
            return ("boom", k)

    with pytest.raises(Exception):
        QueryBatcher().execute(BoomPlan(), 1, [], split_key=0, device="cpu")


# --- stacked groups -------------------------------------------------------------

def test_groups_distinct_queries_into_one_launch(split):
    queries = _windows(split, 3, max_hits=6, sort=[("ts", "desc")])
    batcher = QueryBatcher()
    groups = QBATCH_GROUPS_TOTAL.get()
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    results = run_group(batcher, queries, 6)
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert QBATCH_GROUPS_TOTAL.get() - groups == 1
    assert_matches_solo(results, queries, 6)
    assert batcher.num_dispatches == 1 and batcher.num_queries == 3
    assert not batcher._dispatch_locks


def test_term_group_shares_one_lane_kernel_call(split, monkeypatch):
    queries = [Query(split, sev(s), max_hits=10) for s in SEVS]
    calls = []
    real = t_ex.score_topk_lanes
    monkeypatch.setattr(t_ex, "score_topk_lanes",
                        lambda lanes, k: calls.append(len(lanes))
                        or real(lanes, k))
    results = run_group(QueryBatcher(), queries, 10)
    assert calls == [3]
    assert_matches_solo(results, queries, 10)


def test_masked_rider_keeps_single_launch_and_survivors_exact(split):
    """A rider cancelled after group formation but before the launch is
    masked (validity flag), not rebuilt around: one dispatch, no new
    program, survivors equal to solo, a typed CancelledQuery for it."""
    queries = _windows(split, 3, max_hits=6, sort=[("ts", "desc")])
    t_ex.readback_plan_stacked(t_ex.dispatch_plan_stacked(
        [q.plan for q in queries], 6, [q.arrays for q in queries],
        device="cpu"))
    cache_size = len(t_ex._STACKED_CACHE)
    batcher = QueryBatcher()
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    masked = QBATCH_MASKED_RIDERS_TOTAL.get()
    results = run_group(batcher, queries, 6, cancel_idx=1)
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert len(t_ex._STACKED_CACHE) == cache_size
    assert QBATCH_MASKED_RIDERS_TOTAL.get() - masked == 1
    assert isinstance(results[1], CancelledQuery)
    assert_matches_solo([results[0], results[2]], [queries[0], queries[2]],
                        6)
    assert batcher.num_dispatches == 1


def test_group_riders_get_group_wait_phase(split):
    queries = [Query(split, sev(s), max_hits=5) for s in SEVS]
    profiles = [QueryProfile(f"q{i}") for i in range(3)]
    results = run_group(QueryBatcher(), queries, 5, profiles=profiles)
    assert not any(isinstance(r, Exception) for r in results)
    for lane, prof in enumerate(profiles):
        names = [p["name"] for p in prof.phases()]
        assert PHASE_QBATCH_GROUP in names
        assert PHASE_BATCHER_QUEUE not in names
        group = next(p for p in prof.phases()
                     if p["name"] == PHASE_QBATCH_GROUP)
        assert group["riders"] == 3
        assert prof._counters["qbatch_group_size"] == 3.0
        assert prof._counters["qbatch_lane_index"] == float(lane)


def test_queries_per_dispatch_histogram_observes_live_lanes(split):
    queries = [Query(split, sev(s), max_hits=5) for s in SEVS]
    before = QBATCH_QUERIES_PER_DISPATCH._totals.get((), 0)
    run_group(QueryBatcher(), queries, 5)
    assert QBATCH_QUERIES_PER_DISPATCH._totals.get((), 0) == before + 1
    assert QBATCH_QUERIES_PER_DISPATCH.percentile(0.5) <= 4.0


def test_kill_switch_restores_convoy_behaviour(split, monkeypatch):
    """QW_DISABLE_QBATCH: distinct-term queries lead separate queues, each
    dispatches alone, the qbatch metrics stay silent, and the results equal
    the stacking-on results bit for bit."""
    batcher_on = QueryBatcher()
    stacked = []
    for s in SEVS:
        q = Query(split, sev(s), max_hits=10)
        stacked.append(batcher_on.execute(q.plan, 10, q.arrays,
                                          split_key="s", device="cpu"))
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    assert not qbatch_enabled()
    groups = QBATCH_GROUPS_TOTAL.get()
    batcher = QueryBatcher()
    for s, want in zip(SEVS, stacked):
        q = Query(split, sev(s), max_hits=10)
        assert_same_result(want, batcher.execute(q.plan, 10, q.arrays,
                                                 split_key="s",
                                                 device="cpu"))
    assert batcher.num_dispatches == batcher.num_queries == 3
    assert QBATCH_GROUPS_TOTAL.get() == groups


def test_solo_rider_result_identical_on_and_off(split, monkeypatch):
    q = Query(split, sev("ERROR"), max_hits=10)
    base = q.solo(10)
    on = QueryBatcher().execute(q.plan, 10, q.arrays, split_key="s",
                                device="cpu")
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    off = QueryBatcher().execute(q.plan, 10, q.arrays, split_key="s",
                                 device="cpu")
    assert_same_result(base, on)
    assert_same_result(base, off)


def test_convoy_group_under_the_kill_switch(split, monkeypatch):
    """Same-array riders (window bounds differ only in scalars) under the
    kill switch ride ONE convoy dispatch: one launch, exact lanes."""
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    queries = _windows(split, 3, max_hits=6, sort=[("ts", "desc")])
    calls = []
    real = t_ex.dispatch_plan_multi
    monkeypatch.setattr(t_ex, "dispatch_plan_multi",
                        lambda *a, **kw: calls.append(len(a[3]))
                        or real(*a, **kw))
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    results = run_group(QueryBatcher(), queries, 6)
    assert calls == [3]
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert_matches_solo(results, queries, 6)


# --- sheds: enqueue, wait, dispatch, readback -----------------------------------

def test_pre_cancelled_rider_is_refused_at_enqueue(split):
    q = Query(split, sev("ERROR"), max_hits=10)
    token = CancellationToken()
    token.cancel("already dead")
    batcher = QueryBatcher()
    with cancel_scope(token), pytest.raises(CancelledQuery):
        batcher.execute(q.plan, 10, q.arrays, split_key="s", device="cpu")
    assert batcher.num_queries == 0


def test_overload_sheds_at_enqueue(split):
    from quickwit_tpu_torch.tenancy.context import TenantContext, tenant_scope
    OVERLOAD.configure(enabled=True, target_wait_secs=0.01)
    for _ in range(20):
        OVERLOAD.note_wait(1.0)
    assert OVERLOAD.shed_floor() > 0
    q = Query(split, sev("ERROR"), max_hits=10)
    shed = SEARCH_SHED_TOTAL.get(stage="overload_batcher")
    with tenant_scope(TenantContext("bg", priority=0)), \
            pytest.raises(OverloadShed):
        QueryBatcher().execute(q.plan, 10, q.arrays, split_key="s",
                               device="cpu")
    assert SEARCH_SHED_TOTAL.get(stage="overload_batcher") == shed + 1


def _stuck_queue(batcher, q, k):
    """A queue whose leader never dispatches, so a rider waits in it."""
    key = batcher.planner.key_for(q.plan, k, "s", qbatch_enabled())
    batcher._queues[key] = [_Pending(q.plan.scalars)]


def test_follower_cancel_unblocks_promptly(split):
    q = Query(split, sev("ERROR"), max_hits=10)
    batcher = QueryBatcher()
    _stuck_queue(batcher, q, 10)
    token = CancellationToken()
    timer = threading.Timer(0.1, lambda: token.cancel("user gave up"))
    timer.start()
    t0 = time.monotonic()
    with deadline_scope(Deadline.after(30.0)), cancel_scope(token):
        with pytest.raises(CancelledQuery):
            batcher.execute(q.plan, 10, q.arrays, split_key="s",
                            device="cpu")
    timer.join(timeout=JOIN_SECS)
    assert time.monotonic() - t0 < 5.0


def test_follower_deadline_sheds_its_wait(split):
    q = Query(split, sev("ERROR"), max_hits=10)
    batcher = QueryBatcher()
    _stuck_queue(batcher, q, 10)
    shed = SEARCH_SHED_TOTAL.get(stage="batcher_wait")
    t0 = time.monotonic()
    with deadline_scope(Deadline.after(0.1)), \
            pytest.raises(DeadlineExceeded):
        batcher.execute(q.plan, 10, q.arrays, split_key="s", device="cpu")
    assert time.monotonic() - t0 < 5.0
    assert SEARCH_SHED_TOTAL.get(stage="batcher_wait") == shed + 1


@pytest.mark.parametrize("why", ["cancel", "deadline"])
def test_leader_sheds_a_dead_rider_at_dispatch(split, why):
    """The leader drops a cancelled or expired follower at dispatch time:
    it gets a typed error, the live rider a real result."""
    q = Query(split, sev("ERROR"), max_hits=10)
    batcher = QueryBatcher()
    results = {}

    def leader():
        try:
            results["live"] = batcher.execute(q.plan, 10, q.arrays,
                                              split_key="s", device="cpu")
        except Exception as exc:  # noqa: BLE001 - recorded for asserts
            results["live"] = exc

    key = batcher.planner.key_for(q.plan, 10, "s", qbatch_enabled())
    entry = batcher._dispatch_locks.setdefault(key, [_PriorityLock(), 1])
    entry[0].acquire()
    thread = threading.Thread(target=leader, daemon=True)
    thread.start()
    deadline = time.monotonic() + 5.0
    while key not in batcher._queues and time.monotonic() < deadline:
        time.sleep(0.005)
    token = CancellationToken()
    doomed = (_Pending(q.plan.scalars, None, None, token) if why == "cancel"
              else _Pending(q.plan.scalars, Deadline.after(0.0)))
    batcher._queues[key].append(doomed)
    if why == "cancel":
        token.cancel("rider cancelled in flight")
    entry[0].release()
    _join([thread])
    with batcher._lock:
        entry[1] -= 1
        if entry[1] <= 0:
            batcher._dispatch_locks.pop(key, None)
    assert_same_result(q.solo(10), results["live"])
    assert doomed.event.is_set()
    assert isinstance(doomed.error, CancelledQuery if why == "cancel"
                      else DeadlineExceeded)


class _AtDispatch:
    """A fault injector whose `batcher.dispatch` point runs `action`."""

    def __init__(self, action):
        self.action = action

    def perturb(self, operation):
        if operation == "batcher.dispatch":
            self.action()


def test_readback_is_shed_when_every_rider_is_gone(split):
    """Every rider cancelled after the dispatch: nobody can use the answer,
    so the readback is never awaited (qw_resident_readbacks_shed_total)
    and each rider gets a typed CancelledQuery."""
    queries = [Query(split, sev(s), max_hits=5) for s in SEVS]
    tokens = []
    batcher = QueryBatcher(fault_injector=_AtDispatch(
        lambda: [t.cancel("gone") for t in tokens]))
    shed = RESIDENT_READBACKS_SHED.get()
    key = batcher.planner.key_for(queries[0].plan, 5, "s", True)
    entry = batcher._dispatch_locks.setdefault(key, [_PriorityLock(), 1])
    entry[0].acquire()
    results = [None] * 3

    def rider(i):
        token = CancellationToken()
        tokens.append(token)
        try:
            with cancel_scope(token):
                results[i] = batcher.execute(queries[i].plan, 5,
                                             queries[i].arrays,
                                             split_key="s", device="cpu")
        except Exception as exc:  # noqa: BLE001 - recorded for asserts
            results[i] = exc

    threads = [threading.Thread(target=rider, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10.0
    while (len(batcher._queues.get(key, ())) < 3
           and time.monotonic() < deadline):
        time.sleep(0.005)
    entry[0].release()
    _join(threads)
    assert RESIDENT_READBACKS_SHED.get() == shed + 1
    assert all(isinstance(r, CancelledQuery) for r in results)


def test_dispatch_error_reaches_every_rider_as_its_own_copy(split):
    queries = [Query(split, sev(s), max_hits=5) for s in SEVS]

    def boom():
        raise RuntimeError("device lost")

    results = run_group(QueryBatcher(fault_injector=_AtDispatch(boom)),
                        queries, 5)
    assert all(isinstance(r, RuntimeError) for r in results)
    assert len({id(r) for r in results}) == 3
    causes = {id(r.__cause__) for r in results if r.__cause__ is not None}
    assert len(causes) == 1   # the followers' copies chain to one error


# --- the priority lock and the waiter error -------------------------------------

def test_priority_lock_hands_off_by_priority_then_fifo():
    lock = _PriorityLock()
    lock.acquire()
    order = []

    def waiter(name, priority):
        lock.acquire(priority)
        order.append(name)
        lock.release()

    threads = []
    for name, priority in (("low", 0), ("high", 5), ("mid", 1),
                           ("high2", 5)):
        before = len(lock._waiters)
        t = threading.Thread(target=waiter, args=(name, priority),
                             daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5.0
        while len(lock._waiters) == before and time.monotonic() < deadline:
            time.sleep(0.002)
    lock.release()
    _join(threads)
    assert order == ["high", "high2", "mid", "low"]


def test_waiter_error_is_a_fresh_copy_chained_to_the_original():
    err = ValueError("bad lane", 3)
    copy = _waiter_error(err)
    assert copy is not err and type(copy) is ValueError
    assert copy.args == err.args and copy.__cause__ is err
    # a typed error keeps its type (its message is rebuilt from its
    # formatted args, as in the JAX package)
    err = CancelledQuery("batched dispatch", "why")
    copy = _waiter_error(err)
    assert type(copy) is CancelledQuery and copy.__cause__ is err
    assert str(err) in str(copy)

    class Exotic(Exception):
        def __init__(self, a, b):
            super().__init__(a + b)

    odd = Exotic(1, 2)
    copy = _waiter_error(odd)
    assert isinstance(copy, RuntimeError) and copy.__cause__ is odd


def test_leaf_routes_through_the_batcher(split, monkeypatch):
    """`execute_prepared_split(batcher=...)` answers as without one, with
    stacking on (the batcher first) and off (the chunked check first)."""
    from quickwit_tpu_torch.search import leaf
    from quickwit_tpu_torch.search.models import SearchRequest
    from quickwit_tpu_torch.query import ast as TQ
    from test_torch_query_batching import T_MAPPER

    req = SearchRequest(index_ids=["t"], query_ast=TQ.Term("sev", "ERROR"),
                        max_hits=10)
    plan, arrays, _ = leaf.prepare_single_split(req, T_MAPPER, split.t_reader,
                                                "s", device="cpu")

    def run(batcher):
        resp = leaf.execute_prepared_split(req, T_MAPPER, split.t_reader,
                                           "s", plan, arrays, "cpu",
                                           batcher=batcher)
        return resp.num_hits, [(h.doc_id, h.sort_value)
                               for h in resp.partial_hits]

    base = run(None)
    batcher = QueryBatcher()
    assert run(batcher) == base and batcher.num_queries == 1
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    assert run(batcher) == base and batcher.num_queries == 2
    assert batcher_mod.qbatch_enabled() is False
