"""Cross-query dispatch coalescing and query-axis stacking on the device.

Counterpart of the JAX package's `search/batcher.py`. Two grouping regimes
share this module's convoy machinery:

* Convoy coalescing (the whole behaviour under `QW_DISABLE_QBATCH`):
  concurrent queries that lower to the SAME plan structure (signature) and
  the SAME device arrays on one split differ only in their scalars (term
  idf, range bounds, agg origins, markers). The batcher runs them as ONE
  lane group via `executor.dispatch_plan_multi`: one dispatch round and one
  packed readback for the whole batch.

* Query-axis stacking (default): the `QueryGroupPlanner` widens the
  grouping key to the STRUCTURAL signature only, so N DISTINCT queries
  (different terms, filters, thresholds, sort markers) over one split
  group together as long as their lowered plans share a structure digest.
  The group runs as ONE stacked dispatch (`executor.dispatch_plan_stacked`):
  operand slots whose cache key agrees across the group are served from
  one staged tensor, the rest from each lane's own, each lane keeps its
  own scalars (its killing threshold included), the fused step of all
  lanes is one `score_topk_lanes` launch, and a validity mask drops riders
  shed AFTER group formation: a late cancel or deadline never rebuilds the
  group. Groups compose with chunked execution
  (`chunkexec.execute_group_chunked`: one carried state per lane,
  per-lane masks at chunk boundaries).

Why: each dispatch round costs the host a fixed overhead (the leaf program's
host work and its synchronizing readback) while the work inside one
dispatch runs at device speed. Batching concurrent requests per dispatch is
also the reference's own shape: leaf requests are batched per node
(`quickwit-search/src/leaf.rs:81` greedy_batch_split).

Batching is convoy-style: dispatches for one key are serialized by a
per-key lock, so queries arriving while a dispatch is in flight pile up and
ride the next dispatch together. A lone query pays ZERO added latency: the
lock is free and it dispatches immediately. The lock is released after the
dispatch and before the readback, so the next convoy enqueues while this
one's copy to the host is in flight.

Deadline behaviour: every rider carries its ambient deadline. Followers
wait bounded (never past their own expiry plus a small leader-signal
slack); at dispatch time the leader sheds already-expired riders with
`DeadlineExceeded` but still dispatches for the live ones: a leader must
never orphan its followers.

A batcher serves one device: a `SearcherContext` owns one, and
`split_key` (the reader's identity) names a split of that device."""

from __future__ import annotations

import heapq
import itertools
import os
import time
from typing import Any, Optional

from ..common import sync
from ..common.deadline import (
    CancellationToken, CancelledQuery, Deadline, DeadlineExceeded,
    current_cancel_token, current_deadline,
)
from ..observability import flight
from ..observability.metrics import (
    QBATCH_GROUPS_TOTAL, QBATCH_INCOMPATIBLE_TOTAL,
    QBATCH_MASKED_RIDERS_TOTAL, QBATCH_QUERIES_PER_DISPATCH,
    SEARCH_BATCHER_DISPATCHES_TOTAL, SEARCH_BATCHER_QUERIES_TOTAL,
    SEARCH_BATCHER_QUEUE_WAIT, SEARCH_BATCHER_RATIO, SEARCH_SHED_TOTAL,
)
from ..observability.profile import (
    PHASE_BATCHER_QUEUE, PHASE_QBATCH_GROUP, current_profile,
    shared_dispatch,
)
from ..tenancy.context import effective_tenant
from ..tenancy.overload import OVERLOAD, OverloadShed
from ..tenancy.registry import GLOBAL_TENANCY
from . import chunkexec, executor
from .residency import RESIDENT_READBACKS_SHED, note_group_shared_staging

# Extra follower wait beyond its own deadline: the leader may be setting the
# event at this very moment — shedding exactly at expiry would discard a
# result that is already computed.
_FOLLOWER_SLACK_SECS = 0.05

# A rider with a CancellationToken polls its event in slices of this size so
# a mid-wait cancel is observed promptly instead of after the full batch
# round-trip (the shed-before-readback gap).
_CANCEL_POLL_SECS = 0.05


def qbatch_enabled() -> bool:
    """Query-axis stacking kill switch: `QW_DISABLE_QBATCH=1` restores the
    convoy-only seed behavior byte for byte (grouping key, dispatch path,
    and metrics all revert). Read per call so tests and operators can flip
    it without rebuilding the batcher."""
    return os.environ.get("QW_DISABLE_QBATCH", "").strip().lower() not in (
        "1", "true", "yes", "on")


class _PriorityLock:
    """Per-key dispatch lock with priority-ordered handoff.

    `threading.Lock` hands contended acquisitions to an arbitrary waiter;
    here, when several convoy leaders for the same key are queued behind an
    in-flight dispatch, the leader from the highest-priority tenant
    dispatches next (FIFO within a priority band). With a single waiter —
    or all waiters at equal priority — behavior is indistinguishable from
    the plain lock this replaces."""

    def __init__(self):
        self._cond = sync.condition(name="batcher_dispatch_cv")
        self._held = False
        self._waiters: list[tuple[int, int]] = []  # heap: (-priority, seq)
        self._seq = itertools.count()

    def acquire(self, priority: int = 0) -> None:
        with self._cond:
            entry = (-priority, next(self._seq))
            heapq.heappush(self._waiters, entry)
            while self._held or self._waiters[0] != entry:
                self._cond.wait()
            heapq.heappop(self._waiters)
            self._held = True

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()


class _Pending:
    __slots__ = ("plan", "arrays", "scalars", "tbox", "tenant", "event",
                 "result", "error", "deadline", "enqueued_at", "profile",
                 "cancel")

    def __init__(self, scalars, deadline: Optional[Deadline] = None,
                 profile=None, cancel: Optional[CancellationToken] = None,
                 plan=None, arrays=None, tbox=None, tenant=None):
        self.scalars = scalars
        # query-axis stacking: each rider carries its OWN lowered plan and
        # staged device arrays (distinct queries in one group), plus its
        # ThresholdBox for per-lane tightening in chunked group scans
        self.plan = plan
        self.arrays = arrays
        self.tbox = tbox
        self.tenant = tenant
        self.event = sync.event()
        self.result: Any = None
        self.error: Exception | None = None
        self.deadline = deadline
        self.enqueued_at = time.perf_counter()
        # each rider's ambient QueryProfile (or None): the leader reports
        # every rider's queue wait into ITS profile at dispatch time
        self.profile = profile
        # the rider's ambient CancellationToken (or None): consulted by
        # both the rider's own wait and the leader's shed points, so a
        # cancelled rider neither blocks on nor is served by the batch
        self.cancel = cancel


class QueryGroupPlanner:
    """Grouping rules for query-axis stacking (docs/query-batching.md).

    Buckets queued queries by the STRUCTURAL compatibility signature —
    `plan.structure_digest(k)` covers node sigs, sort spec, agg shape,
    array shapes/dtypes (and therefore the padding bucket and column
    families), scalar dtypes, and threshold/search_after/rebase PRESENCE —
    plus the split identity. Queries agreeing on that key stack into one
    dispatch regardless of their terms, filter bounds, threshold values,
    or sort markers; per-slot shared-vs-stacked operand placement is
    decided later from array cache keys (executor.stacked_slot_split).

    Also the accounting point for why queries did NOT stack: reject
    reasons are a bounded enum (`plan_shape` — an open group exists for
    the same split with a different structure; `group_full` — the open
    group hit max_batch), exported as qw_qbatch_incompatible_total."""

    def __init__(self, max_batch: int = 16):
        self.max_batch = max_batch

    @staticmethod
    def key_for(plan, k: int, split_key, stacking: bool) -> tuple:
        group_key = getattr(plan, "group_key", None)
        if stacking and group_key is not None:
            return group_key(k, split_key)
        # convoy key (seed behavior): the key carries the plan's array
        # cache keys, so queries sharing a dispatch are guaranteed to read
        # the very same device arrays (two terms of equal posting shape
        # lower to the same signature but DIFFERENT arrays — under the
        # kill switch they must not share)
        return (plan.signature(k), tuple(plan.array_keys), split_key)

    @staticmethod
    def note_reject(open_queues, key, stacking: bool) -> None:
        """Called (under the batcher lock) when a query LEADS a fresh
        queue: attribute why it could not join an existing group."""
        if not stacking:
            return
        full = open_queues.get(key)
        if full:
            QBATCH_INCOMPATIBLE_TOTAL.inc(reason="group_full")
            return
        split_key = key[2]
        if any(other[0] == "qb" and other[2] == split_key
               and other != key for other in open_queues):
            QBATCH_INCOMPATIBLE_TOTAL.inc(reason="plan_shape")



class QueryBatcher:
    """Groups concurrent compatible queries into one device dispatch —
    same-plan convoys always, DISTINCT shape-compatible queries when
    query-axis stacking is enabled. Thread-safe; every caller blocks only
    for its own result."""

    def __init__(self, max_batch: int = 16, fault_injector=None):
        self.max_batch = max_batch
        self.planner = QueryGroupPlanner(max_batch)
        self._lock = sync.lock("QueryBatcher._lock")
        sync.register_shared(self, "QueryBatcher")
        self._queues: dict[tuple, list[_Pending]] = {}
        # per-key dispatch serialization, refcounted so the dict cannot
        # grow without bound across query shapes / reader reopens
        self._dispatch_locks: dict[tuple, list] = {}  # key -> [lock, refs]
        # observability: dispatches vs queries served (batching efficiency)
        self.num_dispatches = 0
        self.num_queries = 0
        # chaos hook: perturbs "batcher.dispatch" before each real dispatch
        self.fault_injector = fault_injector

    @staticmethod
    def _abort_wait(me: _Pending, reason: str) -> None:
        if me.profile is not None:
            me.profile.record_phase(
                PHASE_BATCHER_QUEUE,
                time.perf_counter() - me.enqueued_at,
                start=me.enqueued_at, aborted=True)
            me.profile.mark_partial(reason)

    def _follower_wait(self, me: _Pending) -> None:
        """Block until the leader serves `me`, bounded by the rider's own
        deadline AND its cancel token. A rider without a token waits in one
        shot (the seed path); with one, the wait polls in short slices so a
        mid-flight cancel is observed promptly instead of after the full
        batch round-trip (the shed-before-readback gap)."""
        bounded = me.deadline is not None and me.deadline.bounded
        if me.cancel is None:
            if not bounded:
                me.event.wait()
                return
            if me.event.wait(me.deadline.remaining() + _FOLLOWER_SLACK_SECS):
                return
            # the leader (stuck in a slow dispatch) outlived our budget;
            # abandon the ride — our scalars may still be computed, the
            # result is simply unclaimed
            SEARCH_SHED_TOTAL.inc(stage="batcher_wait")
            self._abort_wait(me, "shed: batcher wait")
            raise DeadlineExceeded("batched dispatch wait")
        while True:
            if me.cancel.cancelled:
                SEARCH_SHED_TOTAL.inc(stage="batcher_cancel")
                self._abort_wait(me, "cancelled: batcher wait")
                raise CancelledQuery("batched dispatch wait",
                                     me.cancel.reason)
            if bounded:
                remaining = me.deadline.remaining() + _FOLLOWER_SLACK_SECS
                if remaining <= 0:
                    SEARCH_SHED_TOTAL.inc(stage="batcher_wait")
                    self._abort_wait(me, "shed: batcher wait")
                    raise DeadlineExceeded("batched dispatch wait")
                slice_secs = min(_CANCEL_POLL_SECS, remaining)
            else:
                slice_secs = _CANCEL_POLL_SECS
            if me.event.wait(slice_secs):
                return

    def execute(self, plan, k: int, device_arrays, split_key,
                threshold_box=None, fault_injector=None,
                device=None) -> dict[str, Any]:
        """Run one query on `device` (default `cuda`; where its arrays
        lie), possibly riding a shared dispatch. `split_key` must uniquely
        identify the split (reader identity). With stacking enabled the
        grouping key is the structural digest — distinct queries group;
        under `QW_DISABLE_QBATCH` the key also carries the plan's array
        cache keys, restoring the convoy-only behaviour.
        `threshold_box`/`fault_injector` thread the chunked-execution
        context through group dispatches (leaf.py routes through the
        batcher BEFORE the chunked check when stacking is on)."""
        stacking = qbatch_enabled()
        key = self.planner.key_for(plan, k, split_key, stacking)
        tenant = effective_tenant()
        # overload checkpoint: under sustained queue-wait pressure the
        # lowest-priority tenants are bounced before taking a batch slot
        if OVERLOAD.should_shed(tenant.priority):
            SEARCH_SHED_TOTAL.inc(stage="overload_batcher")
            GLOBAL_TENANCY.note_shed(tenant.tenant_id, stage="batcher")
            raise OverloadShed("batcher", OVERLOAD.retry_after_secs())
        cancel = current_cancel_token()
        if cancel is not None:
            # already-cancelled queries never take a batch slot
            cancel.check("batcher enqueue")
        me = _Pending(plan.scalars, current_deadline(), current_profile(),
                      cancel, plan=plan, arrays=device_arrays,
                      tbox=threshold_box, tenant=tenant)
        my_queue = None
        with self._lock:
            sync.note_write(self, "queues")
            self.num_queries += 1
            SEARCH_BATCHER_QUERIES_TOTAL.inc()
            queue = self._queues.get(key)
            if queue is not None and len(queue) < self.max_batch:
                queue.append(me)          # follower: the leader serves us
            else:
                # new (or full) queue: lead a FRESH list. A full previous
                # list stays owned by its own leader (it is popped by
                # identity below), so its followers are never orphaned.
                self.planner.note_reject(self._queues, key, stacking)
                my_queue = [me]
                self._queues[key] = my_queue
                entry = self._dispatch_locks.setdefault(
                    key, [_PriorityLock(), 0])
                entry[1] += 1
                dispatch_lock = entry[0]
        if my_queue is None:
            self._follower_wait(me)
            if me.error is not None:
                raise _waiter_error(me.error)
            return me.result
        # serialize dispatches per key: while a previous dispatch is in
        # flight this blocks, and our queue keeps accumulating followers —
        # the batching window emerges from real dispatch latency instead of
        # a configured sleep. Contended handoff is priority-ordered: a
        # higher-class tenant's convoy dispatches before a lower one's.
        try:
            dispatch_lock.acquire(tenant.priority)
            try:
                with self._lock:
                    sync.note_write(self, "queues")
                    if self._queues.get(key) is my_queue:
                        del self._queues[key]
                    batch = my_queue
                # riders whose budget ran out — or who were cancelled —
                # while queued are shed NOW: dispatching for them wastes
                # device time nobody can use
                expired = [p for p in batch
                           if p.deadline is not None and p.deadline.expired]
                cancelled = [p for p in batch
                             if p not in expired and p.cancel is not None
                             and p.cancel.cancelled]
                alive = [p for p in batch
                         if p not in expired and p not in cancelled]
                now = time.perf_counter()
                for pending in expired:
                    SEARCH_SHED_TOTAL.inc(stage="batcher_dispatch")
                    flight.emit("batcher.shed",
                                query_id=(pending.profile.query_id
                                          if pending.profile else ""))
                    if pending.profile is not None:
                        pending.profile.record_phase(
                            PHASE_BATCHER_QUEUE, now - pending.enqueued_at,
                            start=pending.enqueued_at, aborted=True)
                        pending.profile.mark_partial("shed: batcher dispatch")
                    pending.error = DeadlineExceeded("batched dispatch")
                    pending.event.set()
                for pending in cancelled:
                    SEARCH_SHED_TOTAL.inc(stage="batcher_cancel")
                    flight.emit("batcher.cancelled",
                                query_id=(pending.profile.query_id
                                          if pending.profile else ""))
                    if pending.profile is not None:
                        pending.profile.record_phase(
                            PHASE_BATCHER_QUEUE, now - pending.enqueued_at,
                            start=pending.enqueued_at, aborted=True)
                        pending.profile.mark_partial(
                            "cancelled: batcher dispatch")
                    pending.error = CancelledQuery("batched dispatch",
                                                   pending.cancel.reason)
                    pending.event.set()
                readback_fn = None
                readback_targets = alive
                try:
                    if alive:
                        grouped = stacking and len(batch) > 1
                        phase = (PHASE_QBATCH_GROUP if grouped
                                 else PHASE_BATCHER_QUEUE)
                        now = time.perf_counter()
                        for pending in alive:
                            wait = now - pending.enqueued_at
                            SEARCH_BATCHER_QUEUE_WAIT.observe(wait)
                            OVERLOAD.note_wait(wait)
                            if pending.profile is not None:
                                pending.profile.record_phase(
                                    phase, wait,
                                    start=pending.enqueued_at,
                                    riders=len(alive))
                        with self._lock:
                            self.num_dispatches += 1
                            SEARCH_BATCHER_DISPATCHES_TOTAL.inc()
                            SEARCH_BATCHER_RATIO.set(
                                self.num_queries / self.num_dispatches)
                        if self.fault_injector is not None:
                            self.fault_injector.perturb("batcher.dispatch")
                        if len(batch) == 1 and alive[0] is me:
                            # lone query: nobody queues behind a convoy of
                            # one, so dispatch + readback run inline — the
                            # seed path. With stacking on the chunked check
                            # moved from the leaf into here (leaf routes
                            # through the batcher first), so the solo rider
                            # keeps its resumable scan.
                            result = None
                            if stacking and getattr(plan, "root",
                                                    None) is not None:
                                result = chunkexec.maybe_execute_chunked(
                                    plan, k, device_arrays, device,
                                    threshold_box=threshold_box,
                                    fault_injector=fault_injector)
                            if result is None:
                                result = executor.execute_plan(
                                    plan, k, device_arrays, device)
                            alive[0].result = result
                            alive[0].event.set()
                        elif grouped:
                            with shared_dispatch(p.profile for p in alive):
                                readback_targets, readback_fn = \
                                    self._dispatch_group(batch, alive, k,
                                                         fault_injector,
                                                         device)
                        else:
                            with shared_dispatch(p.profile for p in alive):
                                dispatched = executor.dispatch_plan_multi(
                                    plan, k, device_arrays,
                                    [p.scalars for p in alive],
                                    device=device)
                            readback_fn = (lambda d=dispatched:
                                           executor.readback_plan_multi(d))
                except Exception as exc:  # noqa: BLE001 - fan to waiters
                    for pending in alive:
                        pending.error = exc
                        pending.event.set()
            finally:
                # released after DISPATCH, before the blocking readback:
                # the next convoy for this key overlaps its dispatch with
                # our device->host wait (the async-readback pipeline)
                dispatch_lock.release()
            if readback_fn is not None:
                try:
                    still_wanted = [p for p in alive
                                    if (p.deadline is None
                                        or not p.deadline.expired)
                                    and (p.cancel is None
                                         or not p.cancel.cancelled)]
                    if not still_wanted:
                        # every rider's budget ran out (or was cancelled)
                        # while the kernel flew: nobody can use the answer,
                        # so the device->host transfer is never awaited
                        RESIDENT_READBACKS_SHED.inc()
                        for pending in alive:
                            if (pending.cancel is not None
                                    and pending.cancel.cancelled):
                                pending.error = CancelledQuery(
                                    "batched readback",
                                    pending.cancel.reason)
                            else:
                                pending.error = DeadlineExceeded(
                                    "batched readback shed")
                            pending.event.set()
                    else:
                        results = readback_fn()
                        for pending, result in zip(readback_targets,
                                                   results):
                            if pending.event.is_set():
                                # masked lane: its error was already fanned
                                # at the shed point (result is None/zeroed)
                                continue
                            if (pending.cancel is not None
                                    and pending.cancel.cancelled):
                                # cancelled after dispatch: the batch still
                                # flew for the live riders, but this one's
                                # answer is abandoned by contract
                                pending.error = CancelledQuery(
                                    "batched readback",
                                    pending.cancel.reason)
                            elif isinstance(result, Exception):
                                # per-lane typed outcome from a chunked
                                # group scan (lane cancel/deadline)
                                pending.error = result
                            else:
                                pending.result = result
                            pending.event.set()
                except Exception as exc:  # noqa: BLE001 - fan to waiters
                    for pending in alive:
                        pending.error = exc
                        pending.event.set()
        finally:
            with self._lock:
                entry = self._dispatch_locks.get(key)
                if entry is not None:
                    entry[1] -= 1
                    if entry[1] <= 0:
                        del self._dispatch_locks[key]
        if me.error is not None:
            raise me.error
        return me.result

    def _dispatch_group(self, batch, alive, k, fault_injector, device):
        """One stacked dispatch for a formed query group. Shed riders stay
        IN the lane list with valid=False (masked: they run nothing and
        read back as None) so the program is keyed only by the group's
        structure and bucket — launch count stays 1 whatever happens
        between formation and launch. Returns (readback_targets, readback_fn); the chunked
        composition reads back inside the scan, so its readback_fn just
        hands the per-lane outcomes through."""
        alive_set = set(id(p) for p in alive)
        valid = [id(p) in alive_set for p in batch]
        masked = len(batch) - len(alive)
        # a masked rider keeps ITS OWN operands in the lane list
        # (identical shapes — that is the grouping invariant), so nothing
        # about the program changes when it is shed; a rider with no plan
        # at all (test-planted sentinels) borrows a live donor's, its lane
        # being dropped either way
        donor = alive[0]
        plans = [p.plan if p.plan is not None else donor.plan
                 for p in batch]
        arrays_list = [p.arrays if p.arrays is not None else donor.arrays
                       for p in batch]
        if len(alive) > 1:
            QBATCH_GROUPS_TOTAL.inc()
        QBATCH_QUERIES_PER_DISPATCH.observe(len(alive))
        if masked:
            QBATCH_MASKED_RIDERS_TOTAL.inc(masked)
        # group context onto every rider's profile: a slow stacked query's
        # slowlog entry names its group (size / lane / masked flag) so a
        # p99 outlier is attributable to group formation, not just itself
        for lane, pending in enumerate(batch):
            if pending.profile is not None:
                pending.profile.set_counter("qbatch_group_size",
                                            float(len(batch)))
                pending.profile.set_counter("qbatch_lane_index", float(lane))
                pending.profile.set_counter("qbatch_masked",
                                            0.0 if valid[lane] else 1.0)
        if flight.recording():
            flight.emit("batcher.group_formed",
                        attrs={"lanes": len(batch), "alive": len(alive),
                               "masked": masked})
        note_group_shared_staging(plans, len(alive))
        group_res = chunkexec.execute_group_chunked(
            plans, k, arrays_list, valid=valid,
            tboxes=[p.tbox for p in batch],
            deadlines=[p.deadline for p in batch],
            cancels=[p.cancel for p in batch],
            tenants=[p.tenant for p in batch],
            fault_injector=fault_injector, device=device)
        if group_res is not None:
            return batch, (lambda r=group_res: r)
        dispatched = executor.dispatch_plan_stacked(
            plans, k, arrays_list, valid=valid, device=device)
        return batch, (lambda d=dispatched:
                       executor.readback_plan_stacked(d))


def _waiter_error(err: Exception) -> Exception:
    """A fresh per-waiter exception chained to the shared dispatch error:
    many waiter threads re-raising the SAME instance would race on its
    __traceback__ and leak handler-side mutations across queries."""
    try:
        copy = type(err)(*err.args)
    except Exception:  # noqa: BLE001 - exotic constructor signatures
        copy = RuntimeError(f"batched dispatch failed: {err!r}")
    copy.__cause__ = err
    return copy
