"""Byte-accurate HBM admission for leaf search.

Role of the reference's `SearchPermitProvider`
(`quickwit-search/src/search_permit_provider.rs:43,436`): split searches
must not materialize more memory than the device has. The reference
estimates pessimistically and corrects after warmup; here the lowered
plan KNOWS every array's exact byte size before any transfer, so
admission is exact:

- a query's NEW transfer bytes are **pinned** for the duration of its
  execution; admission order is weighted deficit-round-robin across
  tenants (`tenancy/drr.py`): per-tenant FIFO sub-queues, grant order by
  deficit counter, so one flooding tenant cannot convoy everyone else's
  queue wait, while large requests still cannot be starved by a stream
  of small ones. Unlabeled traffic all lands in one implicit tenant,
  where DRR degenerates to the exact FIFO this queue used to be.
  Admission blocks while earlier pins would overflow the budget —
  over-budget work queues instead of materializing;
- after execution the pins downgrade to **resident** bytes (the device
  array cache that makes repeat queries skip H2D); residency is evicted
  LRU per split reader whenever new pins need room. Readers with
  in-flight queries are never evicted (their device arrays are in use).

A single query larger than the whole budget is admitted alone (pinned
bytes of others == 0) — refusing it would deadlock, and the reference
likewise lets one oversized split through to fail loudly on-device.

Format-v2 splits stage FOR-packed numeric columns as narrow delta lanes
(docs/device-layout.md), so the bytes admitted here are the compact
footprint — a fixed budget admits proportionally more concurrent splits.
"""

from __future__ import annotations

import logging
import os
import time
import weakref
from collections import OrderedDict

from ..common import sync
from ..common.clock import monotonic as _seam_monotonic
from ..common.deadline import DeadlineExceeded, current_deadline
from ..observability import flight
from ..observability.metrics import SEARCH_SHED_TOTAL
from ..observability.profile import PHASE_ADMISSION_WAIT, current_profile
from ..tenancy.context import effective_tenant
from ..tenancy.drr import DrrScheduler
from ..tenancy.overload import OVERLOAD, OverloadShed
from ..tenancy.registry import GLOBAL_TENANCY

logger = logging.getLogger(__name__)

DEFAULT_BUDGET_BYTES = int(os.environ.get("QW_HBM_BUDGET_BYTES", 8 << 30))


class HbmBudget:
    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget = budget_bytes
        self._cond = sync.condition(name="HbmBudget._cond")
        sync.register_shared(self, "HbmBudget")
        self._pinned = 0
        self._pin_counts: dict[int, int] = {}  # id(owner) -> in-flight count
        # weighted deficit-round-robin admission order across tenants;
        # guarded by self._cond's lock (the scheduler itself is lock-free)
        self._drr = DrrScheduler()
        # id(reader) -> [resident_bytes, weakref(reader)]
        self._resident: "OrderedDict[int, list]" = OrderedDict()
        self._resident_bytes = 0

    # ------------------------------------------------------------------
    def admit(self, owner, new_bytes: int,
              timeout_secs: float = 120.0) -> int:
        """Block until `new_bytes` fit; returns the admitted (pinned) byte
        count. Grant order is weighted deficit-round-robin across the
        ambient tenant's sub-queue (FIFO within a tenant; see module
        docstring). Evicts idle readers' resident device arrays LRU to
        make room.

        Load shedding: a query whose ambient deadline has already passed —
        or passes while it queues — is rejected with `DeadlineExceeded`
        instead of occupying a ticket; its caller has no time left to use
        the admission anyway. Under sustained overload the controller
        additionally sheds low-priority tenants up front (`OverloadShed`),
        and a tenant over its staged-bytes/s bucket is rejected with
        `TenantRateLimited` before it queues."""
        query_deadline = current_deadline()
        profile = current_profile()
        tenant = effective_tenant()
        if query_deadline is not None and query_deadline.expired:
            SEARCH_SHED_TOTAL.inc(stage="admission")
            flight.emit("admission.shed", attrs={"stage": "deadline"})
            if profile is not None:
                profile.mark_partial("shed: HBM admission")
            raise DeadlineExceeded("HBM admission")
        if new_bytes <= 0:
            # zero-byte admission still PINS the owner: its cached device
            # arrays are in use and must not be evicted mid-query
            with self._cond:
                self._pin_counts[id(owner)] = \
                    self._pin_counts.get(id(owner), 0) + 1
            return 0
        if OVERLOAD.should_shed(tenant.priority):
            SEARCH_SHED_TOTAL.inc(stage="overload_admission")
            flight.emit("admission.shed",
                        attrs={"stage": "overload",
                               "priority": tenant.priority})
            GLOBAL_TENANCY.note_shed(tenant.tenant_id, stage="admission")
            if profile is not None:
                profile.mark_partial("shed: overload (admission)")
            raise OverloadShed("admission", OVERLOAD.retry_after_secs())
        # staged-bytes/s pacing: charged before queueing so a flooding
        # tenant is bounced while its bytes are still hypothetical
        GLOBAL_TENANCY.charge_staged_bytes(tenant, new_bytes)
        if query_deadline is not None:
            timeout_secs = min(timeout_secs,
                               query_deadline.clamp(timeout_secs))
        deadline = time.monotonic() + timeout_secs
        t_admit = time.perf_counter()
        # seam twin of t_admit: the flight event's wait must be virtual
        # time under DST (byte-identical artifact tails), real time live
        ft_admit = _seam_monotonic()
        try:
            with self._cond:
                ticket = self._drr.enqueue(tenant.tenant_id, tenant.weight,
                                           new_bytes)
                try:
                    while not (self._drr.head() is ticket
                               and (self._pinned == 0
                                    or self._pinned + new_bytes
                                    <= self.budget)):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            if (query_deadline is not None
                                    and query_deadline.expired):
                                SEARCH_SHED_TOTAL.inc(stage="admission")
                                raise DeadlineExceeded(
                                    "HBM admission queue wait")
                            raise TimeoutError(
                                f"HBM admission timed out: need {new_bytes} "
                                f"bytes, {self._pinned} pinned of "
                                f"{self.budget}")
                        self._cond.wait(remaining)
                except BaseException:
                    self._drr.remove(ticket, served=False)
                    self._cond.notify_all()  # a new head may now be grantable
                    raise
                self._drr.remove(ticket, served=True)
                self._cond.notify_all()
                sync.note_write(self, "pinned")
                self._pinned += new_bytes
                self._pin_counts[id(owner)] = \
                    self._pin_counts.get(id(owner), 0) + 1
                self._evict_locked()
                if new_bytes > self.budget:
                    logger.warning(
                        "query needs %d bytes against a %d-byte HBM budget; "
                        "admitted alone", new_bytes, self.budget)
        except BaseException:
            wait = time.perf_counter() - t_admit
            OVERLOAD.note_wait(wait)
            if profile is not None:
                # shed while queued: the partial wait is still reported
                profile.record_phase(
                    PHASE_ADMISSION_WAIT, wait,
                    start=t_admit, bytes=new_bytes, aborted=True)
                profile.mark_partial("shed: HBM admission queue wait")
            raise
        wait = time.perf_counter() - t_admit
        OVERLOAD.note_wait(wait)
        GLOBAL_TENANCY.note_admission_wait(tenant.tenant_id, wait)
        GLOBAL_TENANCY.note_staged_bytes(tenant.tenant_id, new_bytes)
        if flight.recording():
            # the DRR grant: this query reached its tenant sub-queue head
            # and its bytes fit the budget
            flight.emit("admission.grant", attrs={
                "bytes": new_bytes,
                "wait_ms": round((_seam_monotonic() - ft_admit) * 1000.0, 3)})
        if profile is not None:
            profile.record_phase(PHASE_ADMISSION_WAIT,
                                 wait, start=t_admit,
                                 bytes=new_bytes)
        return new_bytes

    def release(self, owner, admitted_bytes: int,
                to_resident: bool = True) -> None:
        """Pins → residency when the owner keeps a device-array cache
        (split readers); transient owners (batches) just unpin — their
        arrays die with them and must not count as resident.
        `to_resident=False` unpins without residency (failed transfer:
        nothing actually landed in HBM). Zero-byte releases still unpin
        the owner (matching zero-byte admissions)."""
        with self._cond:
            sync.note_write(self, "pinned")
            if admitted_bytes <= 0:
                count = self._pin_counts.get(id(owner), 1) - 1
                if count <= 0:
                    self._pin_counts.pop(id(owner), None)
                else:
                    self._pin_counts[id(owner)] = count
                self._cond.notify_all()
                return
            self._pinned -= admitted_bytes
            count = self._pin_counts.get(id(owner), 1) - 1
            if count <= 0:
                self._pin_counts.pop(id(owner), None)
            else:
                self._pin_counts[id(owner)] = count
            if to_resident and getattr(owner, "_device_array_cache",
                                       None) is not None:
                oid = id(owner)
                entry = self._resident.pop(oid, None)
                if entry is None:
                    entry = [0, weakref.ref(
                        owner, lambda _ref, oid=oid: self._drop(oid))]
                entry[0] += admitted_bytes
                self._resident[oid] = entry
                self._resident_bytes += admitted_bytes
            self._cond.notify_all()

    def _drop(self, oid: int) -> None:
        """weakref callback: a reader was garbage-collected; its device
        arrays are gone, so its residency must not cause evictions."""
        with self._cond:
            entry = self._resident.pop(oid, None)
            if entry is not None:
                self._resident_bytes -= entry[0]
                self._cond.notify_all()

    def _evict_locked(self) -> None:
        while (self._resident_bytes + self._pinned > self.budget
               and self._resident):
            victim_id = next(
                (rid for rid in self._resident
                 if self._pin_counts.get(rid, 0) == 0), None)
            if victim_id is None:
                return  # every resident reader has in-flight queries
            nbytes, ref = self._resident.pop(victim_id)
            self._resident_bytes -= nbytes
            reader = ref()
            if reader is not None:
                # dropping the refs releases HBM once no kernel holds them
                cache = getattr(reader, "_device_array_cache", None)
                if cache:
                    cache.clear()
                logger.info("evicted %d resident device bytes (LRU)", nbytes)

    # --- observability ------------------------------------------------
    def stats(self) -> dict:
        with self._cond:
            return {"budget": self.budget, "pinned": self._pinned,
                    "resident": self._resident_bytes,
                    "waiting_by_tenant": self._drr.waiting_by_tenant()}
