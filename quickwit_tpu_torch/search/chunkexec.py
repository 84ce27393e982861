"""Resumable chunked leaf scans: the host loop between chunk programs.

Counterpart of the JAX package's `search/chunkexec.py`: the solo scan and
the query-group scan of the query batcher (`execute_group_chunked`, one
stacked dispatch per chunk over every live lane). A fused leaf program is
uninterruptible once launched, so a cancelled or expired query, or a
background tenant under overload, could only be stopped between splits.
The chunked scan runs one split as a sequence of chunk programs, each
through the same `executor.execute_plan` seam, with the mergeable state
(top-k rows, count, aggregation states) carried on the host. Every
`execute_plan` ends in its packed readback, so each chunk boundary is a
host sync, and at every boundary the loop

  (a) kills an expired or explicitly cancelled query (the ambient
      `Deadline` / `CancellationToken` of common/deadline.py): it returns
      the merged-so-far state marked `"partial": True`, or raises
      `CancelledQuery` when nothing merged yet or partials are off;
  (b) parks the carried state while the overload ladder has tripped and a
      higher-class query runs (`PreemptGate`), byte-accounted against the
      tenant's DRR quantum (`ParkedStateRegistry`), and resumes after;
  (c) stops early when the remaining chunks' impact block-max bounds
      cannot beat the current Kth score, and tightens a pushed-down
      threshold from the shared `ThresholdBox` and the carried Kth value.

Two partitionings cover every chunk-eligible plan:

* posting mode — plans of the posting-space program: the [P] ids/tfs
  lanes split on POSTING_PAD boundaries (the impact block maxima with
  them), and each chunk's device operands are views `t[lo:hi]` of the
  staged tensors. A scored score-sorted chunk is one `score_topk` launch.
  Counts sum exactly because the lane partition is disjoint; ties merge
  in chunk order, the fused program's lowest-lane order.
* dense mode — everything `plan.chunk_slot_plan` classifies: the padded
  doc dimension splits on DOC_PAD boundaries; doc columns, zonemaps and
  packed masks are device views of the matching window; posting ids are
  rebased into the window ON THE DEVICE from the staged ids (out-of-window
  lanes get the sentinel `span`, which the scatters drop into their spare
  lane), so a warm chunked call stages no bytes; the chunk's global doc
  offset rides the `doc_base_slot` scalar so doc-keyed sorts and
  search_after stay in global doc space. `dense_chunk_plan` keeps the
  reference's host-rebased arrays in the chunk plan (shapes and keys; the
  tests hold the device rebase against them).

A plan that does not chunk (composite aggs, chunking off, no span, or one
chunk) returns None, and the caller runs the fused program. The adaptive
`_ChunkSizer` knows nothing until a chunked scan was observed, so without
an explicit span (`CHUNKING.set(doc_span=..., posting_span=...)` or the
`QW_CHUNK_DOC_SPAN` / `QW_CHUNK_POSTING_SPAN` environment variables) every
plan runs fused.
"""

from __future__ import annotations

import math
import os
from contextlib import contextmanager
from dataclasses import replace as dc_replace
from typing import Any, Optional

import numpy as np
import torch

from ..common import sync
from ..common.clock import get_clock
from ..common.deadline import (
    CancelledQuery, DeadlineExceeded, current_cancel_token, current_deadline,
)
from ..common.faults import InjectedFault
from ..index.format import DOC_PAD, POSTING_PAD, ZONEMAP_BLOCK
from ..observability import flight
from ..observability.metrics import (
    CHUNK_BOUNDARY_SECONDS, CHUNK_DISPATCHES_TOTAL,
    CHUNK_EARLY_TERMINATIONS_TOTAL, CHUNK_RESTARTS_TOTAL,
    PREEMPT_PARKED_BYTES, PREEMPT_TOTAL,
)
from ..ops import topk as topk_ops
from ..tenancy.context import effective_tenant
from ..tenancy.drr import DEFAULT_QUANTUM_BYTES
from ..tenancy.overload import OVERLOAD
from . import executor
from .plan import CompositeAggExec, LoweredPlan, chunk_slot_plan


# --- configuration ---------------------------------------------------------

class ChunkConfig:
    """Process-wide chunking knobs. Explicit spans override the adaptive
    sizer; `enabled=False` restores the fused-only behaviour."""

    def __init__(self):
        self.enabled = True
        # explicit chunk spans (None = adaptive): docs per dense chunk
        # (DOC_PAD multiple) / postings per posting chunk (POSTING_PAD
        # multiple)
        self.doc_span: Optional[int] = _env_int("QW_CHUNK_DOC_SPAN")
        self.posting_span: Optional[int] = _env_int("QW_CHUNK_POSTING_SPAN")
        # the boundary-interval target the sizer steers toward
        self.target_boundary_secs = 0.010
        # cancelled queries return the merged-so-far state with an honest
        # "partial": true marker instead of dropping completed work
        self.partial_on_cancel = True
        # a parked query resumes after this long even if the gate never
        # clears (starvation bound; the deadline still applies on top)
        self.max_park_secs = 2.0

    def set(self, **kwargs) -> None:
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise AttributeError(f"unknown chunking knob {key!r}")
            setattr(self, key, value)


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else None


CHUNKING = ChunkConfig()


# --- adaptive chunk sizing -------------------------------------------------

class _ChunkSizer:
    """EWMA of per-item chunk latency per mode; suggests the span whose
    predicted chunk time matches the target boundary interval. Knows
    nothing until a chunked execution has been observed, so cold-start
    behaviour is the fused path unless an explicit span is configured."""

    ALPHA = 0.3

    def __init__(self):
        # leaf lock over two floats; no instrumented ops run under it
        self._lock = sync.lock("_ChunkSizer._lock")
        self._rate: dict[str, float] = {}   # mode -> EWMA secs per item

    def observe(self, mode: str, items: int, secs: float) -> None:
        if items <= 0 or secs <= 0.0:
            return
        rate = secs / items
        with self._lock:
            prev = self._rate.get(mode)
            self._rate[mode] = (rate if prev is None
                                else prev + self.ALPHA * (rate - prev))

    def span_for(self, mode: str, align: int) -> Optional[int]:
        with self._lock:
            rate = self._rate.get(mode)
        if rate is None or rate <= 0.0:
            return None
        span = CHUNKING.target_boundary_secs / rate
        return max(align, int(math.ceil(span / align)) * align)


CHUNK_SIZER = _ChunkSizer()


# --- preemption gate -------------------------------------------------------

class PreemptGate:
    """Who is running at which priority class, for boundary-time yield
    decisions. Fused and chunked executions both register; only chunked
    ones can yield (a fused program is uninterruptible)."""

    def __init__(self):
        self._cond = sync.condition(name="PreemptGate._cond")
        self._active: dict[int, int] = {}

    @contextmanager
    def running(self, priority: int):
        with self._cond:
            self._active[priority] = self._active.get(priority, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._active[priority] -= 1
                if self._active[priority] <= 0:
                    del self._active[priority]
                self._cond.notify_all()

    def _higher_active_locked(self, priority: int) -> bool:
        return any(count > 0 and pri > priority
                   for pri, count in self._active.items())

    def should_yield(self, priority: int) -> bool:
        """True when the overload ladder has tripped AND a strictly
        higher-class query is running right now."""
        if OVERLOAD.shed_floor() <= 0:
            return False
        with self._cond:
            return self._higher_active_locked(priority)

    def wait_until_clear(self, priority: int, max_wait_secs: float,
                         deadline=None, token=None) -> None:
        """Block (in short, cancel/deadline-aware slices) until no
        higher-class query is active, the ladder clears, the starvation
        bound elapses, or the query's own budget/cancel fires."""
        clock = get_clock()
        start = clock.monotonic()
        with self._cond:
            while (self._higher_active_locked(priority)
                   and OVERLOAD.shed_floor() > 0):
                if clock.monotonic() - start >= max_wait_secs:
                    return
                if deadline is not None and deadline.expired:
                    return
                if token is not None and token.cancelled:
                    return
                self._cond.wait(timeout=0.02)


PREEMPT_GATE = PreemptGate()


# --- parked-state accounting -----------------------------------------------

class _ParkTicket:
    __slots__ = ("tenant_id", "nbytes", "evicted", "seq")

    def __init__(self, tenant_id: str, nbytes: int, seq: int):
        self.tenant_id = tenant_id
        self.nbytes = nbytes
        self.evicted = False
        self.seq = seq


class ParkedStateRegistry:
    """Byte-accounts the carried chunk state of preempted queries.

    Parked bytes are bounded per tenant by the DRR quantum (the unit
    admission charges in) and globally by a small multiple of it. Over
    either cap the OLDEST parked entry (same tenant first) is evicted: its
    owner discards the carried state at resume and re-executes from
    scratch, counted in qw_chunk_restarts_total."""

    GLOBAL_CAP_FACTOR = 4

    def __init__(self, tenant_cap_bytes: int = DEFAULT_QUANTUM_BYTES):
        self.tenant_cap = tenant_cap_bytes
        self.global_cap = tenant_cap_bytes * self.GLOBAL_CAP_FACTOR
        # leaf lock over the accounting dict; no instrumented ops under it
        self._lock = sync.lock("ParkedStateRegistry._lock")
        self._entries: dict[int, _ParkTicket] = {}
        self._seq = 0

    def park(self, tenant_id: str, nbytes: int) -> _ParkTicket:
        with self._lock:
            self._seq += 1
            ticket = _ParkTicket(tenant_id, int(nbytes), self._seq)
            self._entries[ticket.seq] = ticket
            self._evict_over_caps(ticket.tenant_id)
            PREEMPT_PARKED_BYTES.set(self._total())
            return ticket

    def release(self, ticket: _ParkTicket) -> None:
        with self._lock:
            self._entries.pop(ticket.seq, None)
            PREEMPT_PARKED_BYTES.set(self._total())

    def parked_bytes(self) -> int:
        with self._lock:
            return self._total()

    def _total(self) -> int:
        return sum(t.nbytes for t in self._entries.values())

    def _tenant_total(self, tenant_id: str) -> int:
        return sum(t.nbytes for t in self._entries.values()
                   if t.tenant_id == tenant_id)

    def _evict_over_caps(self, tenant_id: str) -> None:
        # oldest-first within the offending tenant, then globally
        while self._tenant_total(tenant_id) > self.tenant_cap:
            self._evict_oldest(tenant_id)
        while self._total() > self.global_cap:
            self._evict_oldest(None)

    def _evict_oldest(self, tenant_id: Optional[str]) -> None:
        candidates = [t for t in self._entries.values()
                      if tenant_id is None or t.tenant_id == tenant_id]
        victim = min(candidates, key=lambda t: t.seq)
        victim.evicted = True
        del self._entries[victim.seq]


PARKED_STATES = ParkedStateRegistry()


# --- eligibility & chunk-plan construction ---------------------------------

def _has_composite(plan: LoweredPlan) -> bool:
    return any(isinstance(a, CompositeAggExec) for a in plan.aggs)


def chunk_mode(plan: LoweredPlan) -> Optional[tuple[str, int, int]]:
    """(mode, total_items, alignment) or None when the plan cannot chunk.

    Composite aggs never chunk in either mode: their device state is a
    run-compressed sort of the WHOLE doc space and two chunks' runs do not
    merge host-side."""
    if _has_composite(plan):
        return None
    if executor._posting_space_eligible(plan):
        items = int(plan.arrays[plan.root.ids_slot].shape[0])
        return ("posting", items, POSTING_PAD)
    if chunk_slot_plan(plan) is not None:
        return ("dense", int(plan.num_docs_padded), DOC_PAD)
    return None


def posting_chunk_plan(plan: LoweredPlan, lo: int, hi: int) -> LoweredPlan:
    """Sub-plan over posting lanes [lo, hi): ids/tfs (and the aligned
    impact block maxima) slice; every doc-space array passes through
    whole. Counts stay exact because the lane partition is disjoint."""
    root = plan.root
    arrays = list(plan.arrays)
    keys = list(plan.array_keys)
    for slot in {root.ids_slot, root.tfs_slot}:
        arrays[slot] = plan.arrays[slot][lo:hi]
        keys[slot] = f"{plan.array_keys[slot]}#p{lo}:{hi}"
    if root.impact_bmax_slot >= 0:
        slot = root.impact_bmax_slot
        arrays[slot] = plan.arrays[slot][lo // POSTING_PAD: hi // POSTING_PAD]
        keys[slot] = f"{plan.array_keys[slot]}#p{lo}:{hi}"
    return dc_replace(plan, arrays=arrays, array_keys=keys,
                      scalars=list(plan.scalars))


def dense_chunk_plan(plan: LoweredPlan, base: int, span: int) -> LoweredPlan:
    """Sub-plan over padded docs [base, base + span): doc/zone/packed
    slots slice by their granularity, posting pairs are host-rebased into
    the window (out-of-window lanes get sentinel `span`, the chunk's
    scatter-drop id), and the global offset rides a new `doc_base_slot`
    scalar."""
    slots = chunk_slot_plan(plan)
    if slots is None:
        raise ValueError("plan is not dense-chunk eligible")
    hi = base + span
    arrays = list(plan.arrays)
    keys = list(plan.array_keys)
    tag = f"#d{base}:{hi}"
    for slot in slots.doc_slots:
        arrays[slot] = plan.arrays[slot][base:hi]
        keys[slot] = plan.array_keys[slot] + tag
    for slot in slots.zone_slots:
        arrays[slot] = plan.arrays[slot][base // ZONEMAP_BLOCK:
                                         hi // ZONEMAP_BLOCK]
        keys[slot] = plan.array_keys[slot] + tag
    for slot in slots.packed_slots:
        arrays[slot] = plan.arrays[slot][base // 8: hi // 8]
        keys[slot] = plan.array_keys[slot] + tag
    for ids_slot, _tfs_slot in slots.posting_pairs:
        ids = plan.arrays[ids_slot]
        # same lane count, window-local ids: the dense evaluator's gathers
        # clamp and its scatters drop index == span, so out-of-window
        # postings contribute nothing (tfs lanes pass through unchanged)
        arrays[ids_slot] = np.where((ids >= base) & (ids < hi),
                                    ids - base, span).astype(ids.dtype)
        keys[ids_slot] = plan.array_keys[ids_slot] + tag
    scalars = list(plan.scalars) + [np.int32(base)]
    num_docs = min(max(plan.num_docs - base, 0), span)
    return dc_replace(plan, arrays=arrays, array_keys=keys, scalars=scalars,
                      num_docs=num_docs, num_docs_padded=span,
                      doc_base_slot=len(scalars) - 1)


def chunk_spans(total: int, span: int, align: int) -> list[tuple[int, int]]:
    """[lo, hi) windows covering [0, total): full spans plus one aligned
    remainder."""
    span = max(align, (span // align) * align)
    out = []
    lo = 0
    while lo < total:
        out.append((lo, min(lo + span, total)))
        lo += span
    return out


# --- host-side carried-state merging ---------------------------------------

def _merge_agg_leaf(name: str, a, b):
    """One mergeable device output leaf: min/max/hll envelope, stats
    component-wise, everything else adds (the JAX package's rules)."""
    if name == "min":
        return np.minimum(a, b)
    if name in ("max", "hll"):
        return np.maximum(a, b)
    if name == "stats":
        # [count, sum, sum_sq, min, max]
        return np.concatenate([np.asarray(a[:3]) + np.asarray(b[:3]),
                               np.minimum(a[3:4], b[3:4]),
                               np.maximum(a[4:5], b[4:5])])
    return np.asarray(a) + np.asarray(b)


def _merge_agg_state(name: str, a, b):
    if isinstance(a, dict):
        return {key: _merge_agg_state(key, a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return [_merge_agg_state(name, xa, xb) for xa, xb in zip(a, b)]
    return _merge_agg_leaf(name, a, b)


def merge_agg_outputs(a: list, b: list) -> list:
    """Merge two chunks' `result["aggs"]` lists leaf-wise."""
    return [_merge_agg_state("", sa, sb) for sa, sb in zip(a, b)]


class _CarriedState:
    """The mergeable cross-chunk state: merged top-K rows, match count,
    agg outputs, and how many chunks contributed."""

    __slots__ = ("topk", "count", "aggs", "chunks_done")

    def __init__(self):
        self.topk = None          # (vals, vals2|None, ids, scores)
        self.count = 0
        self.aggs: Optional[list] = None
        self.chunks_done = 0

    def absorb(self, result: dict[str, Any], k: int) -> None:
        self.count += int(result["count"])
        self.aggs = (list(result["aggs"]) if self.aggs is None
                     else merge_agg_outputs(self.aggs, result["aggs"]))
        piece = (result["sort_values"], result["sort_values2"],
                 result["doc_ids"], result["scores"])
        if self.topk is None:
            self.topk = piece
        else:
            # both inputs are ordered chunk outputs and the earlier one is
            # from strictly earlier lanes: the stable merge reproduces the
            # fused program's lowest-lane tie order
            self.topk = topk_ops.merge_topk_chunks([self.topk, piece], k)
        self.chunks_done += 1

    def kth_value(self, k: int) -> Optional[float]:
        """The current Kth primary key, when K hits exist."""
        if k <= 0 or self.topk is None or self.topk[0].shape[0] < k:
            return None
        kth = float(self.topk[0][k - 1])
        return None if kth == -np.inf else kth

    def nbytes(self) -> int:
        total = 0
        if self.topk is not None:
            total += sum(p.nbytes for p in self.topk if p is not None)
        stack = [self.aggs] if self.aggs is not None else []
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            elif hasattr(node, "nbytes"):
                total += node.nbytes
        return total

    def to_result(self, k: int, partial: bool = False) -> dict[str, Any]:
        if self.topk is None:
            vals = np.zeros((0,), np.float64)
            vals2 = None
            ids = np.zeros((0,), np.int32)
            scores = np.zeros((0,), np.float32)
        else:
            vals, vals2, ids, scores = self.topk
        out = {
            "sort_values": vals,
            "sort_values2": vals2,
            "doc_ids": ids,
            "scores": scores,
            "count": int(self.count),
            "aggs": list(self.aggs or []),
        }
        if partial:
            out["partial"] = True
        return out


# --- the chunk loop --------------------------------------------------------

class _RestartScan(Exception):
    """Carried state was lost (chunk_yield fault / parked-state eviction);
    the query re-executes from scratch."""


def _host_chunk_bounds(plan: LoweredPlan,
                       spans: list[tuple[int, int]]) -> Optional[np.ndarray]:
    """Per-chunk score upper bounds from the quantized impact block maxima
    (posting mode, format v3): the host-side mirror of
    `ops.bm25.dequantize_block_bounds`."""
    root = plan.root
    if root.impact_bmax_slot < 0 or root.impact_scale_slot < 0:
        return None
    bmax = np.asarray(plan.arrays[root.impact_bmax_slot], dtype=np.float64)
    scale = float(np.asarray(plan.scalars[root.impact_scale_slot]))
    bounds = np.empty(len(spans), dtype=np.float64)
    for i, (lo, hi) in enumerate(spans):
        blocks = bmax[lo // POSTING_PAD: (hi + POSTING_PAD - 1) // POSTING_PAD]
        bounds[i] = blocks.max() * scale if blocks.size else -np.inf
    return bounds


def _early_term_eligible(plan: LoweredPlan, k: int, mode: str) -> bool:
    """Cross-chunk early termination is only EXACT when nothing but the
    top-K depends on the remaining chunks: score-descending single-key
    sort, no aggs, and the exact count known host-side (the impact-prefix
    `count_override`)."""
    return (mode == "posting" and k > 0
            and plan.sort.by == "score" and plan.sort.descending
            and plan.sort.by2 == "none"
            and not plan.aggs
            and plan.count_override is not None)


def _slice_window(orig: np.ndarray, view: np.ndarray) -> tuple[int, int]:
    """Recover [lo, hi) of a 1-D basic-slice view into its base array."""
    offset = (view.__array_interface__["data"][0]
              - orig.__array_interface__["data"][0]) // orig.itemsize
    return int(offset), int(offset) + view.shape[0]


def _chunk_device_arrays(plan: LoweredPlan, chunk: LoweredPlan,
                         device_arrays: list, rebase=None,
                         slots=None) -> list:
    """Device inputs for a chunk, none of them staged from the host: slots
    the chunk plan passes through stay as they are, slots it sliced become
    device views of the same window, and (dense mode, `rebase` =
    (base, span, ids slots)) posting ids are rebased into the window on
    the device, as `dense_chunk_plan` rebases them on the host. With
    `slots`, only those slots are made (the others are None): a stacked
    group's lanes other than lane 0 need only their stacked slots."""
    out = []
    for slot, (orig, new) in enumerate(zip(plan.arrays, chunk.arrays)):
        if slots is not None and slot not in slots:
            out.append(None)
        elif new is orig:
            out.append(device_arrays[slot])
        elif rebase is not None and slot in rebase[2]:
            base, span, _ = rebase
            ids = device_arrays[slot]
            out.append(torch.where((ids >= base) & (ids < base + span),
                                   ids - base, span))
        else:
            lo, hi = _slice_window(orig, new)
            out.append(device_arrays[slot][lo:hi])
    return out


def execute_plan_chunked(plan: LoweredPlan, k: int, device_arrays: list,
                         device=None, *, span: Optional[int] = None,
                         threshold_box=None, fault_injector=None
                         ) -> Optional[dict[str, Any]]:
    """Run the plan as a resumable chunked scan on `device` (default
    `cuda`; where `device_arrays` lie); returns the same result dict as
    `executor.execute_plan`, or None when the plan does not chunk (the
    caller runs the fused program). A cancelled query returns the
    merged-so-far state with `"partial": True` (or raises `CancelledQuery`
    when nothing merged yet / partials are disabled)."""
    if not CHUNKING.enabled:
        return None
    mode_info = chunk_mode(plan)
    if mode_info is None:
        return None
    mode, total, align = mode_info
    if total <= 0:
        return None
    if span is None:
        span = (CHUNKING.posting_span if mode == "posting"
                else CHUNKING.doc_span)
    if span is None:
        span = CHUNK_SIZER.span_for(mode, align)
    if span is None or span <= 0:
        return None
    spans = chunk_spans(total, span, align)
    if len(spans) < 2:
        # one chunk is the fused program: run it as such
        return None

    tenant = effective_tenant()
    deadline = current_deadline()
    token = current_cancel_token()
    bounds = _host_chunk_bounds(plan, spans) if mode == "posting" else None
    early_ok = _early_term_eligible(plan, k, mode)
    ids_slots = (frozenset(ids for ids, _ in
                           chunk_slot_plan(plan).posting_pairs)
                 if mode == "dense" else frozenset())

    with PREEMPT_GATE.running(tenant.priority):
        for _attempt in range(2):
            try:
                return _run_scan(plan, k, device_arrays, device, mode, spans,
                                 bounds, early_ok, ids_slots, tenant,
                                 deadline, token, threshold_box,
                                 fault_injector)
            except _RestartScan:
                CHUNK_RESTARTS_TOTAL.inc()
                continue
        # two carried-state losses in a row: finish fused so chaos storms
        # degrade to the fused path instead of livelocking the scan
        return executor.execute_plan(plan, k, device_arrays, device)


def _run_scan(plan, k, device_arrays, device, mode, spans, bounds, early_ok,
              ids_slots, tenant, deadline, token, threshold_box,
              fault_injector):
    clock = get_clock()
    state = _CarriedState()
    threshold = (float(np.asarray(plan.scalars[plan.threshold_slot]))
                 if plan.threshold_slot >= 0 else None)
    last_boundary = clock.monotonic()
    for index, (lo, hi) in enumerate(spans):
        if index > 0:
            now = clock.monotonic()
            CHUNK_BOUNDARY_SECONDS.observe(now - last_boundary)
            last_boundary = now
            if flight.recording():
                flight.emit("chunk.boundary",
                            attrs={"index": index, "of": len(spans)})
            # (a) kill: explicit cancel, then deadline
            if token is not None and token.cancelled:
                if CHUNKING.partial_on_cancel and state.chunks_done > 0:
                    return state.to_result(k, partial=True)
                raise CancelledQuery("chunked scan boundary", token.reason)
            if deadline is not None:
                deadline.check("chunked scan boundary")
            # chaos: a fault at the yield point must never wedge the
            # carried state; it is discarded and the scan restarts clean
            if fault_injector is not None:
                try:
                    fault_injector.perturb("kernel.chunk_yield")
                except InjectedFault as exc:
                    raise _RestartScan() from exc
            # (b) preempt: park the carried state while a higher class
            # runs, byte-accounted against the tenant's DRR quantum
            if PREEMPT_GATE.should_yield(tenant.priority):
                PREEMPT_TOTAL.inc()
                ticket = PARKED_STATES.park(tenant.tenant_id, state.nbytes())
                if flight.recording():
                    flight.emit("chunk.preempt_park",
                                attrs={"bytes": state.nbytes(),
                                       "priority": tenant.priority})
                try:
                    if fault_injector is not None:
                        fault_injector.perturb("kernel.preempt_park")
                    PREEMPT_GATE.wait_until_clear(
                        tenant.priority, CHUNKING.max_park_secs,
                        deadline=deadline, token=token)
                except InjectedFault as exc:
                    ticket.evicted = True
                    raise _RestartScan() from exc
                finally:
                    PARKED_STATES.release(ticket)
                if ticket.evicted:
                    # parked-state eviction under byte pressure: the
                    # resumed query has nothing to resume FROM
                    flight.emit("chunk.preempt_evict")
                    raise _RestartScan()
                flight.emit("chunk.preempt_resume")
            # (c) early termination + boundary threshold tightening
            kth = state.kth_value(k)
            if (early_ok and kth is not None and bounds is not None
                    and index < len(bounds)
                    and float(bounds[index:].max()) <= kth):
                CHUNK_EARLY_TERMINATIONS_TOTAL.inc()
                if flight.recording():
                    flight.emit("chunk.early_term",
                                attrs={"after": index, "of": len(spans)})
                result = state.to_result(k)
                # the remaining chunks' matches never ran: the exact count
                # is the host-side impact-prefix override
                result["count"] = plan.count_override
                return result
            if threshold is not None:
                box_value = (threshold_box.get()
                             if threshold_box is not None else None)
                for candidate in (box_value, kth):
                    if candidate is not None and candidate > threshold:
                        # monotone tightening only: the threshold mask
                        # keeps >=, so no final-top-K lane is ever lost
                        threshold = candidate
        if mode == "posting":
            chunk = posting_chunk_plan(plan, lo, hi)
            rebase = None
        else:
            chunk = dense_chunk_plan(plan, lo, hi - lo)
            rebase = (lo, hi - lo, ids_slots)
        if threshold is not None:
            chunk.scalars[plan.threshold_slot] = np.float64(threshold)
        if mode == "dense" and chunk.num_docs <= 0 and state.chunks_done > 0:
            continue  # fully past num_docs: no valid lanes, no new state
        chunk_dev = _chunk_device_arrays(plan, chunk, device_arrays, rebase)
        t0 = clock.monotonic()
        result = executor.execute_plan(chunk, k, chunk_dev, device)
        CHUNK_DISPATCHES_TOTAL.inc()
        CHUNK_SIZER.observe(mode, hi - lo, clock.monotonic() - t0)
        if mode == "dense" and k > 0:
            # chunk doc ids are window-local: every lane rebases to global
            # doc space (a NaN sort value is a live hit too, and a dead
            # -inf lane then names the doc the fused program would)
            result["doc_ids"] = (result["doc_ids"] + lo).astype(np.int32)
        state.absorb(result, k)
    return state.to_result(k)


def maybe_execute_chunked(plan: LoweredPlan, k: int, device_arrays: list,
                          device=None, threshold_box=None,
                          fault_injector=None) -> Optional[dict[str, Any]]:
    """The leaf's entry point: chunked result dict, or None for the fused
    path (ineligible plan, chunking disabled, or work too small to span
    two chunks)."""
    return execute_plan_chunked(plan, k, device_arrays, device,
                                threshold_box=threshold_box,
                                fault_injector=fault_injector)


# --- query-group chunked scan ------------------------------------------------
#
# A stacked query group (search/batcher.py QueryGroupPlanner) composed with
# chunked execution: the carried state grows a query dim (one _CarriedState
# per lane), each chunk runs as ONE stacked dispatch over the live lanes
# (one `score_topk_lanes` launch per chunk where the lanes take the fused
# kernel), and every chunk boundary applies PER-QUERY masks: a lane
# cancelled or expired mid-scan leaves the later dispatches (valid=False)
# while the surviving lanes keep scanning. Early termination and threshold
# tightening are per lane: each query's own ThresholdBox and carried Kth
# value drive it. Preemption is a GROUP decision at the highest priority
# among live lanes: a group carrying an interactive rider never parks for
# interactive work elsewhere, and the park is byte-accounted once for the
# summed carried state.
#
# Two departures from the JAX group scan, as in the port's solo scan: the
# carried state merges through `merge_topk_chunks`, which ranks floats as
# the fused selections do (the JAX lexsort ranks the two zeros equal and
# NaN last), and a dense chunk rebases EVERY lane's doc ids to global doc
# space (the JAX scan rebases only sort values > -inf, so a NaN hit would
# keep its window-local id). A lane cancelled mid-scan answers with a
# result marked "partial", which the leaf reports as a failed split and no
# cache tier keeps.

def execute_group_chunked(plans: list, k: int, arrays_list: list, *,
                          valid=None, tboxes=None, deadlines=None,
                          cancels=None, tenants=None,
                          fault_injector=None,
                          span: Optional[int] = None,
                          device=None) -> Optional[list]:
    """Run a shape-compatible query group as one chunked stacked scan on
    `device` (default `cuda`; where the arrays lie).

    Returns a list aligned with `plans`: per lane a result dict, an
    exception instance (CancelledQuery / DeadlineExceeded — the batcher
    fans it to that rider), or None for a lane masked on entry. Returns
    None (the group does not chunk) when the shared structure is
    ineligible or too small to span two chunks — the caller then runs one
    fused stacked dispatch."""
    if not CHUNKING.enabled:
        return None
    base = plans[0]
    mode_info = chunk_mode(base)
    if mode_info is None:
        return None
    mode, total, align = mode_info
    if total <= 0:
        return None
    if span is None:
        span = (CHUNKING.posting_span if mode == "posting"
                else CHUNKING.doc_span)
    if span is None:
        span = CHUNK_SIZER.span_for(mode, align)
    if span is None or span <= 0:
        return None
    spans = chunk_spans(total, span, align)
    if len(spans) < 2:
        return None

    q = len(plans)
    valid = list(valid) if valid is not None else [True] * q
    tboxes = list(tboxes) if tboxes is not None else [None] * q
    deadlines = list(deadlines) if deadlines is not None else [None] * q
    cancels = list(cancels) if cancels is not None else [None] * q
    if tenants is None:
        tenants = [effective_tenant()] * q
    bounds = [(_host_chunk_bounds(p, spans) if mode == "posting" else None)
              for p in plans]
    early_ok = [_early_term_eligible(p, k, mode) for p in plans]
    ids_slots = (frozenset(ids for ids, _ in
                           chunk_slot_plan(base).posting_pairs)
                 if mode == "dense" else frozenset())

    for _attempt in range(2):
        try:
            return _run_group_scan(plans, k, arrays_list, device, mode, spans,
                                   bounds, early_ok, ids_slots, list(valid),
                                   tboxes, deadlines, cancels, tenants,
                                   fault_injector)
        except _RestartScan:
            CHUNK_RESTARTS_TOTAL.inc()
            continue
    # two carried-state losses in a row: finish as one fused stacked
    # dispatch — the group degrades to the unchunked stacked path instead
    # of livelocking the scan
    return executor.readback_plan_stacked(executor.dispatch_plan_stacked(
        plans, k, arrays_list, valid=valid, device=device))


def _group_park_lane(live, tenants):
    """The lane whose tenant charges (and whose priority gates) a group
    park: the highest-priority live lane."""
    lanes = [i for i, alive in enumerate(live) if alive]
    return max(lanes, key=lambda i: tenants[i].priority)


def _run_group_scan(plans, k, arrays_list, device, mode, spans, bounds,
                    early_ok, ids_slots, live, tboxes, deadlines, cancels,
                    tenants, fault_injector):
    clock = get_clock()
    q = len(plans)
    states = [_CarriedState() for _ in range(q)]
    outcome: dict[int, Any] = {}
    thresholds = [
        (float(np.asarray(p.scalars[p.threshold_slot]))
         if p.threshold_slot >= 0 else None)
        for p in plans]
    _, stacked_slots = executor.stacked_slot_split(plans)
    last_boundary = clock.monotonic()
    for index, (lo, hi) in enumerate(spans):
        if index > 0:
            now = clock.monotonic()
            CHUNK_BOUNDARY_SECONDS.observe(now - last_boundary)
            last_boundary = now
            if flight.recording():
                flight.emit("chunk.boundary",
                            attrs={"index": index, "of": len(spans),
                                   "lanes": int(sum(live))})
            # (a) per-query kill masks: a cancelled/expired lane leaves
            # the dispatch via its validity flag — the group's structure
            # never changes mid-scan
            for i in range(q):
                if not live[i]:
                    continue
                token = cancels[i]
                if token is not None and token.cancelled:
                    if CHUNKING.partial_on_cancel \
                            and states[i].chunks_done > 0:
                        outcome[i] = states[i].to_result(k, partial=True)
                    else:
                        outcome[i] = CancelledQuery(
                            "chunked group boundary", token.reason)
                    live[i] = False
                    continue
                if deadlines[i] is not None and deadlines[i].expired:
                    outcome[i] = DeadlineExceeded("chunked group boundary")
                    live[i] = False
            if not any(live):
                break
            # chaos: a yield fault discards the whole group's carried
            # state — all lanes restart together (same contract as solo)
            if fault_injector is not None:
                try:
                    fault_injector.perturb("kernel.chunk_yield")
                except InjectedFault as exc:
                    raise _RestartScan() from exc
            # (b) group preempt at the max live priority: parks only when
            # EVERY live lane is outranked by the active higher class
            park_lane = _group_park_lane(live, tenants)
            park_tenant = tenants[park_lane]
            if PREEMPT_GATE.should_yield(park_tenant.priority):
                PREEMPT_TOTAL.inc()
                ticket = PARKED_STATES.park(
                    park_tenant.tenant_id,
                    sum(states[i].nbytes() for i in range(q) if live[i]))
                if flight.recording():
                    flight.emit("chunk.preempt_park",
                                attrs={"bytes": ticket.nbytes,
                                       "priority": park_tenant.priority,
                                       "lanes": int(sum(live))})
                try:
                    if fault_injector is not None:
                        fault_injector.perturb("kernel.preempt_park")
                    PREEMPT_GATE.wait_until_clear(
                        park_tenant.priority, CHUNKING.max_park_secs,
                        deadline=deadlines[park_lane],
                        token=cancels[park_lane])
                except InjectedFault as exc:
                    ticket.evicted = True
                    raise _RestartScan() from exc
                finally:
                    PARKED_STATES.release(ticket)
                if ticket.evicted:
                    flight.emit("chunk.preempt_evict")
                    raise _RestartScan()
                flight.emit("chunk.preempt_resume")
            # (c) per-lane early termination + threshold tightening
            for i in range(q):
                if not live[i]:
                    continue
                kth = states[i].kth_value(k)
                if (early_ok[i] and kth is not None and bounds[i] is not None
                        and index < len(bounds[i])
                        and float(bounds[i][index:].max()) <= kth):
                    CHUNK_EARLY_TERMINATIONS_TOTAL.inc()
                    if flight.recording():
                        flight.emit("chunk.early_term",
                                    attrs={"after": index, "lane": i})
                    result = states[i].to_result(k)
                    result["count"] = plans[i].count_override
                    outcome[i] = result
                    live[i] = False
                    continue
                if thresholds[i] is not None:
                    box_value = (tboxes[i].get()
                                 if tboxes[i] is not None else None)
                    for candidate in (box_value, kth):
                        if candidate is not None \
                                and candidate > thresholds[i]:
                            thresholds[i] = candidate
        if not any(live):
            break
        chunks = []
        for i in range(q):
            chunk = (posting_chunk_plan(plans[i], lo, hi)
                     if mode == "posting"
                     else dense_chunk_plan(plans[i], lo, hi - lo))
            if thresholds[i] is not None:
                chunk.scalars[plans[i].threshold_slot] = \
                    np.float64(thresholds[i])
            chunks.append(chunk)
        if (mode == "dense" and chunks[0].num_docs <= 0
                and all(states[i].chunks_done > 0
                        for i in range(q) if live[i])):
            continue  # fully past num_docs for every lane: nothing to add
        rebase = (lo, hi - lo, ids_slots) if mode == "dense" else None
        # the first live lane makes every slot (the shared ones are read
        # from it), the other live lanes only their stacked slots, and a
        # masked lane nothing: no device work for what the dispatch skips
        first = live.index(True)
        chunk_devs = [
            (_chunk_device_arrays(plans[i], chunks[i], arrays_list[i],
                                  rebase,
                                  None if i == first else stacked_slots)
             if live[i] else None)
            for i in range(q)]
        t0 = clock.monotonic()
        results = executor.readback_plan_stacked(
            executor.dispatch_plan_stacked(chunks, k, chunk_devs,
                                           valid=list(live), device=device))
        CHUNK_DISPATCHES_TOTAL.inc()
        CHUNK_SIZER.observe(mode, hi - lo, clock.monotonic() - t0)
        for i in range(q):
            if not live[i] or results[i] is None:
                continue
            result = results[i]
            if mode == "dense" and k > 0:
                # window-local ids of every lane rebase to global doc space
                # (a NaN sort value is a live hit too)
                result["doc_ids"] = (result["doc_ids"] + lo).astype(np.int32)
            states[i].absorb(result, k)
    for i in range(q):
        if live[i]:
            outcome[i] = states[i].to_result(k)
    return [outcome.get(i) for i in range(q)]
