"""Flight recorder: the always-on device-timeline black box.

Role of the reference's Datadog-side continuous telemetry (the fork's
runtime emits its own traces/metrics into the platform that hosts it):
between the per-query profile waterfall (`observability/profile.py`) and
the aggregate Prometheus counters there was no way to reconstruct *what
the device and its queues were doing* around an incident. The flight
recorder closes that gap: every hot subsystem emits typed lifecycle
events — batcher group formation/shedding, staging uploads vs resident
hits, compile-cache hit/miss, dispatch launch/readback, chunk boundaries
and preemption park/evict/resume, mesh collective phases, cache-tier
hit/fill/evict, DRR admission grants, overload-ladder transitions,
cancellation — into per-thread ring buffers that are always recording
and bounded in both memory and overhead.

Design constraints, all load-bearing:

- **Per-thread rings, lock-free appends.** Each thread owns a fixed-size
  ring (`threading.local` lookup + list slot store); the only lock is the
  registry lock taken once per thread lifetime (constructed through the
  `common/sync.py` seam). Overwrite-oldest semantics: a storm costs
  events, never memory or blocking.
- **Clock seam.** Timestamps come from `common/clock.monotonic()` (this
  module is qwlint QW006-scoped), so under the DST harness a recording is
  a pure function of the run: virtual time in, byte-identical timeline
  out. `dst_tail()` exports only the *calling thread's* ring — the DST op
  thread — so the embedded artifact timeline is deterministic by
  construction even when worker pools race.
- **Zero allocation when disabled.** `QW_DISABLE_FLIGHT=1` (or
  `FLIGHT.disable()`) makes `emit()` a single attribute check and return;
  no tuples, dicts or label lookups are built. Call sites that must
  *compute* attributes guard with `FLIGHT.recording()` first, mirroring
  the `_NULL_PHASE` pattern in `profile.py`.
- **Attribution for free.** When `query_id`/`tenant` are not passed,
  `emit()` reads the ambient `QueryProfile` and `TenantContext`
  contextvars (one get each) so every event in a query's flow correlates
  without threading ids through signatures; an active OTLP span's
  traceparent is captured for span correlation in the Chrome export.

Exports: `to_chrome_trace()` renders the merged timeline as Chrome
trace-event / Perfetto JSON; `tail_for_query()` returns a query's events;
`dst_tail()` is the calling thread's deterministic tail. The recorder
holds host-side events, as the JAX one does. Its two exporters are the
REST route `GET /api/v1/developer/trace` (`serve/rest.py`) and
`python -m quickwit_tpu_torch.cli trace export` (`cli.py`).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

from ..common import sync
from ..common.clock import monotonic
from .metrics import (
    FLIGHT_DROPPED_EVENTS, FLIGHT_EVENTS_TOTAL, FLIGHT_EXPORTS_TOTAL,
    FLIGHT_THREADS,
)

DEFAULT_CAPACITY = int(os.environ.get("QW_FLIGHT_CAPACITY", 4096))


def _env_disabled() -> bool:
    return os.environ.get("QW_DISABLE_FLIGHT", "").strip().lower() \
        in ("1", "true", "yes")


# Ambient-context accessors, bound on first emit. They cannot be plain
# top-level imports (profile/tenancy/tracing would form an import cycle
# through the subsystems that import this module), but a `from x import y`
# *inside* emit() costs ~6us/call in importlib machinery — the hot path
# resolves them once and caches the callables here.
_HOT_BINDINGS: Optional[tuple] = None


def _hot_bindings() -> tuple:
    global _HOT_BINDINGS
    if _HOT_BINDINGS is None:
        from ..tenancy.context import current_tenant
        from .profile import current_profile
        from .tracing import TRACER
        _HOT_BINDINGS = (current_profile, current_tenant,
                         TRACER.current_traceparent)
    return _HOT_BINDINGS


class _Ring:
    """One thread's event ring. Appends are lock-free: only the owning
    thread writes, readers take a racy-but-safe snapshot (slots hold
    immutable tuples; a torn read can at worst miss/duplicate the event
    being written, acceptable for a diagnostic export)."""

    __slots__ = ("tid", "name", "capacity", "buf", "idx", "seq", "dropped",
                 "counts", "flushed")

    def __init__(self, tid: int, name: str, capacity: int):
        self.tid = tid            # logical id (registration order), not OS id
        self.name = name
        self.capacity = capacity
        self.buf: list = [None] * capacity
        self.idx = 0              # next write slot
        self.seq = 0              # events ever written (per-thread order)
        self.dropped = 0          # events overwritten by ring wrap
        # per-kind event counts, owner-thread writes only: the labeled
        # Prometheus counter costs a lock + label-key sort per inc, which
        # is too much for the emit hot path — counts accumulate here and
        # fold into FLIGHT_EVENTS_TOTAL at snapshot/scrape time
        self.counts: dict = {}
        self.flushed: dict = {}   # counts already folded into the metric

    def append(self, event: tuple) -> None:
        i = self.idx
        if self.buf[i] is not None:
            self.dropped += 1
        self.buf[i] = event
        self.idx = (i + 1) % self.capacity
        self.seq += 1

    def snapshot(self) -> list:
        """Events oldest -> newest (per-thread seq order)."""
        i, buf = self.idx, list(self.buf)
        ordered = [e for e in buf[i:] + buf[:i] if e is not None]
        return ordered

    def clear(self) -> None:
        self.buf = [None] * self.capacity
        self.idx = 0
        self.seq = 0
        self.dropped = 0
        # flushed resets with counts: the Prometheus counter is monotonic
        # (it keeps what was already folded in), deltas just restart at 0
        self.counts = {}
        self.flushed = {}


def _event_dict(event: tuple, tid: Optional[int] = None,
                with_span: bool = True) -> dict[str, Any]:
    seq, t_ms, kind, query_id, tenant, span, attrs = event
    out: dict[str, Any] = {"t_ms": t_ms, "kind": kind}
    if query_id:
        out["query_id"] = query_id
    if tenant:
        out["tenant"] = tenant
    if with_span and span:
        out["span"] = span
    if attrs:
        out["attrs"] = dict(attrs)
    if tid is not None:
        out["tid"] = tid
    return out


class FlightRecorder:
    """Process-global always-on event recorder (see module docstring)."""

    def __init__(self, capacity_per_thread: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity_per_thread), 16)
        self._lock = sync.lock("FlightRecorder._lock")
        self._rings: list[_Ring] = []
        # threading.local is a plain TLS slot, not a QW008 primitive; the
        # per-thread ring lives here so emit() never takes the registry lock
        self._tl = threading.local()
        self._epoch = monotonic()
        self._enabled = not _env_disabled()

    # --- on/off -----------------------------------------------------------
    def recording(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # --- recording --------------------------------------------------------
    def _ring(self) -> _Ring:
        ring = getattr(self._tl, "ring", None)
        if ring is None:
            with self._lock:
                ring = _Ring(len(self._rings) + 1,
                             threading.current_thread().name, self.capacity)
                self._rings.append(ring)
                FLIGHT_THREADS.set(float(len(self._rings)))
            self._tl.ring = ring
        return ring

    def emit(self, kind: str, query_id: str = "", tenant: str = "",
             attrs: Optional[dict] = None) -> None:
        """Record one typed event. `kind` is `"<subsystem>.<what>"` from a
        fixed vocabulary (greppable at the call sites). When `query_id` /
        `tenant` are empty they are resolved from the ambient profile and
        tenant contextvars. Disabled -> one attribute check, no allocation.
        """
        if not self._enabled:
            return
        current_profile, current_tenant, current_traceparent = \
            _HOT_BINDINGS or _hot_bindings()
        t_ms = round((monotonic() - self._epoch) * 1000.0, 3)
        if not query_id:
            profile = current_profile()
            if profile is not None:
                query_id = profile.query_id
        if not tenant:
            ctx = current_tenant()
            if ctx is not None:
                tenant = ctx.tenant_id
        span = current_traceparent()
        ring = self._ring()
        ring.append((ring.seq, t_ms, kind, query_id, tenant, span, attrs))
        counts = ring.counts
        counts[kind] = counts.get(kind, 0) + 1

    # --- run boundaries (DST) --------------------------------------------
    def begin_run(self) -> None:
        """Reset all rings and rebase the epoch on the *current* clock —
        the DST harness calls this after installing the FakeClock so every
        run's timeline starts at t=0 virtual and is a pure function of the
        run inputs."""
        with self._lock:
            for ring in self._rings:
                ring.clear()
            self._epoch = monotonic()

    reset = begin_run  # test-friendly alias

    # --- export -----------------------------------------------------------
    def _snapshot_rings(self) -> list[_Ring]:
        with self._lock:
            rings = list(self._rings)
            FLIGHT_DROPPED_EVENTS.set(float(sum(r.dropped for r in rings)))
            # fold per-ring event counts into the labeled Prometheus
            # counter (deltas only; the counter stays monotonic across
            # begin_run ring clears)
            for ring in rings:
                for kind, n in list(ring.counts.items()):
                    delta = n - ring.flushed.get(kind, 0)
                    if delta:
                        FLIGHT_EVENTS_TOTAL.inc(
                            delta, subsystem=kind.split(".", 1)[0])
                        ring.flushed[kind] = n
        return rings

    def flush_metrics(self) -> None:
        """Fold buffered event counts into `qw_flight_*` metrics. emit()
        never touches the labeled counter (lock + label-key sort per inc
        is too slow for the hot path); the /metrics scrape and every
        export path call this instead."""
        self._snapshot_rings()

    def events(self, limit: Optional[int] = None,
               with_span: bool = True) -> list[dict[str, Any]]:
        """Merged timeline across every thread, oldest -> newest, ordered
        by (t_ms, tid, per-thread seq)."""
        merged: list[tuple] = []
        for ring in self._snapshot_rings():
            merged.extend((e[1], ring.tid, e[0], e)
                          for e in ring.snapshot())
        merged.sort(key=lambda x: (x[0], x[1], x[2]))
        if limit is not None and len(merged) > limit:
            merged = merged[-limit:]
        return [_event_dict(e, tid=tid, with_span=with_span)
                for _, tid, _, e in merged]

    def tail_for_query(self, query_id: str,
                       limit: int = 96) -> list[dict[str, Any]]:
        """The most recent events attributed to `query_id`, merged across
        threads — attached to slowlog entries so a slow query carries the
        device timeline that produced it."""
        if not query_id:
            return []
        merged: list[tuple] = []
        for ring in self._snapshot_rings():
            merged.extend((e[1], ring.tid, e[0], e)
                          for e in ring.snapshot() if e[3] == query_id)
        merged.sort(key=lambda x: (x[0], x[1], x[2]))
        if len(merged) > limit:
            merged = merged[-limit:]
        return [_event_dict(e, tid=tid) for _, tid, _, e in merged]

    def dst_tail(self, limit: int = 256) -> list[dict[str, Any]]:
        """The calling thread's own timeline tail, stripped of every
        nondeterministic field (no OS/logical thread ids, no random span
        ids): under the DST harness this is byte-identical across replays
        of the same (scenario, seed, ops, fault plan). `compile.*` events
        are filtered: the JIT executable caches are per-process, so
        hit-vs-miss reflects what *earlier* runs compiled — true process
        state, but not a function of this run's inputs."""
        events = [e for e in self._ring().snapshot()
                  if not e[2].startswith("compile.")]
        if len(events) > limit:
            events = events[-limit:]
        return [_event_dict(e, with_span=False) for e in events]

    def to_chrome_trace(self, limit: Optional[int] = None,
                        process_name: str = "quickwit_tpu_torch"
                        ) -> dict[str, Any]:
        """Chrome trace-event / Perfetto JSON: instant events (`ph: "i"`,
        thread-scoped) or complete events (`ph: "X"`) when the emitting
        site measured a duration (`attrs["dur_ms"]`), with query-id /
        tenant / traceparent correlation in `args`."""
        FLIGHT_EXPORTS_TOTAL.inc()
        rings = self._snapshot_rings()
        trace_events: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": process_name}},
        ]
        for ring in rings:
            trace_events.append(
                {"name": "thread_name", "ph": "M", "pid": 1,
                 "tid": ring.tid, "args": {"name": ring.name}})
        merged: list[tuple] = []
        for ring in rings:
            merged.extend((e[1], ring.tid, e[0], e)
                          for e in ring.snapshot())
        merged.sort(key=lambda x: (x[0], x[1], x[2]))
        if limit is not None and len(merged) > limit:
            merged = merged[-limit:]
        for t_ms, tid, _seq, event in merged:
            _, _, kind, query_id, tenant, span, attrs = event
            args: dict[str, Any] = {}
            if query_id:
                args["query_id"] = query_id
            if tenant:
                args["tenant"] = tenant
            if span:
                args["traceparent"] = span
            if attrs:
                args.update(attrs)
            record: dict[str, Any] = {
                "name": kind, "cat": kind.split(".", 1)[0],
                "ts": int(round(t_ms * 1000.0)),   # microseconds
                "pid": 1, "tid": tid, "args": args,
            }
            dur_ms = attrs.get("dur_ms") if attrs else None
            if dur_ms is not None:
                record["ph"] = "X"
                record["dur"] = max(int(round(float(dur_ms) * 1000.0)), 1)
            else:
                record["ph"] = "i"
                record["s"] = "t"
            trace_events.append(record)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "metadata": {"recorder": "quickwit_tpu_torch.flight",
                             "dropped_events":
                                 sum(r.dropped for r in rings)}}

    def stats(self) -> dict[str, Any]:
        rings = self._snapshot_rings()
        return {"enabled": self._enabled,
                "capacity_per_thread": self.capacity,
                "threads": len(rings),
                "events": sum(min(r.seq, r.capacity) for r in rings),
                "dropped": sum(r.dropped for r in rings)}


# Process-global recorder, matching METRICS / SLOW_QUERY_LOG / OVERLOAD:
# every subsystem emits into it, the REST/CLI exporters read from it.
FLIGHT = FlightRecorder()


# Module-level shorthand for `FLIGHT.emit` (the hot-path spelling): the
# bound method directly, so an emit costs one call frame, and a disabled
# emit is that frame plus a single attribute check.
emit = FLIGHT.emit


def recording() -> bool:
    """True when emitting records. Sites that must allocate attrs dicts
    guard with this so the disabled path stays allocation-free."""
    return FLIGHT._enabled
