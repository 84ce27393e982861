"""Per-query execution profiles: the phase waterfall.

Role of the reference's "quickwit observes quickwit" loop
(`quickwit-telemetry` + per-request `tracing` spans): a single query can be
asked *where it spent its time* — plan build, HBM admission wait, batcher
queue wait, host→device staging (an upload or a resident hit), the device
dispatches and their readbacks, top-K merge, pruning decisions, root
merge — instead of only moving coarse counters.

A `QueryProfile` is created at root admission (or at the leaf entry point
for remote leaves) and travels ambiently through the stack via a
`contextvars.ContextVar`, mirroring `common/deadline.py` exactly: deep
layers (admission, storage wrappers, the executor) report into
`current_profile()` with no signature changes, and thread-pool hops rebind
with `bind_profile`. When no profile is bound — the default — every hook is
one ContextVar get returning None: no phase objects are allocated and no
clock is read on the hot path.

Phase times are on `time.perf_counter()`, relative to the profile's origin
(`to_dict()["origin_s"]`), so a caller on the same clock can lay a phase
against its own timeline. A timed phase also carries `cpu_ms`, the
recording thread's CPU time over it: what of `duration_ms` the thread
spent off the CPU (a lock, the GIL, a blocking copy) is the difference.
The `device_dispatches` counter counts the device programs launched for
the query, a dispatch shared by several queries once for each of them.

While a `torch.profiler` records, each timed phase opens a
`record_function("qw.<name>")` range (`"qw.<name>.<stage>"` when it has a
stage), so it lands in the device trace on that trace's clock, over the
kernels it launched. The test is the process-wide flag a starting profiler
sets, not the thread's own: the fan-out's pool threads record their
phases, and a profiler that records every thread (`profile_all_threads`)
keeps those ranges. While the process tracer (`observability/tracing.py`)
has a processor, such as a node's OTLP exporter, each timed phase also
opens a `phase.<name>` span so the waterfall stitches into OTLP traces.
Phase durations feed the `qw_search_phase_seconds` histogram (labeled by
phase) so fleet-wide attribution is queryable without capturing any
single profile.
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Optional

import torch
from torch.autograd import profiler as _torch_profiler

from .metrics import SEARCH_PHASE_SECONDS

# Canonical phase names (used by search/*, storage/*, serve/*). Keeping them
# here makes the waterfall schema greppable in one place; ad-hoc names are
# still allowed for one-off experiments.
PHASE_PLAN_BUILD = "plan_build"
PHASE_ADMISSION_WAIT = "admission_wait"
PHASE_BATCHER_QUEUE = "batcher_queue_wait"
# group-formation wait: time a rider spent queued while a multi-QUERY
# stacked group assembled around it (search/batcher.py QueryGroupPlanner);
# recorded INSTEAD of batcher_queue_wait for riders that dispatched as part
# of a group of distinct queries, so dashboards can attribute convoy wait
# vs group-formation wait separately
PHASE_QBATCH_GROUP = "qbatch_group_wait"
# staging split by outcome (ROADMAP item 1 attribution): an upload that
# actually moved column bytes vs a resident-store hit that moved none
PHASE_STAGING_UPLOAD = "staging_upload"
PHASE_STAGING_CACHE_HIT = "staging_cache_hit"
PHASE_EXECUTE = "execute"
PHASE_TOPK_MERGE = "topk_merge"
PHASE_ROOT_MERGE = "root_merge"
PHASE_FETCH_DOCS = "fetch_docs"

# the counter of device programs launched for the query
DEVICE_DISPATCHES = "device_dispatches"
# the aggregation nodes the query's split programs evaluated, and those of
# them that the one-pass aggregation kernel computed (search/executor.py)
AGG_EVALS = "agg_evals"
AGG_KERNEL_EVALS = "agg_kernel_evals"
# the split programs that selected hits, and those of them whose top-k the
# fused CUDA kernel (`score_topk` or `score_topk_lanes`) computed
# (search/executor.py)
TOPK_EVALS = "topk_evals"
TOPK_KERNEL_EVALS = "topk_kernel_evals"
# the documents the root's fetch returned, and the doc-store blocks it
# decompressed (search/root.py, index/reader.py)
DOCS_FETCHED = "docs_fetched"
STORE_BLOCKS_READ = "store_blocks_read"


class _NullPhase:
    """Reusable no-op context manager: the profiling-off path allocates
    nothing per call (acceptance: profile disabled adds no measurable
    per-query allocation on the hot path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class QueryProfile:
    """Thread-safe per-query phase timeline + counters.

    Phases are recorded as dicts `{"name", "start_ms", "duration_ms",
    ...attrs}` with `start_ms` relative to the profile's origin (a
    `time.perf_counter()` reading taken at creation); a timed phase adds
    `cpu_ms`. Concurrent phases (fan-out threads, pool workers) simply
    overlap on the timeline. A phase aborted by an exception (deadline
    shed, injected fault) is STILL recorded, with its real partial duration
    and `"aborted": true` — profiles of shed queries must report partial
    phases, never zeros.
    """

    __slots__ = ("query_id", "origin", "wall_ms", "partial",
                 "_phases", "_counters", "_children", "_lock")

    def __init__(self, query_id: str = ""):
        self.query_id = query_id
        self.origin = time.perf_counter()
        self.wall_ms: Optional[float] = None
        # set when the query was shed / timed out mid-flight: the waterfall
        # below it is truthful-but-incomplete
        self.partial: Optional[str] = None
        self._phases: list[dict[str, Any]] = []
        self._counters: dict[str, float] = {}
        # profiles returned by REMOTE leaves over the wire (embedded leaves
        # write into this profile directly through the ambient binding)
        self._children: list[dict[str, Any]] = []
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    # --- recording ---------------------------------------------------------
    @contextmanager
    def phase(self, name: str, **attrs: Any):
        """Time one phase, on the wall clock and on the thread's CPU clock.
        Opens a `qw.<name>[.<stage>]` range while a torch profiler records
        and a `phase.<name>` span while the tracer has a processor. Yields
        the mutable record so callers can attach result attributes (bytes,
        cache hit, threshold, ...)."""
        from .tracing import TRACER
        record: dict[str, Any] = dict(attrs)
        record["name"] = name
        span = (TRACER.span(f"phase.{name}") if TRACER.has_processors()
                else _NULL_PHASE)
        if _torch_profiler._is_profiler_enabled:
            stage = attrs.get("stage")
            device_range = torch.profiler.record_function(
                f"qw.{name}.{stage}" if stage else f"qw.{name}")
        else:
            device_range = _NULL_PHASE
        start = time.perf_counter()
        cpu_start = time.thread_time()
        record["start_ms"] = round((start - self.origin) * 1000.0, 3)
        try:
            with span, device_range:
                yield record
        except BaseException:
            record["aborted"] = True
            raise
        finally:
            cpu = time.thread_time() - cpu_start
            elapsed = time.perf_counter() - start
            record["duration_ms"] = round(elapsed * 1000.0, 3)
            record["cpu_ms"] = round(cpu * 1000.0, 3)
            with self._lock:
                self._phases.append(record)
            SEARCH_PHASE_SECONDS.observe(elapsed, phase=name)

    def record_phase(self, name: str, duration_secs: float,
                     start: Optional[float] = None, **attrs: Any) -> None:
        """Record an already-measured phase (for waits timed inside
        third-party blocking calls, e.g. the batcher follower wait).
        `start` is a `time.perf_counter()` reading."""
        record: dict[str, Any] = dict(attrs)
        record["name"] = name
        origin = start if start is not None \
            else time.perf_counter() - duration_secs
        record["start_ms"] = round((origin - self.origin) * 1000.0, 3)
        record["duration_ms"] = round(duration_secs * 1000.0, 3)
        with self._lock:
            self._phases.append(record)
        SEARCH_PHASE_SECONDS.observe(duration_secs, phase=name)

    def add(self, counter: str, amount: float = 1.0) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0.0) + amount

    def set_counter(self, counter: str, value: float) -> None:
        with self._lock:
            self._counters[counter] = value

    def mark_partial(self, reason: str) -> None:
        """First shed/timeout reason wins; later sheds keep the original."""
        with self._lock:
            if self.partial is None:
                self.partial = reason

    def add_child(self, child: dict[str, Any]) -> None:
        """Attach a remote leaf's serialized profile (arrived on the wire).
        Its phase durations roll up into this profile's histogram-free
        waterfall via `to_dict(...)["leaves"]`."""
        if child:
            with self._lock:
                self._children.append(child)

    def absorb(self, other: "QueryProfile") -> None:
        """Take in what `other` recorded: its phases, moved onto this
        profile's timeline, its counters, children and partial mark."""
        shift = (other.origin - self.origin) * 1000.0
        with other._lock:
            phases = [dict(p) for p in other._phases]
            counters = dict(other._counters)
            children = list(other._children)
        for p in phases:
            p["start_ms"] = round(p["start_ms"] + shift, 3)
        with self._lock:
            self._phases.extend(phases)
            for counter, amount in counters.items():
                self._counters[counter] = \
                    self._counters.get(counter, 0.0) + amount
            self._children.extend(children)
        if other.partial is not None:
            self.mark_partial(other.partial)

    def finish(self, wall_secs: Optional[float] = None) -> None:
        elapsed = wall_secs if wall_secs is not None \
            else time.perf_counter() - self.origin
        self.wall_ms = round(elapsed * 1000.0, 3)

    # --- views -------------------------------------------------------------
    def phases(self) -> list[dict[str, Any]]:
        with self._lock:
            return sorted((dict(p) for p in self._phases),
                          key=lambda p: p["start_ms"])

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def phase_ms(self, name: str) -> float:
        """Total milliseconds recorded under `name` (all occurrences)."""
        with self._lock:
            return sum(p.get("duration_ms", 0.0) for p in self._phases
                       if p["name"] == name)

    def phase_ms_recursive(self, name: str) -> float:
        """Total milliseconds under `name` including remote leaves' child
        profiles — the cross-node attribution tenancy accounting charges
        (an embedded leaf writes into this profile directly, a remote one
        arrives as a child)."""
        def from_child(child: dict) -> float:
            total = sum(p.get("duration_ms", 0.0)
                        for p in child.get("phases", ())
                        if p.get("name") == name)
            return total + sum(from_child(c)
                               for c in child.get("leaves", ()))
        with self._lock:
            own = sum(p.get("duration_ms", 0.0) for p in self._phases
                      if p["name"] == name)
            children = [dict(c) for c in self._children]
        return own + sum(from_child(c) for c in children)

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            phases = sorted((dict(p) for p in self._phases),
                            key=lambda p: p["start_ms"])
            counters = dict(self._counters)
            children = [dict(c) for c in self._children]
        out: dict[str, Any] = {"phases": phases, "counters": counters,
                               "origin_s": self.origin}
        if self.query_id:
            out["query_id"] = self.query_id
        if self.wall_ms is not None:
            out["wall_ms"] = self.wall_ms
        if self.partial is not None:
            out["partial"] = self.partial
        if children:
            out["leaves"] = children
        return out


# --- ambient propagation (mirrors common/deadline.py) ----------------------

_CURRENT_PROFILE: contextvars.ContextVar[Optional[QueryProfile]] = (
    contextvars.ContextVar("quickwit_tpu_profile", default=None))


def current_profile() -> Optional[QueryProfile]:
    """The profile bound to this thread of execution, if any."""
    return _CURRENT_PROFILE.get()


@contextmanager
def profile_scope(profile: Optional[QueryProfile]):
    token = _CURRENT_PROFILE.set(profile)
    try:
        yield profile
    finally:
        _CURRENT_PROFILE.reset(token)


def bind_profile(fn: Callable, profile: Optional[QueryProfile] = None,
                 ) -> Callable:
    """Wrap `fn` so it runs under `profile` (default: the caller's current
    profile). Needed for ThreadPoolExecutor hops — contextvars do not
    propagate into pool worker threads automatically. When the captured
    profile is None the wrapper still rebinds None, which is free."""
    captured = profile if profile is not None else current_profile()

    def wrapper(*args, **kwargs):
        with profile_scope(captured):
            return fn(*args, **kwargs)

    return wrapper


def profiled_phase(name: str, **attrs: Any):
    """`with profiled_phase("execute", stage="dispatch") as rec:` — times
    the block into the ambient profile, or is a shared no-op when no
    profile is bound. `rec` is the mutable phase record (None when
    profiling is off)."""
    profile = _CURRENT_PROFILE.get()
    if profile is None:
        return _NULL_PHASE
    return profile.phase(name, **attrs)


def profile_add(counter: str, amount: float = 1.0) -> None:
    """Bump a counter on the ambient profile; no-op (one ContextVar get)
    when profiling is off."""
    profile = _CURRENT_PROFILE.get()
    if profile is not None:
        profile.add(counter, amount)


def note_dispatch() -> None:
    """One device program launched for the ambient query (one ContextVar
    get when profiling is off)."""
    profile = _CURRENT_PROFILE.get()
    if profile is not None:
        profile.add(DEVICE_DISPATCHES)


def shared_dispatch(riders: Iterable[Optional[QueryProfile]]):
    """`with shared_dispatch(profiles):` around a dispatch that this thread
    makes for several queries (the batcher's convoys and query groups).
    The device dispatches the block launches count once on each rider's
    profile as well as on this thread's own; everything else the block
    records goes to this thread's profile alone. A shared no-op when no
    other rider is profiled."""
    owner = _CURRENT_PROFILE.get()
    others = [p for p in riders if p is not None and p is not owner]
    if not others:
        return _NULL_PHASE
    return _shared_dispatch(owner, others)


@contextmanager
def _shared_dispatch(owner: Optional[QueryProfile],
                     others: list[QueryProfile]):
    tally = QueryProfile(owner.query_id if owner is not None else "")
    try:
        with profile_scope(tally):
            yield
    finally:
        launched = tally.counters().get(DEVICE_DISPATCHES, 0.0)
        if launched:
            for profile in others:
                profile.add(DEVICE_DISPATCHES, launched)
        if owner is not None:
            owner.absorb(tally)
