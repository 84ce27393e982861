"""Prometheus-style metrics registry.

Role of the reference's `quickwit-metrics` macro registry
(`quickwit-metrics/src/lib.rs:44-343`): lazily-registered counters, gauges
and histograms with labels, exposed in Prometheus text format. The port
registers what its modules read: the root searcher (timeouts, retries,
profiled queries, the slow-query log and the SLO tracker), the lowering's
impact prefix cutoff, the leaf and node search service, HBM admission and
the resident column store, the three cache tiers, the chunked scan and
query cancellation, the query batcher and stacking, tenancy, fault
injection and the flight recorder (and, in their own modules, the split
cache's counters). Other subsystems' metrics come with them.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Optional, Sequence

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or the exposition line is unparseable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, value in sorted(self._values.items()):
            lines.append(f"{self.name}{_format_labels(key)} {value:g}")
        return lines


class Gauge:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def add(self, amount: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, value in sorted(self._values.items()):
            lines.append(f"{self.name}{_format_labels(key)} {value:g}")
        return lines


class Histogram:
    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        from bisect import bisect_left
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # raw count at the first bucket with le >= value (cumulative form
            # is computed at exposition); larger values count only in +Inf
            slot = bisect_left(self.buckets, value)
            if slot < len(counts):
                counts[slot] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        key = _label_key(labels)
        counts = self._counts.get(key)
        total = self._totals.get(key, 0)
        if not counts or total == 0:
            return None
        rank = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= rank:
                return self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
        return self.buckets[-1]

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key in sorted(self._counts):
            counts = self._counts[key]
            cumulative = 0
            for bucket, count in zip(self.buckets, counts):
                cumulative += count
                label = dict(key)
                label["le"] = f"{bucket:g}"
                lines.append(
                    f"{self.name}_bucket{_format_labels(_label_key(label))} {cumulative}")
            label = dict(key)
            label["le"] = "+Inf"
            lines.append(
                f"{self.name}_bucket{_format_labels(_label_key(label))} "
                f"{self._totals[key]}")
            lines.append(f"{self.name}_sum{_format_labels(key)} "
                         f"{self._sums[key]:g}")
            lines.append(f"{self.name}_count{_format_labels(key)} "
                         f"{self._totals[key]}")
        return lines


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_text), Counter)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_text), Gauge)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_text, buckets), Histogram)

    def _get_or_create(self, name, factory, expected_type):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = factory()
                self._metrics[name] = metric
            elif not isinstance(metric, expected_type):
                raise TypeError(f"metric {name!r} already registered with another type")
            return metric

    def expose_text(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            lines.extend(metric.expose())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


METRICS = MetricsRegistry()

# --- search robustness (deadline propagation / shedding) --------------------
SEARCH_DEADLINE_REMAINING = METRICS.histogram(
    "qw_search_deadline_remaining_seconds",
    "Remaining deadline budget when a leaf search begins execution")
# Work abandoned because the deadline had already passed, labeled by stage
# (admission queue, leaf group loop, ...).
SEARCH_SHED_TOTAL = METRICS.counter(
    "qw_search_shed_total",
    "Operations shed because the query deadline expired before they ran")
SEARCH_TIMED_OUT_TOTAL = METRICS.counter(
    "qw_search_timed_out_total",
    "Root searches that returned a timed_out partial response")
SEARCH_LEAF_RETRIES_TOTAL = METRICS.counter(
    "qw_search_leaf_retries_total",
    "Leaf requests retried on another node after a failure")
# Phase-2 doc fetches retried once on the next replica (root.py
# _fetch_docs_phase); the leaf retry budget above covers phase 1 only.
SEARCH_FETCH_DOCS_RETRIES_TOTAL = METRICS.counter(
    "qw_search_fetch_docs_retries_total",
    "Per-split doc fetches retried on another replica after a failure")

# --- dynamic top-K split pruning (search/pruning.py) ------------------------
SEARCH_SPLITS_PRUNED_TOTAL = METRICS.counter(
    "qw_search_splits_pruned_by_threshold_total",
    "Splits skipped because their sort bound cannot beat the top-K threshold")
SEARCH_SPLITS_DOWNGRADED_TOTAL = METRICS.counter(
    "qw_search_splits_downgraded_to_count_total",
    "Splits downgraded to count-only requests by the top-K threshold")
SEARCH_KERNEL_THRESHOLD_TOTAL = METRICS.counter(
    "qw_search_kernel_threshold_pushdown_total",
    "Plan executions dispatched with a pushed-down top-K threshold scalar")

# --- impact-ordered postings (format v3, index/impact.py) ------------------
# Host-side prefix-cutoff decisions made at plan lowering: how many
# 128-posting blocks of the sole scoring term stayed live vs were skipped
# (never staged to device memory) because their quantized block-max bound
# could not reach the pushed-down threshold.
IMPACT_BLOCKS_SCORED_TOTAL = METRICS.counter(
    "qw_impact_blocks_scored_total",
    "Impact posting blocks staged and scored (live prefix)")
IMPACT_BLOCKS_SKIPPED_TOTAL = METRICS.counter(
    "qw_impact_blocks_skipped_total",
    "Impact posting blocks skipped by the block-max prefix cutoff")
IMPACT_POSTINGS_BYTES_AVOIDED_TOTAL = METRICS.counter(
    "qw_impact_postings_bytes_avoided_total",
    "Posting bytes (ids+tfs) never staged thanks to the prefix cutoff")
IMPACT_PREFIX_CUTOFFS_TOTAL = METRICS.counter(
    "qw_impact_prefix_cutoffs_total",
    "Plan lowerings that truncated a term's postings to the live prefix")

# --- per-query execution profiles (observability/profile.py) ----------------
SEARCH_PHASE_SECONDS = METRICS.histogram(
    "qw_search_phase_seconds",
    "Wall time spent per query-execution phase (profile waterfall)")
SEARCH_PROFILED_QUERIES_TOTAL = METRICS.counter(
    "qw_search_profiled_queries_total",
    "Root searches that ran with an execution profile attached")
SEARCH_SLOWLOG_RECORDED_TOTAL = METRICS.counter(
    "qw_search_slowlog_recorded_total",
    "Queries captured into the slow-query ring buffer")

# --- multi-tenant workload isolation (tenancy/) -----------------------------
# Tenant labels pass through TenancyRegistry.metric_label, which hashes long
# ids and caps distinct label values.
TENANT_QUERIES_TOTAL = METRICS.counter(
    "qw_tenant_queries_total",
    "Root searches per tenant, labeled by completion status")
TENANT_SHED_TOTAL = METRICS.counter(
    "qw_tenant_shed_total",
    "Queries shed by the overload controller, per tenant and checkpoint")
TENANT_REJECTED_TOTAL = METRICS.counter(
    "qw_tenant_rejected_total",
    "Queries rejected by per-tenant token-bucket rate limits")
TENANT_STAGED_BYTES_TOTAL = METRICS.counter(
    "qw_tenant_staged_bytes_total",
    "HBM bytes admitted (staged) per tenant")
TENANT_EXECUTE_SECONDS_TOTAL = METRICS.counter(
    "qw_tenant_execute_seconds_total",
    "Execution wall time attributed to each tenant from query profiles")
TENANT_ADMISSION_WAIT = METRICS.histogram(
    "qw_tenant_admission_wait_seconds",
    "HBM admission queue wait per tenant")

# --- elastic leaf-search offload pool (offload/) ----------------------------
# One attempt = one leaf-search RPC to one worker. outcome is a small fixed
# enum (ok | error | backpressure | discarded); per-worker breakdowns live
# in WorkerPool.snapshot(), not in labels, so cardinality stays bounded
# however large the elastic fleet gets.
OFFLOAD_DISPATCHES_TOTAL = METRICS.counter(
    "qw_offload_dispatches_total",
    "Leaf-search dispatch attempts to offload workers, by outcome")
OFFLOAD_RETRIES_TOTAL = METRICS.counter(
    "qw_offload_retries_total",
    "Offload tasks re-dispatched to the next rendezvous-ranked worker "
    "after a failure")
OFFLOAD_HEDGES_TOTAL = METRICS.counter(
    "qw_offload_hedges_total",
    "Hedged (backup) dispatches launched against straggler workers, "
    "by outcome (won = the hedge's response was used)")
OFFLOAD_STEALS_TOTAL = METRICS.counter(
    "qw_offload_steals_total",
    "Queued offload tasks stolen from a busy worker's queue by an idle "
    "worker")
OFFLOAD_SPLITS_TOTAL = METRICS.counter(
    "qw_offload_splits_total",
    "Splits routed through the offload pool, by final outcome "
    "(remote = served by a worker, fallback_local = returned to the "
    "local execution path)")
OFFLOAD_POOL_WORKERS = METRICS.gauge(
    "qw_offload_pool_workers",
    "Registered offload workers by health state "
    "(healthy | suspect | ejected)")
OFFLOAD_QUEUE_DEPTH = METRICS.gauge(
    "qw_offload_queue_depth",
    "Offloaded splits currently queued or in flight on the worker pool")
OFFLOAD_DISPATCH_SECONDS = METRICS.histogram(
    "qw_offload_dispatch_seconds",
    "Latency of successful offload dispatch attempts (one worker RPC)")
OFFLOAD_AUTOSCALE_TOTAL = METRICS.counter(
    "qw_offload_autoscale_events_total",
    "Offload pool autoscaler resize events, by direction (up | down)")

# --- hierarchical leaf caches (search/cache.py, search/mask_cache.py,
#     search/agg_cache.py, search/predicate_cache.py) -------------------------
LEAF_CACHE_HITS_TOTAL = METRICS.counter(
    "qw_leaf_cache_hits_total",
    "Whole-split LeafSearchResponse cache hits")
LEAF_CACHE_MISSES_TOTAL = METRICS.counter(
    "qw_leaf_cache_misses_total",
    "Whole-split LeafSearchResponse cache misses")
LEAF_CACHE_EVICTED_BYTES_TOTAL = METRICS.counter(
    "qw_leaf_cache_evicted_bytes_total",
    "Bytes evicted from the leaf response cache under capacity pressure")
PREDICATE_CACHE_HITS_TOTAL = METRICS.counter(
    "qw_predicate_cache_hits_total",
    "Splits proven empty by the term-absence negative cache")
PREDICATE_CACHE_MISSES_TOTAL = METRICS.counter(
    "qw_predicate_cache_misses_total",
    "Negative-cache consults that could not prove the split empty")
PREDICATE_CACHE_EVICTED_BYTES_TOTAL = METRICS.counter(
    "qw_predicate_cache_evicted_bytes_total",
    "Absence-proof bytes evicted from the predicate cache under its "
    "byte/entry bounds")
MASK_CACHE_HITS_TOTAL = METRICS.counter(
    "qw_mask_cache_hits_total",
    "Predicate-mask cache hits (filter bitmask reused across query shapes)")
MASK_CACHE_MISSES_TOTAL = METRICS.counter(
    "qw_mask_cache_misses_total",
    "Predicate-mask cache misses (filter evaluated on device)")
MASK_CACHE_EVICTED_BYTES_TOTAL = METRICS.counter(
    "qw_mask_cache_evicted_bytes_total",
    "Packed mask bytes evicted from the mask cache under capacity pressure")
AGG_CACHE_HITS_TOTAL = METRICS.counter(
    "qw_agg_cache_hits_total",
    "Partial-aggregation cache hits (count or intermediate agg state)")
AGG_CACHE_MISSES_TOTAL = METRICS.counter(
    "qw_agg_cache_misses_total",
    "Partial-aggregation cache misses")
AGG_CACHE_EVICTED_BYTES_TOTAL = METRICS.counter(
    "qw_agg_cache_evicted_bytes_total",
    "Intermediate-agg bytes evicted from the partial-agg cache under "
    "capacity pressure")
# Staging attribution for the mask tier: total staged bytes, the subset
# staged ONLY for predicate evaluation (a mask-cache hit stages zero of
# these), and device program dispatches (a Tier-B short-circuit runs none).
STAGING_BYTES_TOTAL = METRICS.counter(
    "qw_staging_bytes_total",
    "Host-to-device bytes staged by leaf warmup")
PREDICATE_STAGED_BYTES_TOTAL = METRICS.counter(
    "qw_predicate_column_staged_bytes_total",
    "Staged bytes attributable only to predicate evaluation "
    "(postings/fieldnorm/filter-column arrays without a sort or agg "
    "consumer)")
SEARCH_KERNEL_LAUNCHES_TOTAL = METRICS.counter(
    "qw_search_kernel_launches_total",
    "Device program dispatches (search and mask-fill)")

# --- device-resident column store (search/residency.py) ---------------------
RESIDENT_COLUMN_HITS = METRICS.counter(
    "qw_resident_column_hits_total",
    "Columns served from the device-resident store (no host-to-device copy)")
RESIDENT_COLUMN_MISSES = METRICS.counter(
    "qw_resident_column_misses_total",
    "Columns staged cold (one batched host-to-device copy per warmup)")
RESIDENT_STAGING_CACHE_HITS = METRICS.counter(
    "qw_resident_staging_cache_hits_total",
    "Warmups fully served from the resident store: zero columns copied")
RESIDENT_EVICTIONS = METRICS.counter(
    "qw_resident_evictions_total",
    "Resident split column sets evicted (HbmBudget LRU pressure)")
RESIDENT_BYTES = METRICS.gauge(
    "qw_resident_bytes",
    "Device bytes currently held by the resident column store")
RESIDENT_READBACKS_SHED = METRICS.counter(
    "qw_resident_readbacks_shed_total",
    "Async readbacks skipped because every rider's deadline had expired")

# --- query batcher (search/batcher.py) ------------------------------------
# Batching efficiency is queries/dispatches: 1.0 means no coalescing,
# higher means concurrent queries rode shared dispatches. Exported as two
# counters (PromQL rate-ratio friendly) plus a convenience gauge of the
# cumulative ratio.
SEARCH_BATCHER_QUERIES_TOTAL = METRICS.counter(
    "qw_search_batcher_queries_total",
    "Queries entering the cross-query dispatch batcher")
SEARCH_BATCHER_DISPATCHES_TOTAL = METRICS.counter(
    "qw_search_batcher_dispatches_total",
    "Device dispatch rounds issued by the batcher")
SEARCH_BATCHER_RATIO = METRICS.gauge(
    "qw_search_batcher_ratio",
    "Cumulative queries-per-dispatch coalescing ratio of the batcher")
# Time a rider spends queued between enqueue and its dispatch starting —
# the convoy window. Followers pay this to ride a shared dispatch.
SEARCH_BATCHER_QUEUE_WAIT = METRICS.histogram(
    "qw_search_batcher_queue_wait_seconds",
    "Wait between a query entering the batcher and its dispatch starting")

# --- query-group stacking (search/batcher.py QueryGroupPlanner) -----------
# DISTINCT shape-compatible queries stacked into one dispatch along a query
# axis — as opposed to the convoy counters above, which cover riders of one
# identical plan. Reject reasons are a bounded enum (plan_shape |
# group_full), never request-derived.
QBATCH_GROUPS_TOTAL = METRICS.counter(
    "qw_qbatch_groups_total",
    "Query groups (>1 distinct queries) executed as one stacked dispatch")
QBATCH_QUERIES_PER_DISPATCH = METRICS.histogram(
    "qw_qbatch_queries_per_dispatch",
    "Live query lanes per stacked group dispatch",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0))
QBATCH_INCOMPATIBLE_TOTAL = METRICS.counter(
    "qw_qbatch_incompatible_total",
    "Queries that could not join an open group, by bounded reject reason")
QBATCH_MASKED_RIDERS_TOTAL = METRICS.counter(
    "qw_qbatch_masked_riders_total",
    "Riders masked out of an already-formed group (validity lane zeroed) "
    "instead of forcing a group rebuild")
QBATCH_SHARED_BYTES_AVOIDED_TOTAL = METRICS.counter(
    "qw_qbatch_shared_bytes_avoided_total",
    "Operand bytes served once as broadcast slots instead of per-lane "
    "copies in stacked group dispatches")

# --- chaos / fault injection (common/faults.py) -----------------------------
FAULTS_INJECTED_TOTAL = METRICS.counter(
    "qw_faults_injected_total",
    "Faults fired by the deterministic chaos FaultInjector")

# --- resumable chunked leaf scan (search/chunkexec.py) ----------------------
# One increment per chunk program the chunked scan runs; beside
# qw_search_kernel_launches_total it shows how much of the device work runs
# under boundary control.
CHUNK_DISPATCHES_TOTAL = METRICS.counter(
    "qw_chunk_dispatches_total",
    "Chunk programs dispatched by the resumable chunked leaf scan")
# A chunked query that lost its carried state (a parked-state eviction or a
# kernel.chunk_yield fault) and re-executed from chunk 0.
CHUNK_RESTARTS_TOTAL = METRICS.counter(
    "qw_chunk_restarts_total",
    "Chunked queries that discarded carried state and re-executed from scratch")
# The remaining chunks' block-max bounds could not beat the current Kth
# value, so the scan stopped early.
CHUNK_EARLY_TERMINATIONS_TOTAL = METRICS.counter(
    "qw_chunk_early_terminations_total",
    "Chunked scans stopped early by the cross-chunk block-max bound")
# Host wall time between consecutive chunk boundaries (program, readback and
# boundary checks): the bound on cancel and preempt latency.
CHUNK_BOUNDARY_SECONDS = METRICS.histogram(
    "qw_chunk_boundary_seconds",
    "Wall time between consecutive chunk boundaries of the chunked scan")
# A lower-class query yielded at a chunk boundary because the overload
# ladder tripped while a higher-class query was running.
PREEMPT_TOTAL = METRICS.counter(
    "qw_preempt_total",
    "Chunked queries preempted at a boundary in favor of a higher class")
# Bytes of carried top-K/agg state parked by preempted queries (bounded by
# the per-tenant DRR quantum; evictions force restarts).
PREEMPT_PARKED_BYTES = METRICS.gauge(
    "qw_preempt_parked_bytes",
    "Carried chunk state bytes currently parked by preempted queries")
# Cancellations that found (and flipped) a live query's CancellationToken
# in search/cancel.py's registry.
SEARCH_CANCEL_TOTAL = METRICS.counter(
    "qw_search_cancel_total",
    "Explicit query cancellations accepted via the REST cancel surface")

# --- the fan-out's device mesh (parallel/fanout.py mesh route) -------------
# One dispatch = one batch over a device grid: each row scores its shard of
# the splits on its own device, then the candidate gather + re-top-k and
# the agg/count reduce run as copies to the mesh's lead device and
# reductions there; ONE packed readback.
MESH_DISPATCHES_TOTAL = METRICS.counter(
    "qw_mesh_dispatches_total",
    "Whole-query collective programs dispatched over a device mesh")
MESH_DEVICES = METRICS.gauge(
    "qw_mesh_devices",
    "Devices (rows) of the most recent mesh dispatch")
# Logical payload bytes, as the JAX program reports them less its
# threshold-exchange scalar: each collective's operand size summed once per
# dispatch (gathered candidates + reduced agg, count and certificate).
MESH_COLLECTIVE_BYTES_TOTAL = METRICS.counter(
    "qw_mesh_collective_bytes_total",
    "Logical payload bytes moved by on-mesh collectives per dispatch")
# The JAX package's name. The port's mesh runs no threshold exchange
# (parallel/fanout.py), so this stays 0.
MESH_THRESHOLD_EXCHANGE_ROUNDS_TOTAL = METRICS.counter(
    "qw_mesh_threshold_exchange_rounds_total",
    "Cross-device sort-threshold all-reduce (pmax) rounds executed")

# --- flight recorder (observability/flight.py) ------------------------------
FLIGHT_EVENTS_TOTAL = METRICS.counter(
    "qw_flight_events_total",
    "Flight-recorder events recorded, by emitting subsystem")
FLIGHT_DROPPED_EVENTS = METRICS.gauge(
    "qw_flight_dropped_events",
    "Flight-recorder events overwritten by ring wrap (refreshed on export)")
FLIGHT_THREADS = METRICS.gauge(
    "qw_flight_threads",
    "Threads that have registered a flight-recorder ring")
FLIGHT_EXPORTS_TOTAL = METRICS.counter(
    "qw_flight_exports_total",
    "Chrome trace-event exports served")

# --- per-tenant SLO burn accounting (observability/slo.py) ------------------
# Per-priority-class latency objectives: every root query completion is
# judged against its class objective; the burn rate is the windowed breach
# fraction over the class error budget (burn > 1.0 means the budget is
# being spent faster than the objective allows).
SLO_QUERIES_TOTAL = METRICS.counter(
    "qw_slo_queries_total",
    "Root queries judged against their class SLO, by verdict (ok|breach)")
SLO_BURN_RATE = METRICS.gauge(
    "qw_slo_burn_rate",
    "Windowed SLO burn rate per priority class (breach rate over budget)")
SLO_OBJECTIVE_LATENCY_MS = METRICS.gauge(
    "qw_slo_objective_latency_ms",
    "Configured per-priority-class latency objective (milliseconds)")
