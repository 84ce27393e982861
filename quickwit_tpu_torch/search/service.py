"""Search service: the node's leaf-search endpoint on one device.

Role of the reference's `SearchService` trait + `SearchServiceImpl`
(`quickwit-search/src/service.rs:65`) and the leaf entry point
`single_doc_mapping_leaf_search` (`leaf.rs:1887`): search a batch of splits
of one index on this node — split reordering for pruning
(`CanSplitDoBetter`), the three cache tiers, per-split execution with
byte-exact HBM admission over device-resident columns (each split's
program goes through the context's query batcher, search/batcher.py, so
concurrent queries on one split share a dispatch, and may run as a
resumable chunked scan, search/chunkexec.py, fed the query's threshold box
and the context's fault injector), and partial failure collection.

The SearcherContext owns the caches (readers, resident columns per split,
leaf responses, predicate masks, partial aggregations), the admission
budget and the query batcher — the roles of the reference's SearcherContext
(`service.rs:405`) and SearchPermitProvider. One context serves one device:
its resident store, budget and batcher hold that device's tensors. A
context given `mesh_devices` beyond its own device also keeps, keyed
apart, the copies its mesh rows hold on those devices, in the same one
store and budget.

Counterpart of the JAX package's `search/service.py`. A group of
`batch_size` splits takes the batch route (parallel/fanout.py: one dispatch
over the group's splits, the cross-split merge on the device, one
readback) under the JAX service's conditions; every other group runs split
by split. The batch stages each split through the per-split route's own
warmup, so both routes share one resident copy of each split.
`fetch_docs` reads the hits' documents (and their snippets) on the host for
the root's second phase; `LocalSearchClient` is the in-process transport
the root (search/root.py) calls. A request with more splits than
`offload_max_local_splits` sends its cold tail to the context's offload
pool (offload/), whose workers run it on their own devices; what they do
not serve runs here.

The batch route goes over a device mesh (`device_mesh`) when the
context's `mesh_devices` hold more than one device and the group's split
count shards over them, as the JAX service shards over `jax.devices()`:
each mesh row runs its splits on its device and the merge collects on
the mesh's lead device (parallel/fanout.py). `mesh_devices` defaults to
the context's own device alone, so no mesh: a caller names the grid. A
row on the context's device shares the per-split route's resident
copies, so a grid that repeats one card runs the mesh route on that
card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from collections import OrderedDict
from typing import Any, Optional

import torch

from .. import resolve_device
from ..common import sync
from ..common.ctx import run_with_context
from ..common.deadline import (
    CancelledQuery, Deadline, current_cancel_token, current_deadline,
    deadline_scope,
)
from ..index.reader import SplitReader
from ..models.doc_mapper import DocMapper
from ..observability.metrics import (
    RESIDENT_READBACKS_SHED, SEARCH_DEADLINE_REMAINING, SEARCH_SHED_TOTAL,
    SEARCH_SPLITS_DOWNGRADED_TOTAL, SEARCH_SPLITS_PRUNED_TOTAL,
)
from ..observability.profile import (
    QueryProfile, current_profile, profile_scope,
)
from ..observability.tracing import TRACER, RateLimitedLog
from ..parallel.fanout import (
    abandon_dispatch, build_batch, dispatch_batch, is_device_fault,
    readback_batch, release_stack_pin, stage_device_inputs,
)
from ..parallel.mesh import make_mesh
from ..query.ast import MatchAll
from ..storage.base import StorageResolver
from ..tenancy.context import TenantContext, current_tenant, tenant_scope
from ..tenancy.overload import OverloadShed
from ..tenancy.registry import TenantRateLimited
from .admission import HbmBudget
from .agg_cache import PartialAggCache, agg_shape_digest
from .batcher import QueryBatcher
from .cache import (LeafSearchCache, canonical_filter_digest,
                    canonical_request_key)
from .collector import IncrementalCollector
from .executor import compute_packed_mask
from .leaf import (execute_prepared_split, prepare_plan_only,
                   warmup_device_arrays)
from .mask_cache import PredicateMaskCache, packed_mask_nbytes
from .models import (
    FetchDocsRequest, LeafSearchRequest, LeafSearchResponse, SearchRequest,
    SplitIdAndFooter, SplitSearchError, string_sort_of,
)
from .predicate_cache import PredicateCache, required_terms
from .pruning import (
    PruningContext, ScoreBoundCache, ThresholdBox, downgrade_to_count,
    pruning_context, record_split_term_stats, split_best_internal_key,
)
from .residency import ResidentColumnStore
from .snippets import generate_snippets

logger = logging.getLogger(__name__)

# rate_limited_tracing.rs analogue: a bad query fanned over thousands of
# splits must not emit thousands of identical warnings
_SPLIT_WARN_LIMITER = RateLimitedLog(limit=5, period_secs=60.0)


def _warn_split_failure(kind: str, split_id: str, exc: object) -> None:
    emit, suppressed = _SPLIT_WARN_LIMITER.should_log(kind)
    if emit:
        extra = f" ({suppressed} similar suppressed)" if suppressed else ""
        logger.warning("split %s %s failed: %s%s", split_id, kind, exc,
                       extra)


class SearcherContext:
    def __init__(self, storage_resolver: Optional[StorageResolver] = None,
                 max_open_splits: int = 128,
                 leaf_cache_bytes: int = 64 << 20,
                 batch_size: int = 8,
                 prefetch: bool = True,
                 offload: Optional[dict] = None,
                 offload_endpoint: Optional[str] = None,
                 offload_max_local_splits: int = 16,
                 offload_client_factory=None,
                 split_cache=None,
                 enable_threshold_pruning: bool = True,
                 resident_columns: bool = True,
                 mask_cache_bytes: int = 32 << 20,
                 agg_cache_bytes: int = 32 << 20,
                 enable_mask_cache: bool = True,
                 enable_agg_cache: bool = True,
                 fault_injector=None,
                 device=None,
                 mesh_devices=None):
        # the one device this context stages on and runs on (default
        # `cuda`); the resident store and the budget below hold only its
        # tensors, so two contexts on two devices never share a column
        self.device = resolve_device(device)
        # the devices a batch may shard over (`device_mesh`), the
        # counterpart of `jax.devices()`. By default only this context's
        # device, so no mesh: a mesh's copies all go into this context's
        # one store and budget, and a context (an offload worker's, a
        # node's on its card) serves its one device. A device may repeat:
        # [cuda:0] * 4 runs the mesh route on one card.
        self.mesh_devices = [torch.device(d) for d in (
            mesh_devices if mesh_devices is not None else [self.device])]
        self.storage_resolver = storage_resolver or StorageResolver.default()
        # disk-resident split cache (reference SearchSplitCache,
        # split_cache/mod.rs:43): reader opens check it first; misses
        # report the split as a download candidate
        self.split_cache = split_cache
        self.leaf_cache = LeafSearchCache(leaf_cache_bytes)
        # hierarchical leaf caches. Tier A memoizes evaluated filter
        # bitmasks, Tier B memoizes per-split count + intermediate agg
        # states; both key on the canonical FILTER digest so dashboard
        # panels sharing one filter collapse. Constructor flags serve
        # equivalence tests; the QW_DISABLE_* env kill switches serve
        # operators. `fault_injector` threads the chaos points
        # (cache.mask_corrupt / cache.evict / residency.evict) into both
        # tiers and the residency store.
        self.fault_injector = fault_injector
        self.mask_cache = (
            PredicateMaskCache(mask_cache_bytes,
                               fault_injector=fault_injector)
            if enable_mask_cache
            and os.environ.get("QW_DISABLE_MASK_CACHE", "0") != "1"
            else None)
        self.agg_cache = (
            PartialAggCache(agg_cache_bytes, fault_injector=fault_injector)
            if enable_agg_cache
            and os.environ.get("QW_DISABLE_AGG_CACHE", "0") != "1"
            else None)
        self.batch_size = batch_size
        # one prefetch worker lowers group N+1 (storage IO + plan, host
        # only) while group N executes; staging stays on the caller's
        # stream in the execute stage
        self.prefetch = prefetch
        self._prefetch_pool = None
        # predicate/negative cache: (split, term)-absence proofs prune
        # provably-empty splits before the reader is even constructed
        # (reference: leaf_cache.rs:197 + leaf.rs:758-841)
        self.predicate_cache = PredicateCache()
        # dynamic top-K pruning (reference CanSplitDoBetter, leaf.rs:1279).
        # The flag exists so equivalence tests can run an unpruned baseline.
        self.enable_threshold_pruning = enable_threshold_pruning
        # per-(split, field, term) df/max-tf for BM25 score upper bounds,
        # recorded at split open (search/pruning.py)
        self.score_bound_cache = ScoreBoundCache()
        # byte-exact HBM admission (reference SearchPermitProvider): the
        # lowered plan knows every array's size, so over-budget work queues
        # instead of materializing
        self.hbm_budget = HbmBudget()
        # device-resident column store: a warm split's packed columns stay
        # on the device across queries AND reader reopens (residency keys
        # on split id). The flag exists so equivalence tests can run the
        # per-reader staging baseline.
        self.resident_store = (
            ResidentColumnStore(fault_injector=fault_injector)
            if resident_columns else None)
        # cross-query dispatch coalescing: concurrent queries on one split
        # ride one dispatch (search/batcher.py; reference analogue:
        # per-node leaf request batching, leaf.rs:81)
        self.query_batcher = QueryBatcher()
        self._readers: OrderedDict[str, SplitReader] = OrderedDict()
        self._max_open_splits = max_open_splits
        self._lock = sync.lock("SearchService._lock")
        self._meshes: dict = {}
        # elastic leaf-search offload (reference: lambda leaf-search
        # offload, quickwit-lambda-client/src/invoker.rs:129 + the
        # scheduling split at leaf.rs:1658,1828): cold splits beyond
        # `max_local_splits` per leaf request fan out over an elastic
        # worker pool (offload/) — any processes serving the
        # internal leaf-search protocol (peer nodes, a FaaS worker
        # fleet, ...). The legacy single-endpoint knobs migrate into a
        # pool-of-one; `offload=None` with no endpoint keeps the subsystem
        # unimported and the leaf path byte-identical to the pre-pool
        # behavior.
        if offload is None and offload_endpoint:
            offload = {"endpoints": [offload_endpoint]}
        self.offload = offload
        self.offload_endpoint = offload_endpoint
        self.offload_max_local_splits = (
            int(offload.get("max_local_splits", offload_max_local_splits))
            if offload is not None else offload_max_local_splits)
        self._offload_client_factory = offload_client_factory
        self._offload_pool = None
        self._offload_dispatcher = None

    def offload_dispatcher(self):
        """The pool dispatcher, built lazily on first offloading leaf
        request; None when no pool is configured."""
        if self.offload is None:
            return None
        with self._lock:
            if self._offload_dispatcher is None:
                from ..offload import (
                    Autoscaler, OffloadDispatcher, WorkerPool,
                )
                config = self.offload
                pool = WorkerPool(
                    suspect_after=int(config.get("suspect_after", 1)),
                    eject_after=int(config.get("eject_after", 3)),
                    readmit_backoff_secs=float(
                        config.get("readmit_backoff_secs", 0.5)),
                    readmit_backoff_max_secs=float(
                        config.get("readmit_backoff_max_secs", 30.0)))
                for endpoint in config.get("endpoints", ()):
                    if self._offload_client_factory is not None:
                        client = self._offload_client_factory(endpoint)
                    else:
                        from ..serve.http_client import HttpSearchClient
                        client = HttpSearchClient(endpoint)
                    pool.add_worker(endpoint, client)
                autoscaler = None
                launcher = config.get("launcher")
                if launcher is not None:
                    autoscale = config.get("autoscale") or {}
                    autoscaler = Autoscaler(
                        pool, launcher,
                        min_workers=int(autoscale.get("min_workers", 1)),
                        max_workers=int(autoscale.get("max_workers", 8)),
                        queue_per_worker=int(
                            autoscale.get("queue_per_worker", 16)),
                        scale_down_cooldown_secs=float(autoscale.get(
                            "scale_down_cooldown_secs", 10.0)))
                self._offload_pool = pool
                self._offload_dispatcher = OffloadDispatcher(
                    pool,
                    task_splits=int(config.get("task_splits", 8)),
                    max_inflight_per_worker=int(
                        config.get("max_inflight_per_worker", 1)),
                    hedge_min_delay_secs=float(
                        config.get("hedge_min_delay_secs", 0.05)),
                    hedge_max_delay_secs=float(
                        config.get("hedge_max_delay_secs", 5.0)),
                    injector=config.get("fault_injector"),
                    autoscaler=autoscaler)
            return self._offload_dispatcher

    def offload_pool(self):
        """The live WorkerPool (builds the dispatcher if needed); None
        when offload is unconfigured."""
        if self.offload_dispatcher() is None:
            return None
        return self._offload_pool

    def device_mesh(self, n_splits: int):
        """A ("splits",) mesh sized to shard `n_splits` across
        `mesh_devices`, or None when the batch cannot shard — one device,
        one split, or no axis size >1 divides the batch (the JAX rule).

        The splits axis takes the largest size ≤ ndev that divides the
        batch, as the JAX service's does. Devices past it stay unused: the
        JAX service folds them into a docs axis, which the port's mesh
        does not have (parallel/mesh.py)."""
        ndev = len(self.mesh_devices)
        if ndev < 2 or n_splits < 2:
            return None
        axis = min(ndev, n_splits)
        while axis > 1 and n_splits % axis:
            axis -= 1
        if axis < 2:
            return None
        with self._lock:
            mesh = self._meshes.get(axis)
            if mesh is None:
                mesh = self._meshes[axis] = make_mesh(axis,
                                                      self.mesh_devices)
            return mesh

    def has_warm_reader(self, split: SplitIdAndFooter) -> bool:
        """True when this split's reader (and its byte-range/device
        caches) is already resident — the 'warm split' signal the offload
        scheduling uses (the reference offloads splits absent from the
        local split cache)."""
        with self._lock:
            return f"{split.storage_uri}/{split.split_id}" in self._readers

    def peek_reader(self, split: SplitIdAndFooter) -> Optional[SplitReader]:
        """Warm reader or None — NEVER opens a cold split. Threshold
        pruning consults footer metadata (field min/max, term max-tf)
        through this: paying a footer GET to maybe skip one program would
        often cost more than the program."""
        with self._lock:
            return self._readers.get(f"{split.storage_uri}/{split.split_id}")

    def prefetch_pool(self):
        from concurrent.futures import ThreadPoolExecutor
        with self._lock:
            if self._prefetch_pool is None:
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="leaf-prefetch")
            return self._prefetch_pool

    def reader(self, split: SplitIdAndFooter) -> SplitReader:
        """LRU-cached split readers: keeps footer, term dict and byte-range
        caches warm across queries."""
        key = f"{split.storage_uri}/{split.split_id}"
        with self._lock:
            reader = self._readers.get(key)
            if reader is not None:
                self._readers.move_to_end(key)
                return reader
        storage = self.storage_resolver.resolve(split.storage_uri)
        if self.split_cache is not None:
            local = self.split_cache.local_path(split.split_id)
            if local is not None:
                from ..common.uri import Uri
                from ..storage.local import LocalFileStorage
                storage = LocalFileStorage(
                    Uri.parse(f"file://{self.split_cache.root_path}"))
            else:
                self.split_cache.report_split(
                    split.split_id, split.storage_uri,
                    num_bytes_hint=split.file_len or 0)
        reader = SplitReader(storage, f"{split.split_id}.split",
                             file_len=split.file_len)
        with self._lock:
            self._readers[key] = reader
            while len(self._readers) > self._max_open_splits:
                self._readers.popitem(last=False)
        return reader


class SearchService:
    """One node's search endpoint. Leaf work runs where this service lives,
    on its context's device."""

    def __init__(self, context: Optional[SearcherContext] = None,
                 node_id: str = "node-0"):
        self.context = context or SearcherContext()
        self.node_id = node_id

    # ------------------------------------------------------------------
    def leaf_search(self, request: LeafSearchRequest) -> LeafSearchResponse:
        # A remote hop drops the root's ambient tenant — rebuild it from
        # the wire field so leaf-side admission enforces the same class.
        if request.tenant is not None and current_tenant() is None:
            with tenant_scope(TenantContext.from_wire(request.tenant)):
                return self._leaf_search_profiled(request)
        return self._leaf_search_profiled(request)

    def _leaf_search_profiled(self,
                              request: LeafSearchRequest) -> LeafSearchResponse:
        # A remote hop drops the root's ambient profile object — build a
        # leaf-local one when profiling was requested and ship it back on
        # the response; embedded leaves write into the root's profile
        # through the ambient binding and must NOT double-profile.
        if (current_profile() is None
                and request.search_request.profile):
            local_profile = QueryProfile()
            with TRACER.span("leaf_search",
                             {"num_splits": len(request.splits)}):
                with profile_scope(local_profile):
                    response = self._leaf_search_traced(request)
            local_profile.finish()
            response.profile = local_profile.to_dict()
            return response
        with TRACER.span("leaf_search",
                         {"num_splits": len(request.splits)}):
            return self._leaf_search_traced(request)

    def _leaf_search_traced(self,
                            request: LeafSearchRequest) -> LeafSearchResponse:
        # The wire deadline (remaining budget serialized by the root) wins;
        # in-process callers inherit the ambient scope; otherwise unbounded.
        if request.deadline_millis is not None:
            deadline = Deadline.from_millis(request.deadline_millis)
        else:
            deadline = current_deadline() or Deadline.never()
        if deadline.bounded:
            SEARCH_DEADLINE_REMAINING.observe(deadline.remaining())
        with deadline_scope(deadline):
            return self._leaf_search_deadlined(request, deadline)

    def _leaf_search_deadlined(self, request: LeafSearchRequest,
                               deadline: Deadline) -> LeafSearchResponse:
        doc_mapper = DocMapper.from_dict(request.doc_mapping)
        search_request = request.search_request
        splits = self._optimize_split_order(search_request, request.splits)

        collector = IncrementalCollector(
            max_hits=search_request.max_hits,
            start_offset=search_request.start_offset,
            string_sort=string_sort_of(search_request, doc_mapper))
        # dynamic top-K pruning (reference CanSplitDoBetter): resolve the
        # sort kind once; the ThresholdBox carries the collector's Kth
        # value to the prefetch thread (monotone, so stale reads are sound)
        prune_ctx = (pruning_context(search_request, doc_mapper)
                     if self.context.enable_threshold_pruning
                     else PruningContext(None, None))
        threshold = ThresholdBox(
            seed=(request.sort_value_threshold
                  if prune_ctx.mode is not None else None))
        prune_stats = {"pruned": 0, "downgraded": 0}
        required = required_terms(search_request.query_ast, doc_mapper)
        num_pruned_by_predicate = 0
        pending: list[SplitIdAndFooter] = []
        for split in splits:
            if self._count_from_metadata(search_request, split):
                # pure count over the whole split: the metastore's doc count
                # IS the answer — never open or transfer the split
                # (reference: CanSplitDoBetter count path, leaf.rs:1361)
                collector.add_leaf_response(LeafSearchResponse(
                    num_hits=split.num_docs, num_attempted_splits=1,
                    num_successful_splits=1))
                continue
            if required and self.context.predicate_cache.known_empty(
                    split.split_id, required):
                # negative cache: a required term is proven absent from this
                # split — zero hits and identity agg states, so skip the
                # reader open, staging and program entirely
                num_pruned_by_predicate += 1
                collector.add_leaf_response(LeafSearchResponse(
                    num_hits=0, num_attempted_splits=1,
                    num_successful_splits=1))
                continue
            key = canonical_request_key(split.split_id, search_request,
                                        split.time_range)
            cached = self.context.leaf_cache.get(key)
            if cached is not None:
                collector.add_leaf_response(cached)
                continue
            agg_served = self._serve_from_agg_cache(search_request, split)
            if agg_served is not None:
                # Tier B full short-circuit: a count/agg-only request whose
                # count AND every agg state are cached never opens the
                # reader — the dashboard-fanout case collapses to a merge
                collector.add_leaf_response(agg_served)
                continue
            pending.append(split)

        if (prune_ctx.mode is not None and threshold.get() is not None
                and not search_request.count_hits_exact):
            # wire-seeded threshold (root retry round 2): drop provably
            # beaten splits BEFORE the offload cut, so pruned splits never
            # count against the local budget or ship to a worker
            still_pending: list[SplitIdAndFooter] = []
            for split in pending:
                best = self._split_bound(prune_ctx, split)
                if best is not None and best < threshold.get():
                    prune_stats["pruned"] += 1
                    SEARCH_SPLITS_PRUNED_TOTAL.inc()
                    collector.add_leaf_response(LeafSearchResponse(
                        num_hits=0, num_attempted_splits=1,
                        num_successful_splits=1))
                else:
                    still_pending.append(split)
            pending = still_pending

        offload_future = None
        offload_result: dict[str, Any] = {}
        offloaded: list[SplitIdAndFooter] = []
        offload_dispatcher = self.context.offload_dispatcher()
        if (offload_dispatcher is not None
                and len(pending) > self.context.offload_max_local_splits):
            # scheduling split (reference schedule_search_tasks,
            # leaf.rs:1828): warm splits stay local; the coldest tail
            # beyond the local budget fans out over the worker pool
            # CONCURRENTLY with the local loop
            warm = [s for s in pending if self.context.has_warm_reader(s)]
            cold = [s for s in pending
                    if not self.context.has_warm_reader(s)]
            budget = max(self.context.offload_max_local_splits, len(warm))
            local = (warm + cold)[:budget]
            offloaded = (warm + cold)[budget:]
            if offloaded:
                pending = local
                offload_tenant = current_tenant()
                remote_request = LeafSearchRequest(
                    search_request=search_request,
                    index_uid=request.index_uid,
                    doc_mapping=request.doc_mapping, splits=offloaded,
                    deadline_millis=deadline.timeout_millis(),
                    # the offload workers enforce the same tenant class
                    tenant=(offload_tenant.to_wire()
                            if offload_tenant is not None else None),
                    # seeded at dispatch time inside _invoke (below): the
                    # threshold is monotone, so the LATEST value prunes
                    # strictly more on the workers than a capture-time copy
                    sort_value_threshold=None)
                result_box: dict[str, Any] = {}
                # the dispatch thread has an empty thread-local span stack:
                # capture the traceparent HERE so each worker RPC's
                # injected header joins this query's trace (same capture
                # as root _fan_out)
                offload_tp = TRACER.current_traceparent()

                def _invoke(box=result_box, rr=remote_request,
                            tp=offload_tp):
                    try:
                        # read the shared ThresholdBox from the dispatch
                        # thread, NOT at capture time: the local execute
                        # loop keeps raising it concurrently
                        if prune_ctx.mode is not None:
                            rr = dataclasses.replace(
                                rr, sort_value_threshold=threshold.get())
                        with TRACER.span(
                                "leaf_offload",
                                {"num_splits": len(rr.splits)},
                                remote_parent=tp):
                            box["outcome"] = offload_dispatcher.dispatch(
                                rr, deadline=deadline, traceparent=tp)
                    except (OverloadShed, TenantRateLimited) as exc:
                        # typed backpressure from a worker: this query is
                        # rejected as a WHOLE (HTTP 429), NOT retried
                        # locally — a local retry would defeat the remote
                        # tenant limits
                        box["backpressure"] = exc
                    # qwlint: disable-next-line=QW004 - only generic pool
                    # failure lands here (typed backpressure is re-raised
                    # above); the offloaded splits fall back to LOCAL
                    # execution below, so nothing is swallowed
                    except Exception as exc:  # noqa: BLE001 - fallback below
                        box["error"] = exc

                # run_with_context: the dispatch thread (and the worker
                # attempt threads it spawns) must see the query's
                # deadline, tenant and profile
                offload_future = sync.thread(
                    target=run_with_context(_invoke),
                    name="leaf-offload", daemon=True)
                offload_future.start()
                offload_result = result_box

        batch_size = self.context.batch_size
        groups = [pending[b: b + batch_size]
                  for b in range(0, len(pending), batch_size)]
        # pipelined loop: group i executes while group i+1's storage IO and
        # lowering run on the prefetch worker. The worker re-reads the
        # ThresholdBox, and the execute stage re-checks once more (the
        # threshold is monotone, so both reads are sound however stale).
        pipelined = self.context.prefetch and len(groups) > 1
        future = None
        if pipelined:
            # contextvars do not reach pool worker threads: one snapshot
            # carries deadline+tenant+profile
            future = self.context.prefetch_pool().submit(
                run_with_context(self._prepare_group),
                groups[0], doc_mapper, search_request, prune_ctx, threshold)
        for i, group in enumerate(groups):
            begin = i * batch_size
            if deadline.expired:
                # out of budget mid-request: every remaining split surfaces
                # as a typed, retryable failure — partial and on time
                SEARCH_SHED_TOTAL.inc(stage="leaf_groups")
                shed_profile = current_profile()
                if shed_profile is not None:
                    shed_profile.mark_partial("shed: leaf group loop")
                for split in pending[begin:]:
                    collector.failed_splits.append(SplitSearchError(
                        split_id=split.split_id,
                        error="deadline exceeded before split executed at leaf",
                        retryable=True))
                if future is not None:
                    self._discard_prepared(future.result())
                break
            prepared = (future.result() if future is not None
                        else self._prepare_group(group, doc_mapper,
                                                 search_request, prune_ctx,
                                                 threshold))
            future = None
            if pipelined and i + 1 < len(groups):
                future = self.context.prefetch_pool().submit(
                    run_with_context(self._prepare_group),
                    groups[i + 1], doc_mapper, search_request, prune_ctx,
                    threshold)
            self._execute_group(prepared, doc_mapper, search_request,
                                collector, prune_ctx, threshold, prune_stats)
            # publish the (possibly higher) Kth value for the next groups
            threshold.update(collector.sort_value_threshold())

        num_offloaded = 0
        if offload_future is not None:
            offload_future.join(
                timeout=deadline.clamp(self._OFFLOAD_TIMEOUT_SECS))
            backpressure = offload_result.get("backpressure")
            if backpressure is not None:
                # a worker said 429 for this tenant/node: surface the SAME
                # typed error so serve/rest.py renders a real 429 instead
                # of silently re-running the splits locally (which would
                # bypass the remote admission decision)
                raise backpressure
            outcome = offload_result.get("outcome")
            leftovers: list[SplitIdAndFooter] = []
            if outcome is not None:
                for remote in outcome.responses:
                    collector.add_leaf_response(remote)
                    if remote.profile is not None:
                        remote_profile = current_profile()
                        if remote_profile is not None:
                            remote_profile.add_child(remote.profile)
                leftovers = list(outcome.unserved)
                num_offloaded = len(offloaded) - len(leftovers)
                stats_profile = current_profile()
                if stats_profile is not None:
                    for stat_key, value in outcome.stats.items():
                        if value:
                            stats_profile.add(f"offload_{stat_key}", value)
            else:
                leftovers = list(offloaded)
            if leftovers:
                # pool failed / timed out / left splits unserved: the
                # splits still belong to this request — run them locally
                # (reference invoker falls back the same way)
                _warn_split_failure(
                    "offload", leftovers[0].split_id,
                    offload_result.get(
                        "error",
                        "unserved" if outcome is not None else "timeout"))
                for group in [leftovers[b: b + batch_size]
                              for b in range(0, len(leftovers), batch_size)]:
                    if deadline.expired:
                        SEARCH_SHED_TOTAL.inc(stage="offload_fallback")
                        shed_profile = current_profile()
                        if shed_profile is not None:
                            shed_profile.mark_partial(
                                "shed: offload fallback")
                        for split in group:
                            collector.failed_splits.append(SplitSearchError(
                                split_id=split.split_id,
                                error="deadline exceeded before offloaded "
                                      "split ran locally",
                                retryable=True))
                        continue
                    prepared = self._prepare_group(group, doc_mapper,
                                                   search_request, prune_ctx,
                                                   threshold)
                    self._execute_group(prepared, doc_mapper, search_request,
                                        collector, prune_ctx, threshold,
                                        prune_stats)
                    threshold.update(collector.sort_value_threshold())

        response = collector.to_leaf_response()
        response.num_attempted_splits = len(splits)
        # num_splits_skipped predates the threshold subsystem and stays as
        # an alias of the threshold-pruned count (dashboards key on it)
        response.resource_stats["num_splits_skipped"] = prune_stats["pruned"]
        response.resource_stats["num_splits_pruned_by_threshold"] = \
            prune_stats["pruned"]
        response.resource_stats["num_splits_downgraded_to_count"] = \
            prune_stats["downgraded"]
        response.resource_stats["num_splits_pruned_by_predicate_cache"] = \
            num_pruned_by_predicate
        if num_offloaded:
            response.resource_stats["num_splits_offloaded"] = num_offloaded
        profile = current_profile()
        if profile is not None:
            # pruning decisions land in the waterfall's counters; the
            # threshold that killed the pruned splits rides along
            for stat_key, value in response.resource_stats.items():
                profile.add(stat_key, value)
            final_threshold = threshold.get()
            if final_threshold is not None and (
                    prune_stats["pruned"] or prune_stats["downgraded"]):
                profile.set_counter("topk_prune_threshold",
                                    float(final_threshold))
        return response

    _OFFLOAD_TIMEOUT_SECS = 30.0

    @staticmethod
    def _count_from_metadata(request: SearchRequest,
                             split: SplitIdAndFooter) -> bool:
        """True when this split's contribution is exactly its doc count:
        match-all query, no hits wanted, no aggregations, and any request
        time filter fully covers the split's own time range (sound because
        the doc mapper requires the timestamp field on every doc, so the
        split range bounds all of them)."""
        if (request.max_hits != 0 or request.start_offset != 0
                or request.aggs or not isinstance(request.query_ast, MatchAll)):
            return False
        if request.start_timestamp is None and request.end_timestamp is None:
            return True
        if split.time_range is None:
            return False  # no bounds recorded: must evaluate
        lo, hi = split.time_range
        if request.start_timestamp is not None and request.start_timestamp > lo:
            return False
        # end_timestamp is exclusive; split ranges are inclusive
        if request.end_timestamp is not None and request.end_timestamp <= hi:
            return False
        return True

    def _split_bound(self, prune_ctx: PruningContext,
                     split: SplitIdAndFooter) -> Optional[float]:
        """Best internal sort key any doc of `split` can reach, or None
        (must run). Consults only metadata already in hand: split
        time_range, a WARM reader's footer field min/max, or the score
        bound cache (falling back to a warm reader's term stats)."""
        def field_meta():
            reader = self.context.peek_reader(split)
            return (reader.field_meta(prune_ctx.sort.field)
                    if reader is not None else None)

        def score_stats(field, term):
            stats = self.context.score_bound_cache.get(
                split.split_id, field, term)
            if stats is None:
                reader = self.context.peek_reader(split)
                if reader is None:
                    return None
                df, max_tf = reader.term_stats(field, term)
                cap = reader.term_score_cap(field, term)
                stats = (df, max_tf, cap)
                self.context.score_bound_cache.record(
                    split.split_id, field, term, df, max_tf, cap)
            return stats

        return split_best_internal_key(prune_ctx, split,
                                       field_meta_fn=field_meta,
                                       score_stats_fn=score_stats)

    def _classify_group(self, group, search_request, prune_ctx, threshold):
        """(run, skipped, to_count): splits whose bound cannot beat the
        current threshold are skipped (inexact counting) or downgraded to
        count-only requests (exact counting); ties always run."""
        thr = threshold.get() if prune_ctx.mode is not None else None
        if thr is None:
            return list(group), [], []
        run, skipped, to_count = [], [], []
        for split in group:
            best = self._split_bound(prune_ctx, split)
            if best is not None and best < thr:
                (to_count if search_request.count_hits_exact
                 else skipped).append(split)
            else:
                run.append(split)
        return run, skipped, to_count

    def _prepare_group(self, group, doc_mapper, search_request, prune_ctx,
                       threshold):
        """Stage 1 (prefetch-thread-safe, host only): threshold re-check,
        storage IO and plan lowering for one split group. Returns
        (prepared splits, extras) for `_execute_group`, where extras
        carries the threshold-pruned splits (skipped / count-ready /
        count-prepared)."""
        run_group, skipped, to_count = self._classify_group(
            group, search_request, prune_ctx, threshold)
        count_ready: list[tuple] = []
        count_prepared: list[tuple] = []
        count_request = None
        if to_count:
            # exact counting: the split still owes its hit count — re-issue
            # as a count-only request (max_hits=0) riding the metadata
            # count, the leaf cache, Tier B, or the k==0 no-top-k program
            count_request = downgrade_to_count(search_request)
            for split in to_count:
                if self._count_from_metadata(count_request, split):
                    count_ready.append((split, LeafSearchResponse(
                        num_hits=split.num_docs, num_attempted_splits=1,
                        num_successful_splits=1)))
                    continue
                key = canonical_request_key(split.split_id, count_request,
                                            split.time_range)
                cached = self.context.leaf_cache.get(key)
                if cached is not None:
                    count_ready.append((split, cached))
                    continue
                if self.context.agg_cache is not None:
                    # Tier B: the count entry shares the filter digest with
                    # the full request, so a downgraded split whose count
                    # was ever computed resolves without opening the reader
                    cached_count = self.context.agg_cache.get_count(
                        split.split_id,
                        canonical_filter_digest(count_request,
                                                split.time_range))
                    if cached_count is not None:
                        count_ready.append((split, LeafSearchResponse(
                            num_hits=cached_count, num_attempted_splits=1,
                            num_successful_splits=1)))
                        continue
                count_prepared.extend(self._prepare_per_split(
                    [split], doc_mapper, count_request, prune_ctx=None))
        extras = {"skipped": skipped, "count_ready": count_ready,
                  "count_prepared": count_prepared,
                  "count_request": count_request}
        push_thr = (threshold.get() if prune_ctx.mode is not None else None)
        # the batch route has no search_after pushdown or per-split terms
        # truncation; the per-split route handles those (2-key sorts ride
        # the batch through the lexicographic cross-split re-top-k)
        if (len(run_group) > 1 and not search_request.search_after
                and string_sort_of(search_request, doc_mapper) is None
                and not self._split_caches_route_per_split(search_request)
                and not any(key in json.dumps(search_request.aggs or {})
                            for key in ("split_size", "shard_size",
                                        "segment_size"))):
            # batch lanes go in split_id order: the cross-split merge
            # breaks sort-value ties by lane, and the collector's total
            # order is (key desc, split_id asc, doc asc)
            run_group = sorted(run_group, key=lambda s: s.split_id)
            try:
                readers = [self.context.reader(s) for s in run_group]
                if prune_ctx.mode == "score":
                    for reader, split in zip(readers, run_group):
                        record_split_term_stats(
                            self.context.score_bound_cache, split.split_id,
                            reader, prune_ctx.terms)
                # host only (storage IO and lowering): the batch stages in
                # the execute stage, on the caller's stream
                batch = build_batch(
                    search_request, doc_mapper, readers,
                    [s.split_id for s in run_group],
                    absence_sink=self.context.predicate_cache
                    .record_term_absent,
                    sort_value_threshold=push_thr)
                return ("batch", run_group, batch, extras)
            except (OverloadShed, TenantRateLimited):
                # whole-query backpressure, not a split failure: falling
                # back per split would just shed again
                raise
            except Exception as exc:  # noqa: BLE001 - fall back per split
                if is_device_fault(exc):
                    raise
                logger.debug("batch path failed (%s); searching per split",
                             exc)
        return ("per_split", run_group,
                self._prepare_per_split(run_group, doc_mapper, search_request,
                                        prune_ctx=prune_ctx,
                                        sort_value_threshold=push_thr),
                extras)

    def _discard_prepared(self, prepared) -> None:
        """A prefetched group dropped by the deadline returns its admission
        pins. The port's batch route pins nothing before its execute stage
        (it stages there), so this is a no-op unless a batch was staged."""
        kind, _group, data, _extras = prepared
        if kind == "batch":
            release_stack_pin(data, self.context.hbm_budget)

    def _prepare_per_split(self, group, doc_mapper, search_request,
                           prune_ctx=None, sort_value_threshold=None):
        prepared = []
        for split in group:
            try:
                reader = self.context.reader(split)
                cache = self.context.predicate_cache
                if prune_ctx is not None and prune_ctx.mode == "score":
                    # remember df/max-tf at split open so future queries
                    # can bound this split before (re)opening it
                    record_split_term_stats(
                        self.context.score_bound_cache, split.split_id,
                        reader, prune_ctx.terms)
                # plan-only (storage IO + lowering): the transfer is
                # deferred to the execute stage so each split's
                # admit→transfer→execute→release cycle runs alone — a whole
                # group admitted up front could exceed the budget and
                # starve itself
                cache_ctx = self._consult_split_caches(search_request,
                                                       split, reader)
                plan = prepare_plan_only(
                    search_request, doc_mapper, reader, split.split_id,
                    absence_sink=lambda f, t, s=split.split_id:
                        cache.record_term_absent(s, f, t),
                    sort_value_threshold=sort_value_threshold,
                    aggs_override=(cache_ctx or {}).get("aggs_override"),
                    mask_override=(cache_ctx or {}).get("mask"),
                    mask_key=(cache_ctx or {}).get("mask_key"))
                prepared.append((split, reader, plan, None, cache_ctx))
            except (OverloadShed, TenantRateLimited):
                # whole-query backpressure: demoting it to a per-split
                # failure here would turn a typed 429 into a generic 400
                raise
            except Exception as exc:  # noqa: BLE001 - partial failure
                prepared.append((split, None, None, exc, None))
        return prepared

    # --- hierarchical leaf caches (Tier A/B) ------------------------------

    def _serve_from_agg_cache(self, request, split):
        """Full Tier B short-circuit: a count/agg-only request (max_hits=0,
        no offset) whose count AND every agg state are cached builds its
        LeafSearchResponse from partials alone — no reader open, no
        staging, no program. Any missing piece returns None (the split runs
        normally and refills)."""
        agg_cache = self.context.agg_cache
        if (agg_cache is None or request.max_hits != 0
                or request.start_offset != 0):
            return None
        digest = canonical_filter_digest(request, split.time_range)
        count = agg_cache.get_count(split.split_id, digest)
        if count is None:
            return None
        states: dict[str, Any] = {}
        for name, spec in (request.aggs or {}).items():
            state = agg_cache.get_agg(split.split_id, digest,
                                      agg_shape_digest(spec))
            if state is None:
                return None
            states[name] = state
        return LeafSearchResponse(
            num_hits=count, num_attempted_splits=1, num_successful_splits=1,
            intermediate_aggs=states)

    def _split_caches_route_per_split(self, request) -> bool:
        """True when the Tier A/B caches could serve or warm this request.
        Consults and fills are per-split operations; the batch route merges
        its splits on the device, so a batched group can neither use a
        cached mask nor attribute partials back to one split. Such groups
        route per split instead, cheap since the resident column store
        keeps warm splits on the device either way. Scoring sorts stay
        batched (mask-ineligible: the default sort IS _score and the mask
        carries no BM25 scores) except agg-only requests, where Tier B
        applies regardless of sort. Both tiers off restores the batch
        routing."""
        sort_fields = [s.field for s in request.sort_fields] or ["_score"]
        if self.context.mask_cache is not None and "_score" not in sort_fields:
            return True
        return (self.context.agg_cache is not None and bool(request.aggs)
                and request.max_hits == 0 and request.start_offset == 0)

    def _consult_split_caches(self, request, split, reader):
        """Tier A/B lookups for one split, before lowering. Returns None
        (both tiers off) or a cache_ctx dict driving `prepare_plan_only`
        and the post-execute fill:

        - mask / mask_key: a cached packed predicate mask replaces the
          whole query root (zero predicate columns fetched or staged);
          mask_fill marks a miss to backfill. The key is always the
          digest's own, so two filters on one split never share a
          resident slot.
        - agg_hits: cached intermediate states attached post-execute;
          aggs_override: the missed subset actually lowered ({} lowers
          none); agg_fill: names to backfill from the response."""
        mask_cache = self.context.mask_cache
        agg_cache = self.context.agg_cache
        if mask_cache is None and agg_cache is None:
            return None
        digest = canonical_filter_digest(request, split.time_range)
        ctx: dict[str, Any] = {
            "digest": digest, "mask": None, "mask_key": None,
            "mask_fill": False, "agg_hits": {}, "aggs_override": None,
            "agg_fill": []}
        sort_fields = [s.field for s in request.sort_fields] or ["_score"]
        if mask_cache is not None and "_score" not in sort_fields:
            packed = mask_cache.get(split.split_id, digest,
                                    packed_mask_nbytes(reader.num_docs_padded))
            if packed is not None:
                ctx["mask"] = packed
                ctx["mask_key"] = f"mask.{digest}"
            else:
                ctx["mask_fill"] = True
        if agg_cache is not None and request.aggs:
            missing: dict[str, Any] = {}
            for name, spec in request.aggs.items():
                state = agg_cache.get_agg(split.split_id, digest,
                                          agg_shape_digest(spec))
                if state is not None:
                    ctx["agg_hits"][name] = state
                else:
                    missing[name] = spec
            if ctx["agg_hits"]:
                ctx["aggs_override"] = missing
            ctx["agg_fill"] = list(missing)
        return ctx

    def _fill_split_caches(self, request, split, plan, device_arrays,
                           response, cache_ctx, owner=None) -> None:
        """Post-execute backfill, while the split's device arrays are still
        pinned. Fills are best-effort: a failure (including injected cache
        faults) degrades to an uncached split, never fails the query. The
        tiers store host values only (numpy bytes, pickled responses and
        states), never a tensor."""
        if cache_ctx is None:
            return
        digest = cache_ctx["digest"]
        mask_cache = self.context.mask_cache
        if (mask_cache is not None and cache_ctx.get("mask_fill")
                and plan.count_override is None):
            # count_override marks an impact-prefix-truncated plan (format
            # v3): the program never saw the posting tail, so its mask is
            # incomplete — skip the fill, never cache a partial mask
            try:
                host_packed, dev_packed = compute_packed_mask(
                    plan, device_arrays, self.context.device)
                mask_cache.put(split.split_id, digest, host_packed)
                store = self.context.resident_store
                if store is not None and owner is not None and \
                        owner is store.peek(split.split_id):
                    # seed the device copy under the SAME key a mask-hit
                    # plan will stage (`mask.<digest>`, uint8
                    # [packed_mask_nbytes], what warmup would stage for
                    # that slot): the next warm run copies nothing.
                    # Accounted in the store's bytes (columns=0: the mask
                    # is not a column miss); the padded/8 bytes ride
                    # outside HbmBudget admission by design, as in the JAX
                    # package
                    owner._device_array_cache[f"mask.{digest}"] = dev_packed
                    store.note_upload(
                        split.split_id,
                        dev_packed.numel() * dev_packed.element_size(), 0)
            except (OverloadShed, TenantRateLimited):
                raise
            except Exception as exc:  # noqa: BLE001 - fill is best-effort
                logger.debug("mask-cache fill failed for %s: %s",
                             split.split_id, exc)
        agg_cache = self.context.agg_cache
        if agg_cache is None:
            return
        try:
            # sound under threshold pushdown and search_after: the program
            # computes count/aggs from the FULL filter mask; only the hit
            # list is eligibility-restricted
            agg_cache.put_count(split.split_id, digest, response.num_hits)
            for name in cache_ctx.get("agg_fill", ()):
                state = response.intermediate_aggs.get(name)
                spec = (request.aggs or {}).get(name)
                if state is not None and spec is not None:
                    agg_cache.put_agg(split.split_id, digest,
                                      agg_shape_digest(spec), state)
        except (OverloadShed, TenantRateLimited):
            raise
        except Exception as exc:  # noqa: BLE001 - fill is best-effort
            logger.debug("agg-cache fill failed for %s: %s",
                         split.split_id, exc)

    def _execute_group(self, prepared, doc_mapper, search_request,
                       collector, prune_ctx, threshold, prune_stats) -> None:
        """Stage 2 (caller's thread and stream): staging, program,
        readback and merge."""
        kind, group, data, extras = prepared
        for split in extras["skipped"]:
            # conclusively handled without execution: zero hits here can
            # reach the top-K (num_hits is a lower bound when
            # count_hits_exact=False)
            prune_stats["pruned"] += 1
            SEARCH_SPLITS_PRUNED_TOTAL.inc()
            collector.add_leaf_response(LeafSearchResponse(
                num_hits=0, num_attempted_splits=1, num_successful_splits=1))
        for _split, response in extras["count_ready"]:
            prune_stats["downgraded"] += 1
            SEARCH_SPLITS_DOWNGRADED_TOTAL.inc()
            collector.add_leaf_response(response)
        if extras["count_prepared"]:
            prune_stats["downgraded"] += len(extras["count_prepared"])
            SEARCH_SPLITS_DOWNGRADED_TOTAL.inc(
                len(extras["count_prepared"]))
            self._execute_per_split(
                extras["count_prepared"], doc_mapper,
                extras["count_request"], collector,
                prune_ctx=None, threshold=None, prune_stats=None)
        if kind == "batch":
            if self._execute_batch(data, search_request, collector):
                return
            # the batch could not run for a reason the JAX service also
            # falls back on: search the group split by split
            data = self._prepare_per_split(
                group, doc_mapper, search_request, prune_ctx=prune_ctx,
                sort_value_threshold=(threshold.get()
                                      if prune_ctx.mode is not None
                                      else None))
        self._execute_per_split(data, doc_mapper, search_request, collector,
                                prune_ctx=prune_ctx, threshold=threshold,
                                prune_stats=prune_stats)

    def _execute_batch(self, batch, search_request, collector) -> bool:
        """The batch route's execute stage: stage each split (pinned in the
        budget), one dispatch, then the one readback merged into the
        collector. Returns False when the group must run per split instead.
        A device or kernel fault is raised, never answered per split. The
        route fills no leaf-cache entry and no tier entry: its response
        covers several splits."""
        context = self.context
        try:
            # staging runs here, on the caller's current stream, the
            # stream the dispatch runs on. The mesh is fixed at staging
            # time: lanes staged for one grid must not feed another.
            # Each lane is admitted into the context's one budget under
            # its split's resident owner on its row's device (the lanes
            # ARE the splits' resident arrays; no per-request owner pins
            # a copy of them)
            mesh = context.device_mesh(batch.n_splits)
            stage_device_inputs(batch, context.device,
                                budget=context.hbm_budget,
                                store=context.resident_store, mesh=mesh)
            # dispatch and readback are split so the deadline can shed
            # BETWEEN them: the programs may run to completion on the
            # device, but a query nobody waits for never pays the wait
            dispatched = dispatch_batch(batch, search_request,
                                        context.device, mesh)
            deadline = current_deadline()
            if deadline is not None and deadline.expired:
                abandon_dispatch(dispatched)
                RESIDENT_READBACKS_SHED.inc()
                profile = current_profile()
                if profile is not None:
                    profile.mark_partial("shed: batch readback")
                for split_id in batch.split_ids:
                    if split_id:
                        collector.failed_splits.append(SplitSearchError(
                            split_id=split_id,
                            error="deadline exceeded before readback was "
                                  "awaited",
                            retryable=True))
                return True
            collector.add_leaf_response(readback_batch(dispatched))
            return True
        except (OverloadShed, TenantRateLimited):
            raise
        except Exception as exc:  # noqa: BLE001 - fall back per split
            if is_device_fault(exc):
                raise
            logger.debug("batch execute failed (%s); per split", exc)
            return False
        finally:
            # the pins move to resident; the staged tensors die with the
            # batch, after the stream's work
            release_stack_pin(batch, context.hbm_budget)

    def _execute_per_split(self, data, doc_mapper, search_request, collector,
                           prune_ctx=None, threshold=None,
                           prune_stats=None) -> None:
        deadline = current_deadline()
        cancel = current_cancel_token()
        profile = current_profile()
        context = self.context
        for split, reader, plan, prep_error, cache_ctx in data:
            if cancel is not None and cancel.cancelled:
                # cancelled between splits: unexecuted splits are reported
                # as non-retryable cancel failures
                collector.failed_splits.append(SplitSearchError(
                    split_id=split.split_id,
                    error=f"query cancelled before split executed"
                          f"{': ' + cancel.reason if cancel.reason else ''}",
                    retryable=False))
                continue
            if deadline is not None and deadline.expired:
                if profile is not None:
                    profile.mark_partial("shed: split execute")
                collector.failed_splits.append(SplitSearchError(
                    split_id=split.split_id,
                    error="deadline exceeded before split executed at leaf",
                    retryable=True))
                continue
            if prep_error is not None:
                _warn_split_failure("prepare", split.split_id, prep_error)
                collector.failed_splits.append(SplitSearchError(
                    split_id=split.split_id, error=str(prep_error),
                    retryable=True))
                continue
            if (prune_ctx is not None and prune_ctx.mode is not None
                    and threshold is not None
                    and not search_request.count_hits_exact):
                # execute-time re-check: the threshold may have risen past
                # this split's bound since the prefetch thread prepared it
                thr = threshold.get()
                if thr is not None:
                    best = self._split_bound(prune_ctx, split)
                    if best is not None and best < thr:
                        if prune_stats is not None:
                            prune_stats["pruned"] += 1
                        SEARCH_SPLITS_PRUNED_TOTAL.inc()
                        collector.add_leaf_response(LeafSearchResponse(
                            num_hits=0, num_attempted_splits=1,
                            num_successful_splits=1))
                        continue
            admitted = 0
            owner = None
            device_arrays = None
            try:
                # staging runs here, on the caller's current stream, the
                # stream the program runs on: no cross-stream sync needed
                device_arrays, admitted, owner = warmup_device_arrays(
                    reader, plan, context.hbm_budget,
                    store=context.resident_store, split_id=split.split_id,
                    device=context.device)
                response = execute_prepared_split(
                    search_request, doc_mapper, reader, split.split_id,
                    plan, device_arrays, context.device,
                    threshold_box=threshold,
                    fault_injector=context.fault_injector,
                    batcher=context.query_batcher)
                if cache_ctx is not None and cache_ctx["agg_hits"]:
                    # Tier B hits join the response BEFORE the leaf-cache
                    # put and the merge — the cached LeafSearchResponse
                    # must be complete, and the collector merges by name
                    response.intermediate_aggs.update(cache_ctx["agg_hits"])
                # a chunked scan cancelled mid-split answers with the chunks
                # it merged (and a cancel failure): no tier may keep that
                if not response.failed_splits:
                    self._fill_split_caches(search_request, split, plan,
                                            device_arrays, response,
                                            cache_ctx, owner=owner)
                    if plan.threshold_slot < 0:
                        # a threshold-pushdown response may have its hit
                        # list truncated below k — correct for THIS query's
                        # merge, poison for a future query with a lower
                        # threshold
                        key = canonical_request_key(
                            split.split_id, search_request, split.time_range)
                        context.leaf_cache.put(key, response)
                collector.add_leaf_response(response)
                if threshold is not None:
                    threshold.update(collector.sort_value_threshold())
            except (OverloadShed, TenantRateLimited):
                # a shed/rate-limited tenant is rejected as a WHOLE query
                raise
            except CancelledQuery as exc:
                # NEVER retryable: the caller asked for the query to stop
                collector.failed_splits.append(SplitSearchError(
                    split_id=split.split_id, error=str(exc), retryable=False))
            except Exception as exc:  # noqa: BLE001 - partial failure semantics
                _warn_split_failure("search", split.split_id, exc)
                collector.failed_splits.append(SplitSearchError(
                    split_id=split.split_id, error=str(exc), retryable=True))
            finally:
                # the readback inside execute_prepared_split synchronized
                # the stream, so the program has finished reading these:
                # drop this query's references, so that an eviction frees
                # the memory at once, then move the pins to resident (a
                # failed warmup released its own pins and returned no owner)
                device_arrays = None
                if owner is not None:
                    context.hbm_budget.release(owner, admitted)

    @staticmethod
    def _optimize_split_order(request: SearchRequest,
                              splits: list[SplitIdAndFooter]) -> list[SplitIdAndFooter]:
        """Reference `CanSplitDoBetter::optimize_split_order` (leaf.rs:1279):
        timestamp sorts visit the splits most likely to own the top hits
        first (enables pruning + better partial results under timeouts)."""
        sort = request.sort_fields[0] if request.sort_fields else None
        if sort is None or not splits:
            return list(splits)
        if sort.field == "_score":
            return sorted(splits, key=lambda s: -s.num_docs)

        def end_key(s: SplitIdAndFooter):
            return s.time_range[1] if s.time_range else 0

        def start_key(s: SplitIdAndFooter):
            return s.time_range[0] if s.time_range else 0

        if sort.order == "desc":
            return sorted(splits, key=end_key, reverse=True)
        return sorted(splits, key=start_key)

    # ------------------------------------------------------------------
    def fetch_docs(self, request: FetchDocsRequest) -> list[dict[str, Any]]:
        """The hits' documents from the split's doc store (host work: zlib
        blocks read through the reader's byte-range cache), with snippets
        when the request names snippet fields."""
        reader = self.context.reader(request.split)
        docs = reader.fetch_docs(request.doc_ids)
        if request.snippet_fields and request.query_ast is not None:
            for doc in docs:
                doc["_snippets"] = generate_snippets(
                    doc, request.snippet_fields, request.query_ast)
        return docs


class LocalSearchClient:
    """In-process transport to a SearchService (the tests' and single-node
    deployments' client; an HTTP client would have the same surface)."""

    def __init__(self, service: SearchService):
        self.service = service

    def leaf_search(self, request: LeafSearchRequest) -> LeafSearchResponse:
        return self.service.leaf_search(request)

    def fetch_docs(self, request: FetchDocsRequest) -> list[dict[str, Any]]:
        return self.service.fetch_docs(request)
