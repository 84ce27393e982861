"""Root search: plan, fan out, merge, fetch — the two-phase distributed query.

Role of the reference's `root_search` (`quickwit-search/src/root.rs:1295`)
and `ClusterClient` (`cluster_client.rs:46,85`):

1. resolve index patterns + doc mappings via the metastore,
2. list splits with time-range and tag pruning pushed into the metastore
   query (`refine_*`, `root.rs:1599`, `tag_pruning.rs`),
3. place per-split jobs on searcher nodes (rendezvous + cost balancing),
4. per node: one LeafSearchRequest per index, with retry of failed leaf
   requests on the next-best node,
5. merge leaf responses (IncrementalCollector),
6. phase 2: fetch docs for the global top hits from the nodes that
   searched them (cache affinity),
7. finalize aggregations into ES-shaped results.

Counterpart of the JAX package's `search/root.py`. The root is host code
and owns no device: each client's node searches on its own context's
device (`SearcherContext(device=...)`), so the leaves' kernels run where
their nodes live and a leaf retried on another node runs on that node's
device. The merge stays on the host (IncrementalCollector), as in the JAX
root.
"""

from __future__ import annotations

import fnmatch
import logging
import time
from typing import Any, Callable, Optional, Protocol

from ..common.deadline import (
    CancellationToken, CancelledQuery, Deadline, DeadlineExceeded, QueryBudget,
    cancel_scope, deadline_scope, is_cancel_error, is_deadline_error,
)
from ..common.clock import monotonic as clock_monotonic
from ..common.ctx import run_with_context
from ..metastore.base import ListSplitsQuery, Metastore, MetastoreError
from ..models.doc_mapper import DocMapper
from ..models.split_metadata import Split, SplitState
from ..observability.metrics import (
    SEARCH_FETCH_DOCS_RETRIES_TOTAL, SEARCH_LEAF_RETRIES_TOTAL,
    SEARCH_PROFILED_QUERIES_TOTAL, SEARCH_TIMED_OUT_TOTAL,
)
from ..observability.profile import (
    PHASE_FETCH_DOCS, PHASE_ROOT_MERGE, QueryProfile, current_profile,
    profile_scope, profiled_phase,
)
from ..observability import flight
from ..observability.slo import SLO_TRACKER
from ..observability.slowlog import SLOW_QUERY_LOG
from ..query import ast as Q
from ..tenancy.context import current_tenant, tenant_scope
from ..tenancy.overload import OverloadShed
from ..tenancy.registry import GLOBAL_TENANCY, TenantRateLimited
from .cancel import CANCEL_REGISTRY
from .collector import IncrementalCollector, finalize_aggregations
from .models import (
    FetchDocsRequest, Hit, LeafSearchRequest, LeafSearchResponse, SearchRequest,
    SearchResponse, SplitIdAndFooter, SplitSearchError, string_sort_of,
)
from .placer import SearchJob, nodes_for_split, place_jobs
from ..common import sync

logger = logging.getLogger(__name__)


def _all_splits_failed(leaf_request: LeafSearchRequest, error: str,
                       retryable: bool = True) -> LeafSearchResponse:
    """A leaf response reporting every split of the request as failed —
    never an empty `failed_splits` for work that was not done."""
    return LeafSearchResponse(
        failed_splits=[SplitSearchError(split_id=s.split_id, error=error,
                                        retryable=retryable)
                       for s in leaf_request.splits],
        num_attempted_splits=len(leaf_request.splits))


class SearchClient(Protocol):
    def leaf_search(self, request: LeafSearchRequest) -> LeafSearchResponse: ...
    def fetch_docs(self, request: FetchDocsRequest) -> list[dict[str, Any]]: ...


def extract_required_tags(ast: Q.QueryAst, tag_fields: tuple[str, ...]) -> set[str]:
    """Conservative tag extraction: only terms in purely conjunctive
    positions may prune (reference `tag_pruning.rs`)."""
    tags: set[str] = set()
    if isinstance(ast, Q.Term) and ast.field in tag_fields:
        tags.add(f"{ast.field}:{ast.value}")
    elif isinstance(ast, Q.Bool) and not ast.should:
        for child in ast.must + ast.filter:
            tags |= extract_required_tags(child, tag_fields)
    elif isinstance(ast, Q.Boost):
        tags |= extract_required_tags(ast.underlying, tag_fields)
    return tags


def extract_numeric_constraints(ast: Q.QueryAst,
                                doc_mapper) -> dict[str, tuple]:
    """Required numeric constraints per field, for zonemap pruning
    (reference: `quickwit-parquet-engine/src/zonemap/` min/max pruning —
    here at split granularity; doc granularity is the device masks).
    Like tag pruning, only purely conjunctive positions count; only
    fields EXPLICITLY mapped numeric (i64/u64/f64) participate —
    datetime bounds are unit-ambiguous before input-format parsing
    (seconds vs micros) and dynamic columns have uncertain coercion, so
    either could prune wrongly. Returns field -> (lo, lo_incl, hi,
    hi_incl) with None = unbounded; multiple constraints on one field
    intersect."""
    from ..models.doc_mapper import FieldType
    out: dict[str, tuple] = {}

    def numeric_field(field: str) -> bool:
        fm = doc_mapper.field(field)
        return fm is not None and fm.type in (
            FieldType.I64, FieldType.U64, FieldType.F64)

    def tighten(field: str, lo, lo_incl, hi, hi_incl) -> None:
        cur = out.get(field, (None, True, None, True))
        clo, clo_incl, chi, chi_incl = cur
        if lo is not None and (clo is None or lo > clo
                               or (lo == clo and not lo_incl)):
            clo, clo_incl = lo, lo_incl
        if hi is not None and (chi is None or hi < chi
                               or (hi == chi and not hi_incl)):
            chi, chi_incl = hi, hi_incl
        out[field] = (clo, clo_incl, chi, chi_incl)

    def numeric(value, field: str):
        """THE leaf's bound coercion (shared helper — a drift between
        leaf matching and root pruning would silently lose hits)."""
        if isinstance(value, bool) or value is None:
            return None
        from .plan import coerce_numeric_bound
        try:
            return coerce_numeric_bound(doc_mapper.field(field).type, value)
        except (ValueError, TypeError):
            return None

    def walk(node) -> None:
        if isinstance(node, Q.Range) and numeric_field(node.field):
            lo = (numeric(node.lower.value, node.field)
                  if node.lower is not None else None)
            hi = (numeric(node.upper.value, node.field)
                  if node.upper is not None else None)
            if (node.lower is not None and lo is None) \
                    or (node.upper is not None and hi is None):
                return  # unparseable bound: skip
            tighten(node.field, lo,
                    node.lower.inclusive if node.lower else True,
                    hi, node.upper.inclusive if node.upper else True)
        elif isinstance(node, Q.Term) and numeric_field(node.field):
            value = numeric(node.value, node.field)
            if value is not None:
                tighten(node.field, value, True, value, True)
        elif isinstance(node, Q.Bool) and not node.should:
            for child in node.must + node.filter:
                walk(child)
        elif isinstance(node, Q.Boost):
            walk(node.underlying)

    walk(ast)
    return out


def split_excluded_by_bounds(column_bounds: dict,
                             constraints: dict[str, tuple]) -> bool:
    """True when some required constraint cannot match any value within
    the split's recorded [min, max] for that column. Fields without
    recorded bounds (text columns, pre-zonemap splits) never prune."""
    for field, (lo, lo_incl, hi, hi_incl) in constraints.items():
        bounds = column_bounds.get(field)
        if bounds is None:
            continue
        bmin, bmax = bounds
        try:
            if lo is not None and (bmax < lo
                                   or (bmax == lo and not lo_incl)):
                return True
            if hi is not None and (bmin > hi
                                   or (bmin == hi and not hi_incl)):
                return True
        except TypeError:
            continue  # incomparable types: never prune
    return False


class RootSearcher:
    # Queries that arrive without an explicit budget still get one: the root
    # must never hang on a stuck leaf regardless of what the caller sent.
    DEFAULT_TIMEOUT_SECS = 30.0
    # Per-query retry pool shared across the whole fan-out (reference: the
    # retry policy retries each failed leaf request once; the pool caps the
    # aggregate so a wide outage cannot amplify into a retry storm).
    MAX_RETRIES_PER_QUERY = 8

    def __init__(
        self,
        metastore: Metastore,
        clients: dict[str, SearchClient],     # node_id -> client (live pool)
        nodes_provider: Optional[Callable[[], list[str]]] = None,
        default_timeout_secs: Optional[float] = None,
    ):
        self.metastore = metastore
        self.clients = clients
        self.nodes_provider = nodes_provider or (lambda: sorted(self.clients))
        self.default_timeout_secs = (
            self.DEFAULT_TIMEOUT_SECS if default_timeout_secs is None
            else default_timeout_secs)

    # ------------------------------------------------------------------
    def search(self, request: SearchRequest) -> SearchResponse:
        from ..observability.tracing import TRACER
        # per-tenant QPS bucket at ROOT admission: a tenant over its limit
        # is bounced before any metastore work, with a Retry-After the REST
        # layer turns into a 429. No bound tenant -> no check (neutral).
        tenant = current_tenant()
        if tenant is not None:
            GLOBAL_TENANCY.check_query_rate(tenant)
        if request.timeout_millis is not None:
            deadline = Deadline.from_millis(request.timeout_millis)
        else:
            deadline = Deadline.after(self.default_timeout_secs)
        budget = QueryBudget(deadline, max_retries=self.MAX_RETRIES_PER_QUERY)
        # profile on explicit request, or for EVERY query when the slow-query
        # log is armed — a slow query can only be captured if it was profiled
        # from admission, not discovered after the fact
        profile = None
        if request.profile or SLOW_QUERY_LOG.armed:
            import uuid
            profile = QueryProfile(query_id=uuid.uuid4().hex[:16])
            SEARCH_PROFILED_QUERIES_TOTAL.inc()
        # Cancellation seam: ambient token for the whole query. With a
        # query_id it is also registered for REST DELETE; without one it
        # still flows to the leaves so embedded callers can cancel
        # programmatically via the scope.
        cancel_token = CancellationToken()
        if request.query_id is not None:
            # A DELETE can race ahead of the query it targets (a client
            # cancelling a retry under its stable handle): adopt an
            # already-cancelled token registered under this id instead of
            # replacing it, so the early cancel still lands. Live tokens
            # are NOT adopted — last-writer-wins for genuine retries.
            raced = CANCEL_REGISTRY.get(request.query_id)
            if raced is not None and raced.cancelled:
                cancel_token = raced
            CANCEL_REGISTRY.register(request.query_id, cancel_token)
        t0 = time.monotonic()
        # flight-recorder bracket: timed on the clock seam so the recorded
        # elapsed is virtual (deterministic) under DST and wall in prod
        flight_t0 = clock_monotonic()
        qid = profile.query_id if profile is not None \
            else (request.query_id or "")
        if flight.recording():
            flight.emit("query.start", query_id=qid,
                        attrs={"indexes": ",".join(request.index_ids)})
        try:
            with TRACER.span("root_search",
                             {"indexes": ",".join(request.index_ids)}):
                with deadline_scope(deadline), cancel_scope(cancel_token), \
                        profile_scope(profile):
                    try:
                        response = self._search_traced(request, budget)
                    except CancelledQuery as exc:
                        # typed partial: the cancel landed before any merged
                        # result existed — report it as cancelled, not error
                        response = SearchResponse(
                            elapsed_time_micros=int(
                                (time.monotonic() - t0) * 1e6),
                            errors=[str(exc)],
                            cancelled=True,
                        )
        except BaseException as exc:
            if isinstance(exc, OverloadShed):
                status = "shed"
            elif isinstance(exc, TenantRateLimited):
                status = "rejected"
            elif is_deadline_error(str(exc)):
                status = "timed_out"
            elif is_cancel_error(str(exc)):
                status = "cancelled"
            else:
                status = "error"
            if tenant is not None:
                GLOBAL_TENANCY.note_query(tenant.tenant_id, status=status)
            self._account_query_done(tenant, qid, status,
                                     (clock_monotonic() - flight_t0) * 1000.0)
            if profile is not None:
                profile.mark_partial(f"error: {exc}")
                profile.finish(time.monotonic() - t0)
                self._capture_slow_query(request, profile,
                                         timed_out=is_deadline_error(str(exc)))
            raise
        finally:
            if request.query_id is not None:
                CANCEL_REGISTRY.unregister(request.query_id, cancel_token)
        if response.timed_out:
            SEARCH_TIMED_OUT_TOTAL.inc()
        status = ("cancelled" if response.cancelled
                  else "timed_out" if response.timed_out else "ok")
        if tenant is not None:
            GLOBAL_TENANCY.note_query(tenant.tenant_id, status=status)
        self._account_query_done(tenant, qid, status,
                                 (clock_monotonic() - flight_t0) * 1000.0)
        if profile is not None:
            if response.timed_out:
                profile.mark_partial("timed_out")
            profile.finish(response.elapsed_time_micros / 1e6)
            if tenant is not None:
                # execute-time attribution: device execute milliseconds from
                # the profile waterfall (embedded + remote leaves) charged
                # to the tenant's meter
                from ..observability.profile import PHASE_EXECUTE
                GLOBAL_TENANCY.note_execute_seconds(
                    tenant.tenant_id,
                    profile.phase_ms_recursive(PHASE_EXECUTE) / 1000.0)
            if request.profile:
                response.profile = profile.to_dict()
            self._capture_slow_query(request, profile,
                                     timed_out=response.timed_out)
        return response

    @staticmethod
    def _account_query_done(tenant, qid: str, status: str,
                            elapsed_ms: float) -> None:
        """Completion bookkeeping shared by the success and error exits:
        the `query.done` flight event and the per-class SLO judgement.
        Cancelled queries are excluded from SLO burn — the client chose to
        abandon them, the objective was not missed by the system."""
        if flight.recording():
            flight.emit("query.done", query_id=qid,
                        attrs={"status": status,
                               "elapsed_ms": round(elapsed_ms, 3)})
        if status == "cancelled":
            return
        if tenant is not None:
            cls = tenant.priority_class
            label = GLOBAL_TENANCY.metric_label(tenant.tenant_id)
        else:
            cls = GLOBAL_TENANCY.default_class
            label = "default"
        SLO_TRACKER.note(cls, label, elapsed_ms, ok=status == "ok")

    @staticmethod
    def _capture_slow_query(request: SearchRequest, profile,
                            timed_out: bool) -> None:
        elapsed_ms = profile.wall_ms or 0.0
        if not SLOW_QUERY_LOG.should_capture(elapsed_ms, timed_out):
            return
        tenant = current_tenant()
        counters = profile.counters()
        # PR-18 query-group context: a slow stacked query names its group
        # so the outlier is attributable to formation/lane position
        group = None
        if "qbatch_group_size" in counters:
            group = {"group_size": int(counters["qbatch_group_size"]),
                     "lane_index": int(counters.get("qbatch_lane_index", 0)),
                     "masked": bool(counters.get("qbatch_masked", 0.0))}
        SLOW_QUERY_LOG.record({
            "query_id": profile.query_id,
            "indexes": list(request.index_ids),
            "elapsed_ms": elapsed_ms,
            "timed_out": timed_out,
            # which tenant's query this was: a noisy-neighbor hunt starts
            # by grouping the slowlog on this field
            **({"tenant": tenant.tenant_id} if tenant is not None else {}),
            **({"query_group": group} if group is not None else {}),
            "profile": profile.to_dict(),
        })

    def _search_traced(self, request: SearchRequest,
                       budget: QueryBudget) -> SearchResponse:
        t0 = time.monotonic()
        indexes = self._resolve_indexes(request.index_ids)
        if not indexes:
            raise ValueError(f"no index matches {request.index_ids!r}")
        if request.aggs:
            # validate the agg request up front: an EMPTY index must
            # reject a malformed aggregation exactly like a populated
            # one (zero splits would otherwise skip the leaf parse)
            from ..query.aggregations import parse_aggs
            parse_aggs(request.aggs)

        # the merge key type must be consistent across every matched index:
        # a sort field that is text in one index and numeric in another has
        # no global order (the reference rejects this the same way)
        sort_modes = {string_sort_of(request, im.index_config.doc_mapper)
                      for im in indexes}
        if len(sort_modes) > 1:
            field = request.sort_fields[0].field
            raise ValueError(
                f"sort field {field!r} is a text fast field in some matched "
                f"indexes but not others; cross-index sort needs one type")
        string_sort = next(iter(sort_modes))
        collector = IncrementalCollector(
            max_hits=request.max_hits, start_offset=request.start_offset,
            search_after=(None if string_sort is not None
                          else self._search_after_key(request)),
            string_sort=string_sort,
            string_search_after=(self._string_search_after(request)
                                 if string_sort is not None else None))
        split_meta_by_id: dict[str, tuple[str, SplitIdAndFooter, dict]] = {}
        nodes = self.nodes_provider()
        dispatches: list[tuple[str, LeafSearchRequest]] = []

        for index_metadata in indexes:
            doc_mapper = index_metadata.index_config.doc_mapper
            splits = self._prune_splits(index_metadata, doc_mapper, request)
            if not splits:
                continue
            offsets = {}
            for split in splits:
                offset = SplitIdAndFooter(
                    split_id=split.metadata.split_id,
                    storage_uri=index_metadata.index_config.index_uri,
                    num_docs=split.metadata.num_docs,
                    time_range=(split.metadata.time_range_start,
                                split.metadata.time_range_end)
                    if split.metadata.time_range_start is not None else None,
                )
                offsets[split.metadata.split_id] = offset
                split_meta_by_id[split.metadata.split_id] = (
                    index_metadata.index_uid, offset, doc_mapper.to_dict())
            jobs = [SearchJob(s.metadata.split_id, cost=max(s.metadata.num_docs, 1))
                    for s in splits]
            assignment = place_jobs(jobs, nodes)
            for node_id, node_jobs in assignment.items():
                leaf_request = LeafSearchRequest(
                    search_request=request,
                    index_uid=index_metadata.index_uid,
                    doc_mapping=doc_mapper.to_dict(),
                    splits=[offsets[j.split_id] for j in node_jobs],
                )
                dispatches.append((node_id, leaf_request))

        responses = self._fan_out(dispatches, nodes, budget)
        # root merge covers only the post-join collector work: the fan-out
        # wall is already accounted inside each leaf's own phases, and an
        # umbrella phase here would double-count it against sum≈wall
        profile = current_profile()
        with profiled_phase(PHASE_ROOT_MERGE) as rec:
            if rec is not None:
                rec["leaf_responses"] = len(responses)
            for response in responses:
                collector.add_leaf_response(response)
                if profile is not None and response.profile is not None:
                    profile.add_child(response.profile)

        merged = collector
        deadline_hit = (budget.deadline.expired
                        or any(is_deadline_error(e.error)
                               for e in merged.failed_splits))
        cancel_hit = any(is_cancel_error(e.error)
                         for e in merged.failed_splits)
        if (merged.num_attempted_splits > 0
                and merged.num_successful_splits == 0 and merged.failed_splits
                and not deadline_hit and not cancel_hit):
            # every split failed: a query-level problem (e.g. unknown field),
            # not a partial outage — surface it as an error (reference 400s).
            # Deadline expiries are NOT query-level problems: they return a
            # timed_out partial response below.
            raise ValueError(merged.failed_splits[0].error)
        with profiled_phase(PHASE_FETCH_DOCS) as rec:
            hits = self._fetch_docs_phase(request, merged, split_meta_by_id,
                                          nodes, budget.deadline)
            if rec is not None:
                rec["docs"] = len(hits)
        aggregations = None
        if request.aggs:
            aggregations = finalize_aggregations(merged.aggregation_states())
            # ES returns the aggregation skeleton even when no split
            # contributed states (empty index / zero matching splits)
            _fill_empty_aggs(aggregations, request.aggs)
        return SearchResponse(
            num_hits=merged.num_hits,
            hits=hits,
            elapsed_time_micros=int((time.monotonic() - t0) * 1e6),
            errors=[f"{e.split_id}: {e.error}" for e in merged.failed_splits],
            aggregations=aggregations,
            timed_out=deadline_hit or budget.deadline.expired,
            cancelled=cancel_hit,
            failed_splits=list(merged.failed_splits),
            num_attempted_splits=merged.num_attempted_splits,
            num_successful_splits=merged.num_successful_splits,
        )

    # ------------------------------------------------------------------
    def _fan_out(self, dispatches: list[tuple[str, LeafSearchRequest]],
                 nodes: list[str],
                 budget: QueryBudget) -> list[LeafSearchResponse]:
        """Dispatch every leaf request concurrently and collect responses in
        dispatch order (merge determinism). Each join is bounded by the
        remaining deadline; a dispatch still running at expiry is abandoned —
        its daemon thread finishes in the background — and reported as
        deadline-failed splits instead of blocking the root."""
        if not dispatches:
            return []
        deadline = budget.deadline
        if len(dispatches) == 1 and not deadline.bounded:
            node_id, leaf_request = dispatches[0]
            return [self._leaf_search_with_retry(leaf_request, node_id, nodes,
                                                 budget)]
        results: list[Optional[LeafSearchResponse]] = [None] * len(dispatches)
        # fan-out threads start with empty span stacks and fresh contextvars:
        # capture the root's traceparent HERE (the tracer's span stack is
        # thread-local, not a contextvar) so every leaf dispatch joins the
        # root trace; the contextvar bindings — deadline, tenant, profile —
        # ride the run_with_context snapshot below
        from ..observability.tracing import TRACER
        parent_tp = TRACER.current_traceparent()
        profile = current_profile()
        tenant = current_tenant()

        control_errors: list = []

        def run(i: int, node_id: str, leaf_request: LeafSearchRequest) -> None:
            with TRACER.span("leaf_dispatch",
                             {"node": node_id,
                              "num_splits": len(leaf_request.splits)},
                             remote_parent=parent_tp):
                try:
                    results[i] = self._leaf_search_with_retry(
                        leaf_request, node_id, nodes, budget)
                except (OverloadShed, TenantRateLimited) as exc:
                    # re-raised on the main thread after join: local
                    # backpressure fails the whole query, not one leaf
                    control_errors.append(exc)
                    results[i] = _all_splits_failed(leaf_request, str(exc))
                except Exception as exc:  # noqa: BLE001 - surfaced per split
                    results[i] = _all_splits_failed(leaf_request, str(exc))

        # snapshot under the authoritative bindings: budget.deadline is THE
        # query deadline even if a caller ever invokes _fan_out outside its
        # scope, so re-enter the scopes explicitly before capturing
        with profile_scope(profile), deadline_scope(deadline), \
                tenant_scope(tenant):
            spawned_run = run_with_context(run)
        threads = []
        for i, (node_id, leaf_request) in enumerate(dispatches):
            thread = sync.thread(
                target=spawned_run, args=(i, node_id, leaf_request),
                name=f"root-fanout-{i}", daemon=True)
            threads.append(thread)
            thread.start()
        for thread in threads:
            thread.join(timeout=deadline.clamp(None))
        if control_errors:
            raise control_errors[0]
        out: list[LeafSearchResponse] = []
        for i, (node_id, leaf_request) in enumerate(dispatches):
            response = results[i]
            if response is None:
                response = _all_splits_failed(
                    leaf_request,
                    f"deadline exceeded waiting for leaf search on {node_id}",
                    retryable=False)
            out.append(response)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _string_search_after(request: SearchRequest):
        """Marker for text-field sorts: (raw_term|None, split|None, doc).
        Leafs push it down as per-split ordinal bounds; the root collector
        re-filters on the decoded term strings (split-local ordinals are
        not cross-split comparable)."""
        if not request.search_after:
            return None
        sa = request.search_after
        if len(sa) == 3:
            raw, m_split, m_doc = sa[0], sa[1], sa[2]
        elif len(sa) == 4:  # secondary sort rides along; primary governs
            raw, m_split, m_doc = sa[0], sa[2], sa[3]
        else:
            raise ValueError(
                "search_after expects [sort_value(s)..., split_id, doc_id]")
        return (raw, None if m_split is None else str(m_split),
                int(m_doc) if m_doc is not None else -1)

    def _resolve_indexes(self, patterns: list[str]):
        out = []
        seen = set()
        all_indexes = None
        for pattern in patterns:
            if any(ch in pattern for ch in "*?"):
                if all_indexes is None:
                    all_indexes = self.metastore.list_indexes()
                for im in all_indexes:
                    if fnmatch.fnmatch(im.index_id, pattern) and im.index_uid not in seen:
                        seen.add(im.index_uid)
                        out.append(im)
            else:
                try:
                    im = self.metastore.index_metadata(pattern)
                except MetastoreError:
                    # unknown index id in a multi-pattern request: skip the
                    # pattern (ES semantics); anything NOT a typed metastore
                    # failure — deadline expiry, backpressure — propagates
                    continue
                if im.index_uid not in seen:
                    seen.add(im.index_uid)
                    out.append(im)
        return out

    def _prune_splits(self, index_metadata, doc_mapper: DocMapper,
                      request: SearchRequest) -> list[Split]:
        required_tags = extract_required_tags(
            request.query_ast, doc_mapper.tag_fields) or None
        query = ListSplitsQuery(
            index_uids=[index_metadata.index_uid],
            states=[SplitState.PUBLISHED],
            time_range_start=request.start_timestamp,
            time_range_end=request.end_timestamp,
            required_tags=required_tags,
        )
        splits = self.metastore.list_splits(query)
        # zonemap pruning: drop splits whose numeric column bounds
        # preclude a required predicate, before any byte is fetched
        constraints = extract_numeric_constraints(request.query_ast,
                                                  doc_mapper)
        if constraints:
            before = len(splits)
            splits = [s for s in splits if not split_excluded_by_bounds(
                s.metadata.column_bounds, constraints)]
            if before != len(splits):
                profile = current_profile()
                if profile is not None:
                    profile.add("splits_pruned_zonemap", before - len(splits))
        return splits

    def _leaf_search_with_retry(self, leaf_request: LeafSearchRequest,
                                node_id: str, nodes: list[str],
                                budget: Optional[QueryBudget] = None,
                                ) -> LeafSearchResponse:
        budget = budget or QueryBudget(Deadline.never(),
                                       max_retries=self.MAX_RETRIES_PER_QUERY)
        first_error: Optional[str] = None
        tenant = current_tenant()
        try:
            budget.deadline.check(f"leaf dispatch to {node_id}")
            leaf_request.deadline_millis = budget.deadline.timeout_millis()
            if tenant is not None:
                # the resolved class rides the wire so a remote leaf
                # schedules in the same band without sharing tenant config
                leaf_request.tenant = tenant.to_wire()
            client = self.clients[node_id]
            response = client.leaf_search(leaf_request)
        except DeadlineExceeded as exc:
            return _all_splits_failed(leaf_request, str(exc), retryable=False)
        except (OverloadShed, TenantRateLimited):
            # local backpressure rejects the WHOLE query (429 upstream);
            # retrying on another node would defeat the controller. A
            # REMOTE leaf's 429 arrives as a client error instead and
            # keeps the failed-node retry path below.
            raise
        except Exception as exc:  # noqa: BLE001 - node-level failure
            logger.warning("leaf search on %s failed: %s", node_id, exc)
            first_error = f"leaf search on {node_id} failed: {exc}"
            response = None
        if response is not None and not response.failed_splits:
            return response
        # Per-split failures of the whole request when the node itself died;
        # these are what a no-retry path must RETURN, never drop — a response
        # with empty failed_splits claims splits were searched cleanly.
        original_failures = (
            list(response.failed_splits) if response is not None
            else [SplitSearchError(split_id=s.split_id, error=first_error)
                  for s in leaf_request.splits])
        retryable_ids = {e.split_id for e in original_failures if e.retryable}

        def with_failures(failures: list[SplitSearchError]) -> LeafSearchResponse:
            if response is None:
                return LeafSearchResponse(
                    failed_splits=failures,
                    num_attempted_splits=len(leaf_request.splits))
            response.failed_splits = failures
            return response

        if not retryable_ids:
            return with_failures(original_failures)
        retry_index = budget.try_acquire_retry()
        if retry_index is None:  # pool drained or deadline passed
            return with_failures(original_failures)
        # retry failed splits (or the whole request) on the next-best node
        retry_splits = [s for s in leaf_request.splits
                        if s.split_id in retryable_ids]
        retry_node = None
        for candidate in nodes_for_split(retry_splits[0].split_id, nodes):
            if candidate != node_id:
                retry_node = candidate
                break
        if retry_node is None:
            return with_failures(original_failures)
        if not budget.sleep_before_retry(retry_index):
            return with_failures(original_failures)
        SEARCH_LEAF_RETRIES_TOTAL.inc()
        non_retryable = [e for e in original_failures
                         if e.split_id not in retryable_ids]
        # seed the retry with the Kth sort value the first attempt already
        # collected: round 2 starts pruning where round 1 left off instead
        # of re-proving the threshold from scratch (search/pruning.py)
        retry_threshold = None
        if response is not None:
            from ..models.doc_mapper import DocMapper as _DM
            from .pruning import threshold_from_response
            retry_threshold = threshold_from_response(
                leaf_request.search_request,
                _DM.from_dict(leaf_request.doc_mapping), response)
        retry_request = LeafSearchRequest(
            search_request=leaf_request.search_request,
            index_uid=leaf_request.index_uid,
            doc_mapping=leaf_request.doc_mapping,
            splits=retry_splits,
            deadline_millis=budget.deadline.timeout_millis(),
            tenant=tenant.to_wire() if tenant is not None else None,
            sort_value_threshold=retry_threshold,
        )
        try:
            retry_response = self.clients[retry_node].leaf_search(retry_request)
        except (OverloadShed, TenantRateLimited):
            # the retry client can be LOCAL (in-process service): its
            # backpressure must fail the whole query as a typed 429, same
            # contract as the first attempt above — swallowing it here
            # demoted a controller rejection to a generic split failure
            raise
        except DeadlineExceeded as exc:
            return with_failures(
                [SplitSearchError(split_id=s.split_id, error=str(exc),
                                  retryable=False)
                 for s in retry_splits] + non_retryable)
        except Exception as exc:  # noqa: BLE001
            logger.warning("leaf retry on %s failed: %s", retry_node, exc)
            return with_failures(
                [SplitSearchError(split_id=s.split_id,
                                  error=f"retry on {retry_node} failed: {exc}")
                 for s in retry_splits] + non_retryable)
        if response is None:
            retry_response.failed_splits = (
                list(retry_response.failed_splits) + non_retryable)
            return retry_response
        # keep the successful part of the original + the retry results
        # (non-retryable failures from the first attempt ride along)
        from ..models.doc_mapper import DocMapper as _DM
        merged = IncrementalCollector(
            max_hits=leaf_request.search_request.max_hits
            + leaf_request.search_request.start_offset,
            string_sort=string_sort_of(
                leaf_request.search_request,
                _DM.from_dict(leaf_request.doc_mapping)))
        ok_part = LeafSearchResponse(
            num_hits=response.num_hits, partial_hits=response.partial_hits,
            failed_splits=non_retryable,
            intermediate_aggs=response.intermediate_aggs,
            num_attempted_splits=response.num_attempted_splits,
            num_successful_splits=response.num_successful_splits)
        merged.add_leaf_response(ok_part)
        merged.add_leaf_response(retry_response)
        return merged.to_leaf_response()

    def _fetch_docs_phase(self, request: SearchRequest,
                          collector: IncrementalCollector,
                          split_meta_by_id: dict,
                          nodes: list[str],
                          deadline: Optional[Deadline] = None) -> list[Hit]:
        deadline = deadline or Deadline.never()
        top_hits = collector.partial_hits()
        if not top_hits or request.max_hits == 0:
            return []
        by_split: dict[str, list] = {}
        for hit in top_hits:
            by_split.setdefault(hit.split_id, []).append(hit)
        docs_by_address: dict[tuple[str, int], dict] = {}
        for split_id, hits in by_split.items():
            if deadline.expired:
                # out of budget: return what phase 1 earned; hits whose docs
                # were not fetched are dropped from the (already partial) page
                break
            index_uid, offset, doc_mapping = split_meta_by_id[split_id]
            fetch_request = FetchDocsRequest(
                index_uid=index_uid, split=offset,
                doc_ids=[h.doc_id for h in hits],
                snippet_fields=request.snippet_fields,
                query_ast=request.query_ast if request.snippet_fields else None,
            )
            # first attempt on the split's preferred replica, then exactly
            # ONE retry on the next replica — and only if budget remains.
            # Unbounded replica walks here could blow far past the deadline
            # phase 1 already honored.
            docs = None
            candidates = nodes_for_split(split_id, nodes)
            for attempt, node_id in enumerate(candidates[:2]):
                if attempt > 0:
                    if deadline.expired:
                        logger.warning(
                            "fetch_docs for split %s: no budget left for a "
                            "replica retry", split_id)
                        break
                    SEARCH_FETCH_DOCS_RETRIES_TOTAL.inc()
                try:
                    docs = self.clients[node_id].fetch_docs(fetch_request)
                    break
                except (OverloadShed, TenantRateLimited):
                    # local backpressure fails the whole query as a typed
                    # 429 — replica-retrying it would defeat the controller
                    raise
                except Exception as exc:  # noqa: BLE001
                    logger.warning("fetch_docs on %s failed: %s", node_id, exc)
            if docs is None:
                continue
            for hit, doc in zip(hits, docs):
                docs_by_address[(split_id, hit.doc_id)] = doc
        out: list[Hit] = []
        scoring = not request.sort_fields or request.sort_fields[0].field == "_score"
        for hit in top_hits:
            doc = docs_by_address.get((hit.split_id, hit.doc_id))
            if doc is None:
                continue
            snippets = doc.pop("_snippets", None)
            sort_values = [hit.raw_sort_value]
            if len(request.sort_fields) > 1:
                sort_values.append(hit.raw_sort_value2)
            out.append(Hit(
                doc=doc,
                score=hit.raw_sort_value if scoring else None,
                sort_values=sort_values,
                split_id=hit.split_id,
                doc_id=hit.doc_id,
                snippets=snippets,
            ))
        return out

    @staticmethod
    def _search_after_key(request: SearchRequest):
        if not request.search_after:
            return None
        sa = request.search_after
        two_keys = len(request.sort_fields) > 1
        if len(sa) != (4 if two_keys else 3):
            raise ValueError(
                "search_after expects [sort_value(s)..., split_id, doc_id] "
                "matching the number of sort fields")

        def encode(value, sort):
            if value is None:
                from .leaf import MISSING_VALUE_SENTINEL
                return MISSING_VALUE_SENTINEL
            if isinstance(value, str):
                raise ValueError(
                    "search_after got a string for a numeric sort field")
            value = float(value)
            if sort and sort.order == "asc":
                value = -value
            return value

        v1 = encode(sa[0], request.sort_fields[0] if request.sort_fields else None)
        if two_keys:
            v2 = encode(sa[1], request.sort_fields[1])
            # m_split None = value-only ES marker (strictly after the value)
            return (v1, v2, None if sa[2] is None else str(sa[2]),
                    int(sa[3]))
        return (v1, 0.0, None if sa[1] is None else str(sa[1]), int(sa[2]))


def _fill_empty_aggs(aggregations: dict, aggs_request: dict) -> None:
    """Synthesize ES empty-result shapes for aggregations no split reported
    states for (empty index / zero matching splits). Shapes come from the
    SAME finalize path as real results (identity states in, finalize out),
    so empty and non-empty responses cannot diverge structurally."""
    import numpy as np

    from ..ops.aggs import HLL_NUM_REGISTERS, PCTL_NUM_BUCKETS
    from ..query.aggregations import (CompositeAgg, DateHistogramAgg,
                                      HistogramAgg, MetricAgg, RangeAgg,
                                      TermsAgg, parse_aggs)
    from .collector import finalize_aggregations
    try:
        specs = parse_aggs(aggs_request)
    # qwlint: disable-next-line=QW004 - pure parse of an already-validated
    # dict; no control-flow exception can originate here
    except Exception:  # noqa: BLE001 - request already validated upstream
        return
    empty_states: dict[str, dict] = {}
    for spec in specs:
        if spec.name in aggregations:
            continue
        if isinstance(spec, MetricAgg):
            if spec.kind == "percentiles":
                empty_states[spec.name] = {
                    "kind": "percentiles",
                    "sketch": np.zeros(PCTL_NUM_BUCKETS, dtype=np.int64),
                    "percents": list(spec.percents), "keyed": spec.keyed}
            elif spec.kind == "cardinality":
                empty_states[spec.name] = {
                    "kind": "cardinality",
                    "hll": np.zeros(HLL_NUM_REGISTERS, dtype=np.int32)}
            else:
                empty_states[spec.name] = {
                    "kind": spec.kind,
                    "state": np.array([0.0, 0.0, 0.0, np.inf, -np.inf])}
        elif isinstance(spec, RangeAgg):
            empty_states[spec.name] = {
                "kind": "range", "ranges": list(spec.ranges),
                "bucket_map": {}}
        elif isinstance(spec, CompositeAgg):
            empty_states[spec.name] = {
                "kind": "composite", "bucket_map": {}, "size": spec.size,
                "sources": [{"name": s.name, "kind": s.kind}
                            for s in spec.sources]}
        elif isinstance(spec, TermsAgg):
            empty_states[spec.name] = {
                "kind": "terms", "bucket_map": {}, "size": spec.size,
                "min_doc_count": spec.min_doc_count,
                "order_desc": spec.order_by_count_desc}
        elif isinstance(spec, (DateHistogramAgg, HistogramAgg)):
            interval = (spec.interval_micros
                        if isinstance(spec, DateHistogramAgg)
                        else spec.interval)
            empty_states[spec.name] = {
                "kind": ("date_histogram"
                         if isinstance(spec, DateHistogramAgg)
                         else "histogram"),
                "bucket_map": {}, "interval": interval, "origin": 0,
                "min_doc_count": spec.min_doc_count,
                "offset": getattr(spec, "offset_micros", 0)}
    if empty_states:
        aggregations.update(finalize_aggregations(empty_states))
