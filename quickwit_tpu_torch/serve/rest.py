"""REST server: quickwit API + ES-compatible API + internal search RPC.

Role of the reference's warp router + handlers (`quickwit-serve/src/rest.rs`,
`search_api/rest_handler.rs`, `elasticsearch_api/rest_handler.rs:245,674`,
`index_api/rest_handler.rs`) over Python's stdlib threading HTTP server:

  GET  /health/livez | /health/readyz
  GET  /metrics                                  (prometheus text)
  GET  /api/v1/cluster                           (members)
  POST /api/v1/indexes                           (create index from config)
  GET  /api/v1/indexes                           | /api/v1/indexes/{id}
  PUT  /api/v1/indexes/{id}                      (live config update)
  DELETE /api/v1/indexes/{id}
  GET  /api/v1/indexes/{id}/splits
  POST /api/v1/{index}/ingest?commit=...         (ndjson body)
  GET|POST /api/v1/{index}/search                (query params or JSON)
  POST /api/v1/{index}/search/stream             (alias of search, round 1)
  -- ES-compatible --
  POST|GET /api/v1/_elastic/{index}/_search
  POST /api/v1/_elastic/_msearch
  POST /api/v1/_elastic/_bulk | /{index}/_bulk
  GET  /api/v1/_elastic/_cat/indices
  GET  /api/v1/_elastic/{index}/_field_caps
  -- internal RPC (root↔leaf transport; gRPC's role) --
  POST /internal/leaf_search
  POST /internal/fetch_docs
  POST /internal/heartbeat

Counterpart of the JAX package's `serve/rest.py`, route for route. Two
routes differ: `POST /api/v1/_sql` answers 501 until the SQL engine is
ported, and the debug route's `jit_cache_entries` counts the executor's
program caches (`search.executor.executor_cache_size`).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlparse

from ..metastore.base import ListSplitsQuery, MetastoreError
from ..observability.metrics import METRICS
from ..indexing.transform import TransformParseError
from ..ingest.router import (INGEST_API_SOURCE_ID, INGEST_V2_SOURCE_ID,
                             INTERNAL_SOURCE_IDS)
from ..query.aggregations import AggParseError
from ..query.es_dsl import EsDslParseError, es_query_to_ast
from ..query.parser import QueryParseError, parse_query_string
from ..search.models import (
    FetchDocsRequest, LeafSearchRequest, SearchRequest, SortField,
    normalize_sort_fields,
)
from ..search.plan import PlanError
from ..tenancy import (
    ES_FALLBACK_HEADER, GLOBAL_TENANCY, OverloadShed, TENANT_HEADER,
    TenantRateLimited, tenant_scope,
)
from .node import Node
from .serializers import leaf_response_from_dict, leaf_response_to_dict

logger = logging.getLogger(__name__)

_MAX_INFLATED_BYTES = 256 << 20  # gzip bodies inflate to at most 256 MiB



_REQUEST_COUNTER = METRICS.counter("qw_http_requests_total", "HTTP requests")
_REQUEST_LATENCY = METRICS.histogram("qw_http_request_duration_seconds",
                                     "HTTP request latency")


class ApiError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[dict[str, str]] = None,
                 payload: Any = None):
        super().__init__(message)
        self.status = status
        # extra response headers (e.g. Retry-After on 429) and an optional
        # structured body overriding the default {"message": ...}
        self.headers = headers or {}
        self.payload = payload


_PARSE_ERRORS = (QueryParseError, EsDslParseError, AggParseError,
                 PlanError, TransformParseError, json.JSONDecodeError,
                 ValueError)
_METASTORE_STATUS = {"not_found": 404, "already_exists": 400,
                     "invalid_argument": 400, "failed_precondition": 409}


def classify_exception(exc: BaseException) -> Optional[int]:
    """Exception → HTTP status, shared by the span classifier and the
    response writer so recorded span status can never diverge from the
    actual response code. None = unhandled (500 + traceback log)."""
    if isinstance(exc, ApiError):
        return exc.status
    if isinstance(exc, (TenantRateLimited, OverloadShed)):
        return 429
    if isinstance(exc, _PARSE_ERRORS):
        return 400
    if isinstance(exc, MetastoreError):
        return _METASTORE_STATUS.get(exc.kind, 500)
    return None


def _throttle_error(exc: Exception) -> ApiError:
    """TenantRateLimited / OverloadShed → 429 with a Retry-After header
    and an ES-compatible error body (clients with ES retry middleware
    back off without custom handling)."""
    import math
    retry_after = max(1, math.ceil(getattr(exc, "retry_after_secs", 1.0)))
    kind = ("rate_limit_exceeded" if isinstance(exc, TenantRateLimited)
            else "overloaded")
    return ApiError(
        429, str(exc), headers={"Retry-After": str(retry_after)},
        payload={"status": 429,
                 "error": {"type": kind, "reason": str(exc)}})


def _search_request_from_params(index_id: str, params: dict[str, Any],
                                default_fields) -> SearchRequest:
    query = params.get("query", "*")
    ast = parse_query_string(query, default_fields)
    sort_fields: tuple[SortField, ...] = (SortField(),)
    sort_by = params.get("sort_by") or params.get("sort_by_field")
    if sort_by:
        if sort_by.startswith("-"):
            sort_fields = (SortField(sort_by[1:].replace("+", ""), "desc"),)
        else:
            sort_fields = (SortField(sort_by.lstrip("+"), "asc"),)
    aggs = params.get("aggs")
    if isinstance(aggs, str):
        aggs = json.loads(aggs)
    def _ts(name):
        value = params.get(name)
        return int(value) * 1_000_000 if value is not None else None
    return SearchRequest(
        # comma-separated lists and glob patterns both resolve at the root
        # (reference: index id patterns on every search route)
        index_ids=index_id.split(","),
        query_ast=ast,
        max_hits=int(params.get("max_hits", 20)),
        start_offset=int(params.get("start_offset", 0)),
        sort_fields=sort_fields,
        aggs=aggs,
        start_timestamp=_ts("start_timestamp"),
        end_timestamp=_ts("end_timestamp"),
        count_hits_exact=str(params.get("count_all", "true")).lower()
        not in ("false", "0", "no"),
        snippet_fields=tuple(params["snippet_fields"].split(","))
        if params.get("snippet_fields") else (),
        timeout_millis=int(params["timeout_ms"])
        if params.get("timeout_ms") is not None else None,
        profile=str(params.get("profile", "false")).lower()
        in ("true", "1", "yes"),
        query_id=params.get("query_id"),
    )


def _search_response_to_json(response) -> dict[str, Any]:
    return response.to_dict()


_ES_DURATION_UNITS = {"nanos": 1e-6, "micros": 1e-3, "ms": 1.0,
                      "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0,
                      "d": 86_400_000.0}


def _parse_es_duration_millis(value) -> Optional[int]:
    """ES time-unit strings ("500ms", "1s", "2m") → millis. Bare numbers
    are millis (ES's own default for `timeout`)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    text = str(value).strip().lower()
    for unit in sorted(_ES_DURATION_UNITS, key=len, reverse=True):
        if text.endswith(unit):
            number = text[: -len(unit)]
            try:
                return int(float(number) * _ES_DURATION_UNITS[unit])
            except ValueError:
                break
    try:
        return int(float(text))
    except ValueError:
        raise ApiError(400, f"invalid time value: {value!r}")


class RestServer:
    def __init__(self, node: Node, host: Optional[str] = None,
                 port: Optional[int] = None,
                 ingest_rate_limit_mb_per_sec: float = 80.0):
        self.node = node
        from ..common.tower import TokenBucket
        # byte-cost token bucket on ingest (reference: ingest rate limiting)
        self.ingest_bucket = TokenBucket(
            rate_per_sec=ingest_rate_limit_mb_per_sec * 1e6,
            burst=ingest_rate_limit_mb_per_sec * 2e6)
        self.host = host if host is not None else node.config.rest_host
        self.port = port if port is not None else node.config.rest_port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        config = self.node.config
        if config.tls_enabled:
            # terminate TLS on the REST listener. Handshake is deferred
            # to the per-connection handler thread
            # (do_handshake_on_connect=False): a client that connects and
            # never speaks must not wedge the shared accept loop.
            context = config.server_ssl_context()
            self._httpd.socket = context.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self._httpd.server_address[1]
        self.node.config.rest_port = self.port
        # qwlint: disable-next-line=QW003 - REST listener: each request
        # binds deadline/tenant from its own headers/params downstream
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"rest-{self.port}", daemon=True)
        self._thread.start()
        logger.info("REST server listening on %s://%s:%d",
                    "https" if config.tls_enabled else "http",
                    self.host, self.port)

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------------
    # route implementations
    def route(self, method: str, path: str, params: dict[str, Any],
              body: bytes, client_host: str = "",
              content_type: str = "",
              traceparent: str = "",
              tenant_id: str = "") -> tuple[int, Any]:
        """Traced entry point: every request is a server span, joined to
        the caller's trace when a W3C `traceparent` header came in
        (reference: tracing_utils.rs context extraction). The resolved
        tenant (from the `x-qw-tenant` header, `x-opaque-id` fallback, or
        the configured default) is bound ambiently for the whole request;
        with tenancy disabled and no header it resolves to None and the
        stack stays tenant-blind."""
        from ..observability.tracing import TRACER
        with TRACER.span("http.request",
                         {"http.method": method, "http.target": path},
                         remote_parent=traceparent,
                         scope=self.node.config.node_id) as span:
            try:
                tenant = GLOBAL_TENANCY.resolve(tenant_id or None)
                if tenant is not None:
                    span.set_attribute("tenant.id", tenant.tenant_id)
                try:
                    with tenant_scope(tenant):
                        status, payload = self._route_inner(
                            method, path, params, body,
                            client_host=client_host,
                            content_type=content_type)
                except (TenantRateLimited, OverloadShed) as exc:
                    raise _throttle_error(exc)
            except Exception as exc:
                # handled client/server error: classify before the span
                # closes so routine 4xx don't pollute error-rate queries
                code = classify_exception(exc)
                if code is None:
                    raise  # unhandled → span closes with status=error
                span.set_attribute("http.status_code", code)
                span.status = "error" if code >= 500 else "ok"
                raise
            span.set_attribute("http.status_code", status)
            if status >= 500:
                span.status = "error"
            return status, payload

    def _route_inner(self, method: str, path: str, params: dict[str, Any],
                     body: bytes, client_host: str = "",
                     content_type: str = "") -> tuple[int, Any]:
        node = self.node
        if path == "/health/livez":
            return 200, True
        if path == "/health/readyz":
            return (200, True) if node.cluster.is_ready() else (503, False)
        if path == "/metrics":
            # fold buffered flight-recorder counts into qw_flight_* first:
            # emit() defers the labeled counter inc off the hot path
            from ..observability.flight import FLIGHT
            FLIGHT.flush_metrics()
            return 200, METRICS.expose_text()
        if path in ("/ui", "/ui/", "/") and method == "GET":
            from .ui import UI_HTML
            return 200, ("__html__", UI_HTML)
        if path == "/api/v1/cluster":
            return 200, {
                "node_id": node.config.node_id,
                "members": [
                    {"node_id": m.node_id, "roles": list(m.roles),
                     "rest_endpoint": m.rest_endpoint, "ready": m.is_ready}
                    for m in node.cluster.members()
                ],
            }

        # --- internal RPC ---------------------------------------------
        if path == "/internal/leaf_search" and method == "POST":
            request = LeafSearchRequest.from_dict(json.loads(body))
            response = node.search_service.leaf_search(request)
            return 200, leaf_response_to_dict(response)
        if path == "/internal/fetch_docs" and method == "POST":
            request = FetchDocsRequest.from_dict(json.loads(body))
            return 200, node.search_service.fetch_docs(request)
        if path == "/internal/replicate" and method == "POST":
            # follower side of ingest chained replication
            import base64

            from ..ingest.ingester import ReplicationGap
            payload = json.loads(body)
            if payload.get("reset"):
                # leader's retained WAL starts past our gap: restart the
                # replica log at the offered position (records below it
                # are already published; the metastore checkpoint covers)
                node.ingester.replica_reset(
                    payload["index_uid"], payload["source_id"],
                    payload["shard_id"], int(payload["first_position"]))
            try:
                last = node.ingester.replica_persist(
                    payload["index_uid"], payload["source_id"],
                    payload["shard_id"], int(payload["first_position"]),
                    [base64.b64decode(p) for p in payload["payloads"]])
            except ReplicationGap as gap:
                return 409, {"gap": True, "replica_position": gap.have}
            return 200, {"replica_position": last}
        if path == "/internal/kv" and method == "POST":
            # cluster KV (reference put_kv), dispatched on kind
            from ..search.scroll import context_from_dict
            payload = json.loads(body)
            kind = payload.get("kind")
            if kind == "scroll":
                node.scroll_store.put_with_id(
                    payload["key"], context_from_dict(payload["value"]))
            elif kind == "scroll_cursor":
                context = node.scroll_store.get(payload["key"])
                if context is not None:
                    context.cursor = max(context.cursor,
                                         int(payload["value"]))
            else:
                raise ApiError(400, f"unknown kv kind {kind!r}")
            return 200, {"ok": True}
        if path == "/internal/kv_get" and method == "POST":
            from ..search.scroll import context_to_dict
            payload = json.loads(body)
            context = node.scroll_store.get(payload["key"])
            if context is None:
                return 200, {"value": None}
            return 200, {"value": context_to_dict(context)}
        if path == "/internal/apply_indexing_plan" and method == "POST":
            payload = json.loads(body) if body else {}
            return 200, node.apply_indexing_plan(payload.get("tasks", []))
        if path == "/internal/indexing_tasks" and method == "POST":
            return 200, node.indexing_tasks_report()
        if path == "/internal/replica_truncate" and method == "POST":
            payload = json.loads(body)
            node.ingester.replica_truncate(
                payload["index_uid"], payload["source_id"],
                payload["shard_id"], int(payload["position"]))
            return 200, {"ok": True}
        if path == "/internal/heartbeat" and method == "POST":
            payload = json.loads(body)
            from ..cluster.membership import (ClusterMember,
                                              substitute_wildcard_host)
            node.cluster.upsert_heartbeat(ClusterMember(
                node_id=payload["node_id"], roles=tuple(payload["roles"]),
                rest_endpoint=substitute_wildcard_host(
                    payload.get("rest_endpoint", ""), client_host),
                grpc_endpoint=substitute_wildcard_host(
                    payload.get("grpc_endpoint", ""), client_host)))
            return 200, {"node_id": node.config.node_id,
                         "roles": list(node.config.roles),
                         "rest_endpoint": f"{self.host}:{self.port}",
                         "grpc_endpoint": node._grpc_advertise()}

        # --- developer / debug ----------------------------------------
        if path == "/api/v1/developer/pprof/flamegraph" and method == "GET":
            # on-demand CPU profile (reference developer_api/pprof.rs:167):
            # sample every thread for `duration` seconds at `hz`, render a
            # self-contained SVG (or ?format=collapsed for raw stacks).
            # One profile at a time (the reference serializes too):
            # concurrent profilers would sample each other and N×30s
            # GIL-heavy loops are a free DoS.
            from ..observability.profiler import (PROFILE_LOCK, collapse,
                                                  render_svg, sample_stacks)
            duration = min(float(params.get("duration", 2.0)), 30.0)
            hz = min(float(params.get("hz", 100.0)), 1000.0)
            if not PROFILE_LOCK.acquire(blocking=False):
                raise ApiError(429, "a profile is already running")
            try:
                counts = sample_stacks(duration_secs=duration, hz=hz)
            finally:
                PROFILE_LOCK.release()
            if params.get("format") == "collapsed":
                return 200, ("__raw__", collapse(counts).encode(),
                             "text/plain; charset=utf-8")
            svg = render_svg(counts,
                             title=f"{node.config.node_id} CPU profile "
                                   f"({duration:g}s @ {hz:g}Hz)")
            return 200, ("__raw__", svg.encode(), "image/svg+xml")
        if path == "/api/v1/developer/tenants" and method == "GET":
            # per-tenant config + live usage counters + overload state +
            # SLO burn; ?scope=cluster merges every alive peer's and
            # offload worker's report (tenancy/rollup.py)
            if params.get("scope") == "cluster":
                from ..tenancy.rollup import collect_cluster_tenant_report
                return 200, collect_cluster_tenant_report(node)
            from ..observability.slo import SLO_TRACKER
            report = GLOBAL_TENANCY.report()
            report["node_id"] = node.config.node_id
            report["slo"] = SLO_TRACKER.report()
            return 200, report
        if path == "/api/v1/developer/trace" and method == "GET":
            # flight-recorder export: the always-on device timeline as
            # Chrome trace-event JSON (load into Perfetto / chrome://tracing;
            # events carry query_id + tenant + OTLP span correlation)
            from ..observability.flight import FLIGHT
            limit = min(int(params.get("limit", 0) or 0), 1 << 20)
            trace = FLIGHT.to_chrome_trace(
                limit=limit or None,
                process_name=f"quickwit-tpu:{node.config.node_id}")
            return 200, trace
        if path == "/api/v1/developer/slowlog":
            # ring buffer of slow/shed/timed-out query profiles (role of the
            # reference's slow-query log). GET returns the buffer; POST with
            # {"threshold_ms": N} arms/re-arms capture, N=null disarms.
            from ..observability.slowlog import SLOW_QUERY_LOG
            if method == "POST":
                payload = json.loads(body) if body else {}
                threshold = payload.get("threshold_ms")
                SLOW_QUERY_LOG.configure(
                    float(threshold) if threshold is not None else None)
                return 200, {"armed": SLOW_QUERY_LOG.armed,
                             "threshold_ms": SLOW_QUERY_LOG.threshold_ms}
            return 200, {"armed": SLOW_QUERY_LOG.armed,
                         "threshold_ms": SLOW_QUERY_LOG.threshold_ms,
                         "entries": SLOW_QUERY_LOG.entries()}
        if path == "/api/v1/developer/debug":
            import sys as _sys
            import traceback
            from ..search.executor import executor_cache_size
            frames = {}
            for thread_id, frame in _sys._current_frames().items():
                frames[str(thread_id)] = traceback.format_stack(frame)[-4:]
            ctx = node.searcher_context
            return 200, {
                "node_id": node.config.node_id,
                "jit_cache_entries": executor_cache_size(),
                "leaf_cache": ctx.leaf_cache.stats,
                "predicate_cache": ctx.predicate_cache.stats,
                "mask_cache": (ctx.mask_cache.stats
                               if ctx.mask_cache is not None else None),
                "agg_cache": (ctx.agg_cache.stats
                              if ctx.agg_cache is not None else None),
                "open_split_readers": len(ctx._readers),
                "wal_shards": node.ingester.shard_throughput_state(),
                "threads": frames,
            }

        # --- index templates ------------------------------------------
        if path == "/api/v1/templates" and method == "POST":
            node.metastore.create_index_template(json.loads(body))
            return 200, {"created": True}
        if path == "/api/v1/templates" and method == "GET":
            return 200, node.metastore.list_index_templates()
        m = re.fullmatch(r"/api/v1/templates/([^/]+)", path)
        if m and method == "DELETE":
            node.metastore.delete_index_template(m.group(1))
            return 200, {"deleted": True}

        # --- index management -----------------------------------------
        if path == "/api/v1/indexes" and method == "POST":
            metadata = node.index_service.create_index(json.loads(body))
            return 200, metadata.to_dict()
        if path == "/api/v1/indexes" and method == "GET":
            return 200, [m.to_dict() for m in node.metastore.list_indexes()]
        m = re.fullmatch(r"/api/v1/indexes/([^/]+)", path)
        if m:
            index_id = m.group(1)
            if method == "GET":
                return 200, node.metastore.index_metadata(index_id).to_dict()
            if method == "PUT":
                # live config update (reference update_index): search
                # settings, retention, indexing settings, append-only
                # doc-mapping additions
                update = json.loads(body)
                if not isinstance(update, dict):
                    raise ApiError(400, "update must be a JSON object")
                metadata = node.index_service.update_index(index_id,
                                                           update)
                return 200, metadata.to_dict()
            if method == "DELETE":
                removed = node.index_service.delete_index(index_id)
                return 200, {"removed_splits": removed}
        m = re.fullmatch(r"/api/v1/indexes/([^/]+)/splits", path)
        if m and method == "GET":
            metadata = node.metastore.index_metadata(m.group(1))
            splits = node.metastore.list_splits(
                ListSplitsQuery(index_uids=[metadata.index_uid]))
            return 200, {"splits": [s.to_dict() for s in splits]}

        # --- searcher pre-warm (operability: run representative queries
        # once so jit compiles + transfers happen before user traffic) ---
        m = re.fullmatch(r"/api/v1/([^/_][^/]*)/warmup", path)
        if m and method == "POST":
            payload = json.loads(body) if body else {}
            index_id = m.group(1)
            requests = None
            if payload.get("queries"):
                # the SAME request construction production searches use:
                # warmed plan structures (sort, time filters, aggs, k)
                # match real traffic exactly
                fields = node.metastore.index_metadata(
                    index_id).index_config.doc_mapper.default_search_fields
                requests = [
                    _search_request_from_params(index_id, spec, fields)
                    for spec in payload["queries"]]
            return 200, node.warmup_index(index_id, requests)

        # --- delete tasks (reference: delete_task_api/handler.rs) -------
        m = re.fullmatch(r"/api/v1/([^/_][^/]*)/delete-tasks", path)
        if m and method == "POST":
            from ..query.es_dsl import es_query_to_ast
            metadata = node.metastore.index_metadata(m.group(1))
            payload = json.loads(body)
            delete_query = payload.get("query")
            if delete_query is None:
                return 400, {"error": "missing delete query"}
            ast = es_query_to_ast(
                delete_query,
                metadata.index_config.doc_mapper.default_search_fields)
            opstamp = node.metastore.create_delete_task(
                metadata.index_uid, ast.to_dict())
            return 200, {"opstamp": opstamp}
        if m and method == "GET":
            metadata = node.metastore.index_metadata(m.group(1))
            return 200, {"delete_tasks": node.metastore.list_delete_tasks(
                metadata.index_uid)}

        # --- source management (reference: index_api.rs source routes) --
        m = re.fullmatch(r"/api/v1/indexes/([^/]+)/sources", path)
        if m and method == "POST":
            from ..indexing.sources import parse_source_config
            metadata = node.metastore.index_metadata(m.group(1))
            source = parse_source_config(json.loads(body))
            node.metastore.add_source(metadata.index_uid, source)
            return 200, source.to_dict()
        m = re.fullmatch(r"/api/v1/indexes/([^/]+)/sources/([^/]+)", path)
        if m and method == "DELETE":
            if m.group(2) in INTERNAL_SOURCE_IDS:
                # reference: index_api.rs forbids deleting internal sources
                # (their checkpoints guard against WAL replay)
                raise ApiError(
                    400, f"source {m.group(2)!r} is internal and cannot be "
                         f"deleted")
            metadata = node.metastore.index_metadata(m.group(1))
            node.metastore.delete_source(metadata.index_uid, m.group(2))
            return 200, {"deleted": m.group(2)}
        m = re.fullmatch(
            r"/api/v1/indexes/([^/]+)/sources/([^/]+)/reset-checkpoint",
            path)
        if m and method == "PUT":
            # reference index_api reset_source_checkpoint: replay the
            # source from the beginning (exactly-once bookkeeping wiped).
            # The built-in ingest checkpoints guard the WAL against
            # replaying already-published records — never resettable.
            if m.group(2) in INTERNAL_SOURCE_IDS:
                raise ApiError(400, f"{m.group(2)} is a built-in source; "
                                    "its checkpoint guards the ingest "
                                    "WAL against replay")
            metadata = node.metastore.index_metadata(m.group(1))
            node.metastore.reset_source_checkpoint(metadata.index_uid,
                                                   m.group(2))
            return 200, {"source_id": m.group(2), "checkpoint": "reset"}
        m = re.fullmatch(r"/api/v1/indexes/([^/]+)/sources/([^/]+)/toggle",
                         path)
        if m and method == "PUT":
            metadata = node.metastore.index_metadata(m.group(1))
            parsed = json.loads(body) if body else {}
            if not isinstance(parsed, dict):
                raise ApiError(400, "toggle body must be a JSON object")
            enable = bool(parsed.get("enable", True))
            node.metastore.toggle_source(metadata.index_uid, m.group(2), enable)
            return 200, {"source_id": m.group(2), "enabled": enable}

        # --- ingest ----------------------------------------------------
        m = re.fullmatch(r"/api/v1/([^/_][^/]*)/ingest", path)
        if m and method == "POST":
            self._check_ingest_rate(body)
            docs = _parse_ndjson(body)
            if params.get("commit") == "wal":
                # v2 path: durable WAL append, indexed by the next ingest pass
                return 200, node.ingest_v2(m.group(1), docs)
            result = node.ingest(m.group(1), docs,
                                 commit=params.get("commit", "auto"))
            return 200, result

        # --- otlp / jaeger --------------------------------------------
        if path == "/api/v1/otlp/v1/logs" and method == "POST":
            if "protobuf" in content_type:  # binary OTLP/HTTP (the default
                # encoding of real OTel collectors/SDKs)
                from .otlp_proto import decode_logs_request
                node.otel.ingest_logs(decode_logs_request(body))
                # empty ExportLogsServiceResponse (all fields default)
                return 200, ("__raw__", b"", "application/x-protobuf")
            return 200, node.otel.ingest_logs(json.loads(body))
        if path == "/api/v1/otlp/v1/traces" and method == "POST":
            if "protobuf" in content_type:
                from .otlp_proto import decode_traces_request
                node.otel.ingest_traces(decode_traces_request(body))
                return 200, ("__raw__", b"", "application/x-protobuf")
            return 200, node.otel.ingest_traces(json.loads(body))
        if path == "/api/v1/jaeger/api/services":
            return 200, {"data": node.otel.services(), "total": 0}
        m = re.fullmatch(r"/api/v1/jaeger/api/services/([^/]+)/operations", path)
        if m:
            return 200, {"data": node.otel.operations(m.group(1)), "total": 0}
        m = re.fullmatch(r"/api/v1/jaeger/api/traces/([^/]+)", path)
        if m:
            spans = node.otel.get_trace(m.group(1))
            if not spans:
                raise ApiError(404, f"trace {m.group(1)!r} not found")
            return 200, {"data": [node.otel.jaeger_trace(m.group(1), spans)]}
        if path == "/api/v1/jaeger/api/traces":
            trace_ids = node.otel.find_traces(
                service=params.get("service"),
                operation=params.get("operation"),
                min_duration_micros=int(params["minDuration"])
                if params.get("minDuration") else None,
                limit=int(params.get("limit", 20)))
            return 200, {"data": [
                node.otel.jaeger_trace(t, node.otel.get_trace(t))
                for t in trace_ids]}

        # --- SQL analytics (role of the fork's datafusion_api) --------
        if path == "/api/v1/_sql" and method == "POST":
            raise ApiError(501, "_sql: the SQL engine (analytics/sql.py) is "
                                "not ported yet (ROADMAP item 14)")
        # --- scroll / list apis ---------------------------------------
        if path == "/api/v1/scroll":
            scroll_id = params.get("scroll_id")
            if scroll_id is None and body:
                scroll_id = json.loads(body).get("scroll_id")
            if not scroll_id:
                raise ApiError(400, "missing scroll_id")
            if method == "DELETE":  # clear-scroll (frees the context early)
                return 200, {"released": node.end_scroll(scroll_id)}
            return 200, node.continue_scroll(scroll_id)
        m = re.fullmatch(r"/api/v1/([^/_][^/]*)/list-terms", path)
        if m:
            from ..search.list_apis import root_list_terms
            if "field" not in params:
                raise ApiError(400, "missing field parameter")
            terms = root_list_terms(
                node.metastore, node.search_service.context, m.group(1),
                params["field"], start_key=params.get("start_key"),
                end_key=params.get("end_key"),
                max_terms=int(params.get("max_terms", 100)))
            return 200, {"terms": terms}
        m = re.fullmatch(r"/api/v1/([^/]+)/fields", path)
        if m:
            from ..search.list_apis import list_fields
            return 200, {"fields": list_fields(node.metastore,
                                               m.group(1).split(","))}
        # --- query cancellation ----------------------------------------
        m = re.fullmatch(r"/api/v1/search/([^/]+)", path)
        if m and method == "DELETE":
            # cancel an in-flight query by its caller-chosen query_id: the
            # chunked leaf scan observes the token at its next chunk
            # boundary (reference role: ES `_tasks/<id>/_cancel`). Non-DELETE
            # methods fall through (an index named "search" keeps its routes).
            from ..observability.metrics import SEARCH_CANCEL_TOTAL
            from ..search.cancel import CANCEL_REGISTRY
            cancelled = CANCEL_REGISTRY.cancel(
                m.group(1), reason="REST DELETE")
            SEARCH_CANCEL_TOTAL.inc()
            # idempotent: cancelling a finished/unknown query is a no-op,
            # not an error (the race against completion is inherent)
            return 200, {"query_id": m.group(1), "cancelled": cancelled}
        # --- search ----------------------------------------------------
        m = re.fullmatch(r"/api/v1/([^/_][^/]*)/search(?:/stream)?", path)
        if m:
            if method not in ("GET", "POST"):
                raise ApiError(405, f"method {method} not allowed on search")
            index_id = m.group(1)
            if method == "POST" and body:
                payload = json.loads(body)
                params = {**params, **payload}
            default_fields = self._default_fields(index_id)
            request = _search_request_from_params(index_id, params, default_fields)
            if params.get("scroll"):
                ttl = _parse_scroll_ttl(params["scroll"])
                return 200, node.start_scroll(request, ttl)
            response = node.root_searcher.search(request)
            return 200, _search_response_to_json(response)

        # --- ES-compatible --------------------------------------------
        if path.startswith("/api/v1/_elastic"):
            return self._route_elastic(method, path[len("/api/v1/_elastic"):],
                                       params, body)
        raise ApiError(404, f"no route for {method} {path}")

    # ------------------------------------------------------------------
    def _check_ingest_rate(self, body: bytes) -> None:
        from ..common.tower import RateLimitExceeded
        cost = max(len(body), 1)
        if cost > self.ingest_bucket.burst:
            raise ApiError(413, f"ingest body of {cost} bytes exceeds the "
                                f"maximum batch size ({int(self.ingest_bucket.burst)})")
        try:
            self.ingest_bucket.acquire_or_raise(cost=cost)
        except RateLimitExceeded as exc:
            raise ApiError(429, str(exc))

    def _default_fields(self, index_pattern: str):
        # resolve lists/globs the same way the root searcher does, so
        # `logs-*` picks up a real index's default_search_fields. Metastore
        # backend failures propagate to the handler's kind mapping (a
        # metastore outage must not read as 404 not-found). The second
        # resolution inside root.search hits the TTL-cached metastore
        # state, so the cost is an in-memory scan, not another fetch.
        resolved = self.node.root_searcher._resolve_indexes(
            index_pattern.split(","))
        if not resolved:
            # fail on the real problem before query parsing can mask it
            # with a default_search_fields complaint
            raise ApiError(404, f"no index matches {index_pattern!r}")
        return resolved[0].index_config.doc_mapper.default_search_fields

    def _lenient_validator(self, index_pattern: str):
        """`valid(field, value|None)` for ES `query_string.lenient`:
        unknown fields and type-unparsable values become match-none. A
        clause survives if ANY resolved index maps the field validly
        (multi-index patterns: ES evaluates leniency per index)."""
        resolved = self.node.root_searcher._resolve_indexes(
            index_pattern.split(","))
        mappers = [meta.index_config.doc_mapper for meta in resolved]

        def valid(field: str, value) -> bool:
            if not mappers:
                return True
            from ..search.predicate_cache import canonical_query_term
            for mapper in mappers:
                fm = mapper.field(field)
                if fm is None:
                    continue
                if value is None:
                    return True
                try:
                    canonical_query_term(fm, str(value))
                    return True
                except (ValueError, TypeError):
                    continue
            return False

        return valid

    def _route_elastic(self, method: str, path: str, params: dict[str, Any],
                       body: bytes) -> tuple[int, Any]:
        node = self.node
        if path in ("", "/") and method == "GET":
            # ES cluster-info handshake (reference:
            # elasticsearch_api/rest_handler.rs:73 es_compat_cluster_info)
            from .. import __version__
            return 200, {
                "name": node.config.node_id,
                "cluster_name": node.config.cluster_id,
                "cluster_uuid": node.config.cluster_id,
                "tagline": "You Know, for Search",
                "version": {
                    "distribution": "quickwit-tpu",
                    "number": "7.17.0",
                    "build_hash": __version__,
                    "build_date": "2026-01-01T00:00:00Z",
                    "build_snapshot": False,
                    "lucene_version": "8.11.1",
                    "minimum_wire_compatibility_version": "6.8.0",
                    "minimum_index_compatibility_version": "6.0.0-beta1",
                },
            }
        m = re.fullmatch(r"/([^/]+)/_search", path)
        if m:
            payload = json.loads(body) if body else {}
            request = self._es_search_request(m.group(1), payload, params)
            if params.get("scroll"):
                if str(params.get("allow_partial_search_results", "true")
                       ).lower() == "false":
                    return 400, {"status": 400, "error": {
                        "reason": "Invalid argument: Quickwit only supports "
                                  "scroll API with "
                                  "allow_partial_search_results set to true"}}
                ttl = _parse_scroll_ttl(params["scroll"])
                if ttl > 1800:
                    return 400, {"status": 400, "error": {
                        "reason": "Invalid argument: Quickwit only supports "
                                  "scroll TTL period up to 1800 secs"}}
                page = node.start_scroll(request, ttl)
                return 200, self._es_scroll_page(
                    page, page.get("index", m.group(1)))
            response = node.root_searcher.search(request)
            return 200, self._es_search_response(response, request, params)
        if path == "/_search/scroll":
            payload = json.loads(body) if body else {}
            scroll_id = payload.get("scroll_id") or params.get("scroll_id")
            if not scroll_id:
                raise ApiError(400, "missing scroll_id")
            if method == "DELETE":
                # ES clear-scroll accepts a single id or an array of ids
                ids = scroll_id if isinstance(scroll_id, list) else [scroll_id]
                return 200, {"succeeded": all(
                    [node.end_scroll(str(sid)) for sid in ids])}
            if isinstance(scroll_id, list):
                raise ApiError(400, "scroll continuation takes one scroll_id")
            page = node.continue_scroll(scroll_id)
            return 200, self._es_scroll_page(page, page.get("index", ""))
        if path == "/_msearch" and method == "POST":
            lines = [json.loads(line) for line in body.split(b"\n") if line.strip()]
            responses = []
            for i in range(0, len(lines) - 1, 2):
                header, query_body = lines[i], lines[i + 1]
                index = header.get("index", "*")
                index = ",".join(index) if isinstance(index, list) else index
                try:
                    request = self._es_search_request(index, query_body,
                                                      params)
                    response = node.root_searcher.search(request)
                    entry = self._es_search_response(response, request,
                                                     params)
                    entry["status"] = 200
                except ApiError as exc:
                    # per-request failures (e.g. a missing index) ride in
                    # the response array, matching ES msearch semantics
                    if exc.status == 404 and header.get("ignore_unavailable"):
                        entry = {"status": 200, "took": 0,
                                 "timed_out": False,
                                 "hits": {"total": {"value": 0,
                                                    "relation": "eq"},
                                          "hits": []}}
                    else:
                        entry = {"status": exc.status,
                                 "error": {"reason": str(exc)}}
                responses.append(entry)
            return 200, {"responses": responses}
        m = re.fullmatch(r"(?:/([^/]+))?/_bulk", path)
        if m and method == "POST":
            self._check_ingest_rate(body)
            return 200, self._es_bulk(m.group(1), body, params)
        m = re.fullmatch(r"/([^/]+)/_count", path)
        if m and method in ("GET", "POST"):
            payload = json.loads(body) if body else {}
            request = self._es_search_request(m.group(1), payload, params)
            from dataclasses import replace as _dc_replace
            response = node.root_searcher.search(
                _dc_replace(request, max_hits=0, aggs=None))
            return 200, {"count": response.num_hits,
                         "_shards": {"total": 1, "successful": 1,
                                     "skipped": 0, "failed": 0}}
        m = re.fullmatch(r"(?:/([^/_][^/]*))?/_stats", path)
        if m and method == "GET":
            from ..models.split_metadata import SplitState
            pattern = m.group(1)
            indices = {}
            total_docs = total_bytes = total_segments = 0
            for im in sorted(node.metastore.list_indexes(),
                             key=lambda im: im.index_id):
                if pattern and not _matches_index_pattern(im.index_id,
                                                          pattern):
                    continue
                splits = node.metastore.list_splits(
                    ListSplitsQuery(index_uids=[im.index_uid],
                                    states=[SplitState.PUBLISHED]))
                docs = sum(s.metadata.num_docs for s in splits)
                size = sum(s.metadata.footprint_bytes for s in splits)
                total_docs += docs
                total_bytes += size
                total_segments += len(splits)
                stats = {"docs": {"count": docs, "deleted": 0},
                         "store": {"size_in_bytes": size},
                         "segments": {"count": len(splits)}}
                indices[im.index_id] = {"primaries": stats, "total": stats}
            if pattern and not indices and not any(
                    ch in pattern for ch in "*?"):
                # concrete name misses -> 404; an unmatched WILDCARD is an
                # empty 200 (ES allow_no_indices=true default)
                raise ApiError(404, f"no index matches {pattern!r}")
            all_stats = {"docs": {"count": total_docs, "deleted": 0},
                         "store": {"size_in_bytes": total_bytes},
                         "segments": {"count": total_segments}}
            return 200, {"_all": {"primaries": all_stats,
                                  "total": all_stats},
                         "indices": indices}
        m = re.fullmatch(r"/_cat/indices(?:/([^/]+))?", path)
        if m:
            # reference only supports format=json and the h/health params;
            # anything else is a 400
            if params.get("format") != "json":
                raise ApiError(400, "_cat/indices requires format=json")
            unknown = set(params) - {"format", "h", "health"}
            if unknown:
                raise ApiError(400, f"unsupported _cat parameters: "
                                    f"{sorted(unknown)}")
            pattern = m.group(1)
            columns = ([c.strip() for c in params["h"].split(",")]
                       if params.get("h") else None)
            out = []
            for im in sorted(node.metastore.list_indexes(),
                             key=lambda im: im.index_id):
                if pattern and not _matches_index_pattern(im.index_id,
                                                          pattern):
                    continue
                health = "green"
                if params.get("health") and params["health"] != health:
                    continue
                from ..models.split_metadata import SplitState
                splits = node.metastore.list_splits(
                    ListSplitsQuery(index_uids=[im.index_uid],
                                    states=[SplitState.PUBLISHED]))
                num_docs = sum(s.metadata.num_docs for s in splits)
                size = sum(s.metadata.footprint_bytes for s in splits)
                row = {
                    "health": health, "status": "open",
                    "index": im.index_id,
                    "uuid": im.index_uid,
                    "pri": "1", "rep": "0",
                    "docs.count": str(num_docs), "docs.deleted": "0",
                    "dataset.size": _human_size(size),
                    "store.size": _human_size(size),
                    "pri.store.size": _human_size(size),
                }
                if columns:
                    row = {c: row.get(c, "") for c in columns}
                out.append(row)
            return 200, out
        m = re.fullmatch(r"/_resolve/index/([^/]+)", path)
        if m:
            indices = [{"name": im.index_id, "attributes": ["open"]}
                       for im in sorted(node.metastore.list_indexes(),
                                        key=lambda im: im.index_id)
                       if _matches_index_pattern(im.index_id, m.group(1))]
            return 200, {"indices": indices, "aliases": [],
                         "data_streams": []}
        if path == "/_cluster/health":
            return 200, {"cluster_name": node.config.cluster_id,
                         "status": "green", "timed_out": False,
                         "number_of_nodes": len(node.cluster.members())}
        m = re.fullmatch(r"/([^/_][^/]*)", path)
        if m and method == "DELETE":
            # ES delete-index: comma lists; 404 on any missing name unless
            # ignore_unavailable=true
            names = [n for n in m.group(1).split(",") if n]
            known = {im.index_id for im in node.metastore.list_indexes()}
            missing = [n for n in names if n not in known]
            ignore = str(params.get("ignore_unavailable", "false")
                         ).lower() == "true"
            if missing and not ignore:
                raise ApiError(404, f"no such index {missing[0]!r}")
            for name in names:
                if name in known:
                    node.index_service.delete_index(name)
            return 200, {"acknowledged": True}
        if path == "/_field_caps":
            return self._es_field_caps("*", params, body)
        m = re.fullmatch(r"/([^/]+)/_field_caps", path)
        if m:
            return self._es_field_caps(m.group(1), params, body)
        raise ApiError(404, f"no elastic route for {method} {path}")

    # list-fields type class → ES field-caps entry types (reference:
    # elasticsearch_api/model/field_capability.rs:150 — Str expands to
    # keyword AND text entries with the same flags)
    _FIELD_CAPS_TYPES = {"str": ("keyword", "text"), "long": ("long",),
                         "double": ("double",), "boolean": ("boolean",),
                         "date": ("date_nanos",), "ip": ("ip",),
                         "binary": ("binary",)}

    def _es_field_caps(self, index_pattern: str, params: dict[str, Any],
                       body: bytes = b"") -> tuple[int, Any]:
        """ES `_field_caps`, driven by the per-split field registries
        (reference: build_list_field_request_for_es_api +
        convert_to_es_field_capabilities_response). A POST `index_filter`
        prunes splits via its conjunctive tag terms and time bounds;
        empty/invalid filters are 400 like ES."""
        from ..search.list_apis import list_field_entries
        node = self.node
        patterns = index_pattern.split(",")
        known = {im.index_id for im in node.metastore.list_indexes()}
        for p in patterns:
            # concrete (non-wildcard) names must exist; wildcards may
            # match nothing (ES expand_wildcards semantics)
            if p and "*" not in p and "?" not in p and p not in known:
                raise ApiError(404, f"no such index {p!r}")
        filter_ast = None
        if body:
            payload = json.loads(body)
            index_filter = payload.get("index_filter")
            if index_filter is not None:
                if not isinstance(index_filter, dict) or not index_filter:
                    raise ApiError(400, "index_filter must be a non-empty "
                                        "query object")
                try:
                    filter_ast = es_query_to_ast(index_filter)
                except EsDslParseError as exc:
                    raise ApiError(400, f"invalid index_filter: {exc}")
        field_patterns = None
        if params.get("fields"):
            field_patterns = [p.strip()
                              for p in str(params["fields"]).split(",")]
        entries = list_field_entries(
            node.metastore, node.search_service.context,
            patterns, field_patterns=field_patterns,
            filter_ast=filter_ast,
            start_timestamp=(int(params["start_timestamp"])
                             if params.get("start_timestamp") else None),
            end_timestamp=(int(params["end_timestamp"])
                           if params.get("end_timestamp") else None))
        indices = sorted({i for e in entries for i in e["index_ids"]})
        fields: dict[str, dict[str, Any]] = {}
        for e in entries:
            for es_type in self._FIELD_CAPS_TYPES.get(e["type_class"], ()):
                cap = {"metadata_field": False, "type": es_type,
                       "searchable": e["searchable"],
                       "aggregatable": e["aggregatable"]}
                if len(e["index_ids"]) != len(indices):
                    cap["indices"] = sorted(e["index_ids"])
                fields.setdefault(e["field_name"], {})[es_type] = cap
        return 200, {"indices": indices, "fields": fields}

    def _es_search_request(self, index: str, payload: dict[str, Any],
                           params: dict[str, Any]) -> SearchRequest:
        index_ids = index.split(",")
        default_fields = self._default_fields(index)  # full list/pattern
        if params.get("q"):
            # the `q` query-string param overrides any body query
            # (reference: es_compat_index_search semantics)
            ast = parse_query_string(params["q"], default_fields)
        elif "query" in payload:
            ast = es_query_to_ast(payload["query"], default_fields,
                                  self._lenient_validator(index))
        else:
            ast = parse_query_string("*")
        if params.get("extra_filters"):
            # quickwit extension: comma-separated query-string clauses
            # ANDed onto the query (reference: rest_handler extra_filters)
            from ..query.ast import Bool as QBool
            filters = tuple(
                parse_query_string(clause, default_fields)
                for clause in str(params["extra_filters"]).split(",")
                if clause)
            if filters:
                ast = QBool(must=(ast,), filter=filters)
        sort_fields: tuple[SortField, ...] = (SortField(),)
        sort_spec = payload.get("sort")
        if not sort_spec and params.get("sort"):
            # GET-param form: "field:order,field2:order2"
            sort_spec = [
                {part.partition(":")[0]: part.partition(":")[2] or "asc"}
                for part in str(params["sort"]).split(",") if part]
        if sort_spec:
            if isinstance(sort_spec, (str, dict)):
                # single string or single {field: spec} mapping
                sort_spec = [sort_spec] if isinstance(sort_spec, str) else [
                    {k: v} for k, v in sort_spec.items()]
            parsed = []
            for entry in sort_spec[:2]:  # up to two sort keys (reference max)
                if isinstance(entry, str):
                    field_name, _, order = entry.partition(":")
                    parsed.append(SortField(field_name, order or "asc"))
                else:
                    field_name, spec = next(iter(entry.items()))
                    order = (spec.get("order", "asc")
                             if isinstance(spec, dict) else spec)
                    parsed.append(SortField(field_name, order))
            sort_fields = tuple(parsed)
        # ES date sorts exchange epoch MILLIS by default (nanos with
        # format=epoch_nanos_int); internal sort keys are micros
        scales = self._es_sort_scales(index, sort_fields, sort_spec)
        search_after = None
        if payload.get("search_after"):
            marker = payload["search_after"]
            if not isinstance(marker, list):
                raise ApiError(400, "search_after must be an array (a hit's "
                                    "sort array)")
            if payload.get("from") or params.get("from"):
                # ES rejects the combination too; silently applying the
                # offset after the marker would skip docs on every page
                raise ApiError(
                    400, "search_after cannot be combined with from")
            # count the keys as the engine normalizes them (e.g. a _doc
            # secondary folds into the implicit tie-break) so the marker
            # arity matches the sort arrays our own hits emit
            n_keys = len(normalize_sort_fields(tuple(sort_fields)))
            tiebreak = marker[-1] if marker else None
            if (len(marker) == n_keys + 1 and isinstance(tiebreak, str)
                    and "|" in tiebreak):
                split_id, _, doc_id = tiebreak.rpartition("|")
                try:
                    search_after = (list(marker[:n_keys])
                                    + [split_id, int(doc_id)])
                except ValueError:
                    raise ApiError(400, f"malformed shard-doc tiebreak "
                                        f"{tiebreak!r}")
            elif len(marker) == n_keys:
                # value-only marker (no shard-doc tiebreak): ES resumes
                # strictly after the VALUE — docs tying the marker on every
                # key are skipped entirely
                search_after = list(marker) + [None, -1]
            if search_after is not None:
                search_after = ([self._scale_in(v, scales[i] if
                                                i < len(scales) else None)
                                 for i, v in
                                 enumerate(search_after[:n_keys])]
                                + search_after[n_keys:])
            else:
                raise ApiError(
                    400, "search_after must be the hit's sort array "
                         "(sort values, optionally with the trailing "
                         "shard-doc tiebreak emitted in hits.hits[].sort)")
        track_total = payload.get("track_total_hits",
                                   params.get("track_total_hits", True))
        if isinstance(track_total, str):  # query-param form is a string
            track_total = track_total.lower() not in ("false", "0", "no")
        request = SearchRequest(
            index_ids=index_ids,
            query_ast=ast,
            max_hits=int(payload.get("size", params.get("size", 10))),
            start_offset=int(payload.get("from", params.get("from", 0))),
            sort_fields=sort_fields,
            aggs=payload.get("aggs") or payload.get("aggregations"),
            count_hits_exact=track_total is not False,
            search_after=search_after,
            timeout_millis=_parse_es_duration_millis(
                payload.get("timeout", params.get("timeout"))),
            # ES `"profile": true` body flag (query-param form rides along
            # for GET searches)
            profile=bool(payload.get("profile")) or
            str(params.get("profile", "false")).lower()
            in ("true", "1", "yes"),
        )
        request._es_sort_scales = scales  # response-side display scaling
        return request

    def _es_sort_scales(self, index_pattern: str, sort_fields,
                        sort_spec) -> list:
        """Per-sort-key display scale: 'ms' (default ES date exchange
        format), 'ns' (format=epoch_nanos_int), or None (non-date)."""
        try:
            resolved = self.node.root_searcher._resolve_indexes(
                index_pattern.split(","))
            mapper = resolved[0].index_config.doc_mapper if resolved else None
        # qwlint: disable-next-line=QW004 - best-effort mapper lookup for
        # ES sort-scale shims; a failure here just skips scaling and the
        # real resolution error surfaces from the search itself
        except Exception:  # noqa: BLE001 - resolution errors surface later
            mapper = None
        scales = []
        specs = sort_spec if isinstance(sort_spec, list) else []
        for i, sf in enumerate(sort_fields):
            fm = mapper.field(sf.field) if mapper is not None else None
            if fm is None:
                scales.append(None)  # unknown: pass markers through
                continue
            if fm.type.value == "text":
                scales.append("txt")  # never coerce string markers
                continue
            if fm.type.value != "datetime":
                scales.append("num")  # numeric: coerce "5688" like ES
                continue
            fmt = None
            if i < len(specs) and isinstance(specs[i], dict):
                inner = next(iter(specs[i].values()))
                if isinstance(inner, dict):
                    fmt = inner.get("format")
            scales.append("ns" if fmt == "epoch_nanos_int" else "ms")
        return scales

    @staticmethod
    def _scale_in(value, scale):
        """Marker value (exchange format) → internal micros; numeric
        strings coerce like ES."""
        if value is None or isinstance(value, bool):
            return value
        if scale in (None, "txt"):
            return value  # text/unknown sort: markers pass through verbatim
        if isinstance(value, str):
            try:
                value = float(value) if "." in value else int(value)
            except ValueError:
                return value
        if scale == "ms":
            return int(value) * 1000
        if scale == "ns":
            return int(value) // 1000
        return value

    @staticmethod
    def _scale_out(value, scale):
        if value is None or isinstance(value, str) or \
                scale in (None, "txt", "num"):
            return value
        if scale == "ms":
            return int(value) // 1000
        return int(value) * 1000

    @staticmethod
    def _es_scroll_page(page: dict[str, Any], index: str) -> dict[str, Any]:
        """qw scroll page (raw-doc hits) → ES scroll response shape."""
        out = {
            "_scroll_id": page.get("scroll_id", ""),
            "took": page.get("elapsed_time_micros", 0) // 1000,
            "timed_out": False,
            "hits": {
                "total": {"value": page.get("num_hits", 0),
                          "relation": "eq"},
                "hits": [{"_index": index, "_source": doc}
                         for doc in page.get("hits", [])],
            },
        }
        if page.get("aggregations") is not None:
            out["aggregations"] = page["aggregations"]
        return out

    @staticmethod
    def _es_search_response(response, request: SearchRequest,
                            params: Optional[dict[str, Any]] = None
                            ) -> dict[str, Any]:
        includes = excludes = None
        if params:
            includes = _parse_source_param(params.get("_source_includes"))
            excludes = _parse_source_param(params.get("_source_excludes"))
        hits = []
        for hit in response.hits:
            source = hit.doc
            if includes or excludes:
                source = _filter_source(source, includes, excludes)
            entry = {
                "_index": request.index_ids[0],
                "_id": f"{hit.split_id}:{hit.doc_id}",
                "_score": hit.score,
                "_source": source,
            }
            if hit.sort_values:
                # trailing shard-doc tiebreak (role of ES's implicit
                # `_shard_doc` under PIT): feeding the whole array back as
                # `search_after` resumes exactly after this hit, ties incl.
                # Missing sort values stay as null (ES does the same) so a
                # page ending on a missing-value hit still yields a marker.
                scales = getattr(request, "_es_sort_scales", [])
                values = [RestServer._scale_out(
                    v, scales[i] if i < len(scales) else None)
                    for i, v in enumerate(hit.sort_values)]
                entry["sort"] = values + [f"{hit.split_id}|{hit.doc_id}"]
            if hit.snippets:
                entry["highlight"] = hit.snippets
            hits.append(entry)
        relation = "eq" if request.count_hits_exact else "gte"
        out = {
            "took": response.elapsed_time_micros // 1000,
            "timed_out": bool(getattr(response, "timed_out", False)),
            "hits": {
                "total": {"value": response.num_hits, "relation": relation},
                "max_score": max((h.score for h in response.hits
                                  if h.score is not None), default=None),
                "hits": hits,
            },
            **({"aggregations": response.aggregations}
               if response.aggregations is not None else {}),
            # phase waterfall (additive, only when the request asked): the
            # shape is ours, not ES's shard-profile schema — the flag is
            # what is ES-compatible
            **({"profile": response.profile}
               if getattr(response, "profile", None) is not None else {}),
        }
        failed = getattr(response, "failed_splits", None) or []
        if failed:
            # `_shards` is additive: emitted only when failures exist, so
            # fully-successful responses keep their exact historical shape
            attempted = (getattr(response, "num_attempted_splits", 0)
                         or len(failed))
            out["_shards"] = {
                "total": attempted,
                "successful": getattr(response, "num_successful_splits", 0),
                "skipped": 0,
                "failed": len(failed),
                "failures": [
                    {"shard": e.split_id,
                     "reason": {"type": "split_search_error",
                                "reason": e.error}}
                    for e in failed],
            }
        return out

    def _es_bulk(self, default_index: Optional[str], body: bytes,
                 params: dict[str, Any]) -> dict[str, Any]:
        lines = [line for line in body.split(b"\n") if line.strip()]
        docs_by_index: dict[str, list[dict]] = {}
        items = []
        i = 0
        while i < len(lines):
            action = json.loads(lines[i])
            kind = next(iter(action))
            if kind not in ("index", "create"):
                raise ApiError(400, f"unsupported bulk action {kind!r}")
            index = action[kind].get("_index", default_index)
            if index is None:
                raise ApiError(400, "bulk action missing _index")
            doc = json.loads(lines[i + 1])
            docs_by_index.setdefault(index, []).append(doc)
            items.append({kind: {"_index": index, "status": 201}})
            i += 2
        errors = False
        for index, docs in docs_by_index.items():
            try:
                self.node.ingest(index, docs, commit=params.get("refresh", "auto"))
            except MetastoreError as exc:
                errors = True
                for item in items:
                    entry = next(iter(item.values()))
                    if entry["_index"] == index:
                        entry["status"] = 404
                        entry["error"] = str(exc)
        return {"errors": errors, "items": items}


def _matches_index_pattern(index_id: str, pattern: str) -> bool:
    import fnmatch
    return any(fnmatch.fnmatch(index_id, p)
               for p in pattern.split(",") if p)


def _human_size(num_bytes: int) -> str:
    """ES _cat human sizes: 100b / 23.5kb / 1.2mb / 3.4gb."""
    value = float(num_bytes)
    for unit in ("b", "kb", "mb", "gb", "tb"):
        if value < 1024 or unit == "tb":
            if unit == "b":
                return f"{int(value)}b"
            return f"{value:.1f}{unit}"
        value /= 1024.0
    return f"{value:.1f}tb"


def _filter_source(doc: Any, includes: "list[str] | None",
                   excludes: "list[str] | None") -> Any:
    """ES `_source_includes`/`_source_excludes` filtering with dotted
    paths: an include keeps the named subtree (parents materialize along
    the path); excludes remove subtrees and win over includes."""
    def subtree(node: Any, path: list[str]) -> Any:
        if not path or not isinstance(node, dict):
            return node
        if path[0] not in node:
            return _MISSING
        inner = subtree(node[path[0]], path[1:])
        return _MISSING if inner is _MISSING else {path[0]: inner}

    def merge(a: Any, b: Any) -> Any:
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(out[k], v) if k in out else v
            return out
        return b

    out = doc
    if includes:
        out = {}
        for inc in includes:
            part = subtree(doc, inc.split("."))
            if part is not _MISSING:
                out = merge(out, part)
    if excludes:
        def drop(node: Any, path: list[str]) -> Any:
            if not isinstance(node, dict) or not path:
                return node
            if len(path) == 1:
                return {k: v for k, v in node.items() if k != path[0]}
            return {k: (drop(v, path[1:]) if k == path[0] else v)
                    for k, v in node.items()}
        for exc in excludes:
            out = drop(out, exc.split("."))
    return out


_MISSING = object()


def _parse_source_param(value: "str | None") -> "list[str] | None":
    """Accepts `a,b.c` and the bracketed `['a','b']` form clients send."""
    if not value:
        return None
    text = value.strip()
    if text.startswith("["):
        text = text.strip("[]")
        parts = [p.strip().strip("'\"") for p in text.split(",")]
    else:
        parts = [p.strip() for p in text.split(",")]
    return [p for p in parts if p] or None


def _parse_scroll_ttl(text: str) -> float:
    text = text.strip()
    units = {"s": 1, "m": 60, "h": 3600}
    if text and text[-1] in units:
        return float(text[:-1]) * units[text[-1]]
    return float(text)


def _parse_ndjson(body: bytes) -> list[dict]:
    docs = []
    for line in body.split(b"\n"):
        line = line.strip()
        if line:
            docs.append(json.loads(line))
    return docs


def _make_handler(server: RestServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        _handshake_failed = False

        def setup(self):
            import ssl as _ssl
            if isinstance(self.request, _ssl.SSLSocket):
                # deferred TLS handshake, bounded so a silent client ties
                # up only this handler thread, never the accept loop
                try:
                    self.request.settimeout(10.0)
                    self.request.do_handshake()
                    self.request.settimeout(None)
                except (OSError, _ssl.SSLError) as exc:
                    # garbage/plain-HTTP/silent clients: drop quietly
                    logger.debug("tls handshake failed from %s: %s",
                                 self.client_address, exc)
                    self._handshake_failed = True
            super().setup()

        def handle(self):
            if not self._handshake_failed:
                super().handle()

        def log_message(self, fmt, *args):  # quiet
            logger.debug("http: " + fmt, *args)

        def _handle(self, method: str) -> None:
            t0 = time.monotonic()
            parsed = urlparse(self.path)
            params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            extra_headers: dict[str, str] = {}
            try:
                if body and "gzip" in (self.headers.get("Content-Encoding")
                                       or ""):
                    # OTel collectors' otlphttp exporter gzips by default;
                    # ES bulk clients too. Bounded against decompression
                    # bombs.
                    import zlib
                    try:
                        inflater = zlib.decompressobj(
                            wbits=zlib.MAX_WBITS | 16)
                        body = inflater.decompress(body, _MAX_INFLATED_BYTES)
                        if inflater.unconsumed_tail:
                            raise ApiError(413, "decompressed body too large")
                    except zlib.error as exc:
                        raise ApiError(400, f"bad gzip body: {exc}")
                status, payload = server.route(
                    method, parsed.path, params, body,
                    client_host=self.client_address[0],
                    content_type=self.headers.get("Content-Type", ""),
                    traceparent=self.headers.get("traceparent", ""),
                    tenant_id=(self.headers.get(TENANT_HEADER)
                               or self.headers.get(ES_FALLBACK_HEADER)
                               or ""))
            except Exception as exc:  # noqa: BLE001
                code = classify_exception(exc)
                if code is None:
                    logger.exception("internal error on %s %s", method,
                                     parsed.path)
                    status = 500
                    payload = {"message": f"internal error: {exc}"}
                else:
                    status = code
                    if isinstance(exc, ApiError) and exc.payload is not None:
                        payload = exc.payload
                    else:
                        payload = {"message": str(exc)}
                    if isinstance(exc, ApiError):
                        extra_headers = exc.headers
            if (isinstance(payload, tuple) and len(payload) == 3
                    and payload[0] == "__raw__"):
                data = payload[1]
                content_type = payload[2]
            elif (isinstance(payload, tuple) and len(payload) == 2
                    and payload[0] == "__html__"):
                data = payload[1].encode()
                content_type = "text/html; charset=utf-8"
            elif isinstance(payload, str):
                data = payload.encode()
                content_type = "text/plain; version=0.0.4"
            else:
                data = json.dumps(payload).encode()
                content_type = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for name, value in extra_headers.items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)
            _REQUEST_COUNTER.inc(method=method, status=str(status))
            _REQUEST_LATENCY.observe(time.monotonic() - t0)

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

        def do_PUT(self):
            self._handle("PUT")

    return Handler
