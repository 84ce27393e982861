"""OTLP ingestion + Jaeger-style trace query API.

Roles of the reference's `quickwit-opentelemetry` (`otlp/logs.rs:202`,
`otlp/traces.rs:653`) and `quickwit-jaeger` (`lib.rs:78`): accept OTLP
JSON payloads for logs and traces into well-known indexes
(`otel-logs-v0`, `otel-traces-v0`, auto-created with the reference's doc
mappings), and answer Jaeger HTTP queries (services, operations, trace
lookup, trace search) by translating them into searches — trace search uses
the trace-id collection pattern of `find_trace_ids_collector.rs` (terms over
trace ids ordered by max span timestamp).
"""

from __future__ import annotations

import time
from typing import Any, Optional

OTEL_LOGS_INDEX = "otel-logs-v0"
OTEL_TRACES_INDEX = "otel-traces-v0"

OTEL_LOGS_CONFIG = {
    "index_id": OTEL_LOGS_INDEX,
    "doc_mapping": {
        "field_mappings": [
            {"name": "timestamp", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp", "rfc3339"]},
            {"name": "severity_text", "type": "text", "tokenizer": "raw", "fast": True},
            {"name": "severity_number", "type": "i64", "fast": True},
            {"name": "service_name", "type": "text", "tokenizer": "raw", "fast": True},
            {"name": "body", "type": "text", "record": "position"},
            {"name": "trace_id", "type": "text", "tokenizer": "raw"},
            {"name": "span_id", "type": "text", "tokenizer": "raw"},
        ],
        "timestamp_field": "timestamp",
        "default_search_fields": ["body"],
        "mode": "lenient",
    },
}

OTEL_TRACES_CONFIG = {
    "index_id": OTEL_TRACES_INDEX,
    "doc_mapping": {
        "field_mappings": [
            {"name": "span_start_timestamp", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "trace_id", "type": "text", "tokenizer": "raw", "fast": True},
            {"name": "span_id", "type": "text", "tokenizer": "raw"},
            {"name": "parent_span_id", "type": "text", "tokenizer": "raw"},
            {"name": "service_name", "type": "text", "tokenizer": "raw", "fast": True},
            {"name": "span_name", "type": "text", "tokenizer": "raw", "fast": True},
            {"name": "span_duration_micros", "type": "i64", "fast": True},
            {"name": "span_status", "type": "text", "tokenizer": "raw", "fast": True},
        ],
        "timestamp_field": "span_start_timestamp",
        "default_search_fields": ["span_name"],
        "mode": "lenient",
    },
}


def _nanos_to_seconds(value) -> float:
    return int(value) / 1e9


def _attr_map(attributes: list[dict[str, Any]]) -> dict[str, Any]:
    out = {}
    for attr in attributes or []:
        value = attr.get("value", {})
        for key in ("stringValue", "intValue", "doubleValue", "boolValue"):
            if key in value:  # falsy values (false, 0, "") must survive
                out[attr.get("key", "")] = value[key]
                break
        else:
            out[attr.get("key", "")] = None
    return out


def otlp_logs_to_docs(payload: dict[str, Any]) -> list[dict[str, Any]]:
    """OTLP JSON `resourceLogs` → log docs (reference `otlp/logs.rs`)."""
    docs = []
    for resource_logs in payload.get("resourceLogs", []):
        resource_attrs = _attr_map(
            resource_logs.get("resource", {}).get("attributes", []))
        service = resource_attrs.get("service.name", "unknown_service")
        for scope_logs in resource_logs.get("scopeLogs", []):
            for record in scope_logs.get("logRecords", []):
                body = record.get("body", {})
                docs.append({
                    "timestamp": _nanos_to_seconds(
                        record.get("timeUnixNano")
                        or record.get("observedTimeUnixNano") or 0),
                    "severity_text": record.get("severityText", ""),
                    "severity_number": record.get("severityNumber", 0),
                    "service_name": service,
                    "body": body.get("stringValue", "") if isinstance(body, dict)
                    else str(body),
                    "trace_id": record.get("traceId", ""),
                    "span_id": record.get("spanId", ""),
                    "attributes": _attr_map(record.get("attributes", [])),
                })
    return docs


def _status_str(code: Any) -> str:
    """OTLP Status.code arrives as a proto3 JSON int (0/1/2), the enum
    name (STATUS_CODE_OK), or a bare string from lenient producers."""
    mapping = {0: "unset", 1: "ok", 2: "error",
               "STATUS_CODE_UNSET": "unset", "STATUS_CODE_OK": "ok",
               "STATUS_CODE_ERROR": "error"}
    return mapping.get(code, str(code).lower())


def otlp_traces_to_docs(payload: dict[str, Any]) -> list[dict[str, Any]]:
    """OTLP JSON `resourceSpans` → span docs (reference `otlp/traces.rs`)."""
    docs = []
    for resource_spans in payload.get("resourceSpans", []):
        resource_attrs = _attr_map(
            resource_spans.get("resource", {}).get("attributes", []))
        service = resource_attrs.get("service.name", "unknown_service")
        for scope_spans in resource_spans.get("scopeSpans", []):
            for span in scope_spans.get("spans", []):
                start_nanos = int(span.get("startTimeUnixNano", 0))
                end_nanos = int(span.get("endTimeUnixNano", start_nanos))
                docs.append({
                    "span_start_timestamp": start_nanos / 1e9,
                    "trace_id": span.get("traceId", ""),
                    "span_id": span.get("spanId", ""),
                    "parent_span_id": span.get("parentSpanId", ""),
                    "service_name": service,
                    "span_name": span.get("name", ""),
                    "span_duration_micros": max((end_nanos - start_nanos) // 1000, 0),
                    "span_status": _status_str(
                        (span.get("status", {}) or {}).get("code", "unset")),
                    "attributes": _attr_map(span.get("attributes", [])),
                })
    return docs


class OtelService:
    """Glue: auto-create otel indexes, ingest OTLP payloads, answer
    Jaeger-style queries via the root searcher."""

    def __init__(self, node):
        self.node = node

    def _ensure_index(self, config: dict[str, Any]) -> None:
        from ..metastore.base import MetastoreError
        try:
            self.node.metastore.index_metadata(config["index_id"])
        except MetastoreError:
            self.node.index_service.create_index(config)

    def ingest_logs(self, payload: dict[str, Any]) -> dict[str, Any]:
        self._ensure_index(OTEL_LOGS_CONFIG)
        docs = otlp_logs_to_docs(payload)
        return self.node.ingest(OTEL_LOGS_INDEX, docs)

    def ingest_traces(self, payload: dict[str, Any]) -> dict[str, Any]:
        self._ensure_index(OTEL_TRACES_CONFIG)
        docs = otlp_traces_to_docs(payload)
        return self.node.ingest(OTEL_TRACES_INDEX, docs)

    # --- Jaeger-style reads ------------------------------------------------
    def _traces_index_exists(self) -> bool:
        """Jaeger reads on a node that never ingested a span answer
        empty, not error (the index appears on first OTLP ingest)."""
        from ..metastore.base import MetastoreError
        try:
            self.node.metastore.index_metadata(OTEL_TRACES_INDEX)
            return True
        except MetastoreError:
            return False

    def services(self) -> list[str]:
        from ..query.ast import MatchAll
        from ..search.models import SearchRequest
        if not self._traces_index_exists():
            return []
        response = self.node.root_searcher.search(SearchRequest(
            index_ids=[OTEL_TRACES_INDEX], query_ast=MatchAll(), max_hits=0,
            aggs={"services": {"terms": {"field": "service_name", "size": 1000}}}))
        return sorted(b["key"] for b in
                      response.aggregations["services"]["buckets"])

    def operations(self, service: str) -> list[str]:
        from ..query.ast import Term
        from ..search.models import SearchRequest
        if not self._traces_index_exists():
            return []
        response = self.node.root_searcher.search(SearchRequest(
            index_ids=[OTEL_TRACES_INDEX],
            query_ast=Term("service_name", service), max_hits=0,
            aggs={"ops": {"terms": {"field": "span_name", "size": 1000}}}))
        return sorted(b["key"] for b in response.aggregations["ops"]["buckets"])

    def get_trace(self, trace_id: str) -> list[dict[str, Any]]:
        from ..query.ast import Term
        from ..search.models import SearchRequest, SortField
        response = self.node.root_searcher.search(SearchRequest(
            index_ids=[OTEL_TRACES_INDEX],
            query_ast=Term("trace_id", trace_id), max_hits=1000,
            sort_fields=(SortField("span_start_timestamp", "asc"),)))
        return [h.doc for h in response.hits]

    def jaeger_trace(self, trace_id: str,
                     spans: list[dict[str, Any]]) -> dict[str, Any]:
        """Span docs → the Jaeger UI's trace JSON (jaeger-ui expects
        operationName/startTime-micros/duration/processes — the reference's
        jaeger service emits the same projection, jaeger_api/mod.rs)."""
        processes: dict[str, dict[str, Any]] = {}
        process_of: dict[str, str] = {}
        out_spans = []
        for doc in spans:
            service = doc.get("service_name", "unknown_service")
            pid = process_of.get(service)
            if pid is None:
                pid = process_of[service] = f"p{len(process_of) + 1}"
                processes[pid] = {"serviceName": service, "tags": []}
            tags = [{"key": k, "type": "string", "value": str(v)}
                    for k, v in (doc.get("attributes") or {}).items()]
            status = doc.get("span_status", "unset")
            if status == "error":
                tags.append({"key": "error", "type": "bool", "value": "true"})
            span = {
                "traceID": doc.get("trace_id", trace_id),
                "spanID": doc.get("span_id", ""),
                "operationName": doc.get("span_name", ""),
                "startTime": int(float(doc.get("span_start_timestamp", 0))
                                 * 1_000_000),
                "duration": int(doc.get("span_duration_micros", 0)),
                "processID": pid,
                "tags": tags,
                "references": [],
                "logs": [],
            }
            parent = doc.get("parent_span_id")
            if parent:
                span["references"] = [{"refType": "CHILD_OF",
                                       "traceID": span["traceID"],
                                       "spanID": parent}]
            out_spans.append(span)
        return {"traceID": trace_id, "spans": out_spans,
                "processes": processes, "warnings": None}

    def find_traces(self, service: Optional[str] = None,
                    operation: Optional[str] = None,
                    min_duration_micros: Optional[int] = None,
                    max_duration_micros: Optional[int] = None,
                    tags: "Optional[dict[str, str]]" = None,
                    start_timestamp: Optional[int] = None,
                    end_timestamp: Optional[int] = None,
                    limit: int = 20,
                    span_cache: "Optional[dict]" = None) -> list[str]:
        """Trace ids of matching spans, most-recent first (the
        FindTraceIdsAggregation role: newest max-span-timestamp per trace).

        Tag filters post-filter fetched spans: span attributes live in the
        lenient-mode RAW doc, not in indexed columns, so a trace qualifies
        when at least one of its spans carries ALL requested tags (Jaeger
        semantics; `error=true` matches span_status == "error")."""
        from ..query.ast import Bool, MatchAll, Range, RangeBound, Term
        from ..search.models import SearchRequest, SortField
        must = []
        if service:
            must.append(Term("service_name", service))
        if operation:
            must.append(Term("span_name", operation))
        filters = []
        if min_duration_micros is not None:
            filters.append(Range("span_duration_micros",
                                 lower=RangeBound(min_duration_micros, True)))
        if max_duration_micros is not None:
            filters.append(Range("span_duration_micros",
                                 upper=RangeBound(max_duration_micros, True)))
        ast = Bool(must=tuple(must), filter=tuple(filters)) \
            if (must or filters) else MatchAll()

        def top_trace_ids(size: int) -> "tuple[list[str], bool]":
            # device-side FindTraceIdsAggregation (reference
            # find_trace_ids_collector.rs): a terms aggregation over the
            # trace_id fast column ordered by max span timestamp — the
            # dedup/top-N runs in the bucket kernels, not over fetched docs
            response = self.node.root_searcher.search(SearchRequest(
                index_ids=[OTEL_TRACES_INDEX], query_ast=ast, max_hits=0,
                aggs={"trace_ids": {
                    "terms": {"field": "trace_id", "size": size,
                              "order": {"max_ts": "desc"}},
                    "aggs": {"max_ts": {
                        "max": {"field": "span_start_timestamp"}}}}},
                start_timestamp=start_timestamp, end_timestamp=end_timestamp))
            buckets = (response.aggregations or {}).get(
                "trace_ids", {}).get("buckets", [])
            exhausted = len(buckets) < size
            return [b["key"] for b in buckets if b["key"]], exhausted

        # hard cap: a huge client `limit` (or, below, a never-matching
        # tag) must not widen the terms agg without bound (device
        # allocation) — BOTH the tagged and untagged paths clamp to it
        max_size = 10_000
        # size+1: spans ingested without a traceId bucket under "" and
        # are dropped above — the extra slot keeps `limit` real traces
        # even when the empty bucket ranks in the top N
        if not tags:
            trace_ids, _ = top_trace_ids(min(limit + 1, max_size))
            return trace_ids[:limit]
        # tag post-filtering prunes AFTER the agg, so widen the candidate
        # pool geometrically until `limit` matches or the index runs dry
        # (the cache is request-scoped — passed down, never instance state)
        cache = {} if span_cache is None else span_cache
        size = min(limit * 5 + 1, max_size)
        while True:
            trace_ids, exhausted = top_trace_ids(size)
            matches = [t for t in trace_ids
                       if self._trace_matches_tags(t, tags, cache)]
            if len(matches) >= limit or exhausted or size >= max_size:
                return matches[:limit]
            size = min(size * 4, max_size)

    def find_traces_with_spans(self, **kwargs) -> "list[tuple[str, list]]":
        """find_traces + the span docs of each match, fetching each trace's
        spans at most once across filter + response encoding (the gRPC
        FindTraces streaming path)."""
        cache: dict = {}
        trace_ids = self.find_traces(span_cache=cache, **kwargs)
        return [(t, cache[t] if t in cache else self.get_trace(t))
                for t in trace_ids]

    @staticmethod
    def _tag_value(value: Any) -> str:
        # jaeger clients send "true"/"false" for bool tags; OTLP decoding
        # stores Python bools — normalize both to the wire spelling
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)

    def _trace_matches_tags(self, trace_id: str, tags: "dict[str, str]",
                            cache: dict) -> bool:
        if trace_id not in cache:
            cache[trace_id] = self.get_trace(trace_id)
        for doc in cache[trace_id]:
            attrs = dict(doc.get("attributes") or {})
            if doc.get("span_status") == "error":
                attrs.setdefault("error", "true")
            # exact string match (Jaeger tag semantics), with bools
            # normalized to their lowercase wire spelling
            if all(k in attrs
                   and self._tag_value(attrs[k]) == self._tag_value(v)
                   for k, v in tags.items()):
                return True
        return False
