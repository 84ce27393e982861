"""Search request/response contracts.

Role of the reference's proto messages (`search.proto:205` SearchRequest,
`:360` LeafSearchRequest/Response, `:616` failed_splits) — the wire-stable
seam between root and leaf searchers. JSON-serializable dataclasses here;
gRPC/REST encodings wrap these in `serve/`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..query.ast import QueryAst, ast_from_dict


@dataclass(frozen=True)
class SortField:
    """Sort spec: `field` is a fast field name, or "_score" (BM25 desc by
    default), or "_doc"."""
    field: str = "_score"
    order: str = "desc"  # "asc" | "desc"

    def to_dict(self) -> dict[str, Any]:
        return {"field": self.field, "order": self.order}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SortField":
        return SortField(d.get("field", "_score"), d.get("order", "desc"))


def string_sort_of(request, doc_mapper) -> "Optional[str]":
    """'asc'/'desc' when the request's primary sort is a text FAST field
    (dict-ordinal column) — collectors must then merge by the decoded term
    strings — else None. Must stay in lockstep with the plan's
    `Lowering._is_text_sort` (plan.py): the leaf decides what it RETURNS
    there, this decides how collectors MERGE it."""
    if not request.sort_fields:
        return None
    primary = request.sort_fields[0]
    if primary.field in ("_score", "_doc"):
        return None
    fm = doc_mapper.field(primary.field)
    if fm is None or fm.type.value != "text" or not fm.fast:
        return None
    return primary.order


def normalize_sort_fields(sort_fields: tuple) -> tuple:
    """Drop a `_doc` secondary (doc order is the implicit final tie-break)
    and anything after a `_doc` primary, so the wire request's key count
    matches what the executor actually sorts by (search_after markers align)."""
    if not sort_fields:
        return sort_fields
    if sort_fields[0].field == "_doc":
        return sort_fields[:1]
    if len(sort_fields) > 1 and sort_fields[1].field == "_doc":
        return sort_fields[:1]
    return tuple(sort_fields[:2])


@dataclass
class SearchRequest:
    index_ids: list[str]
    query_ast: QueryAst
    max_hits: int = 20
    start_offset: int = 0
    sort_fields: tuple[SortField, ...] = (SortField(),)
    aggs: Optional[dict[str, Any]] = None          # ES aggs request dict
    start_timestamp: Optional[int] = None          # micros, inclusive
    end_timestamp: Optional[int] = None            # micros, exclusive (reference semantics)
    count_hits_exact: bool = True
    search_after: Optional[list[Any]] = None       # sort values of last hit
    snippet_fields: tuple[str, ...] = ()
    # Wall-clock budget for the whole query (None = server default). NOT part
    # of the leaf-cache key (cache.canonical_request_key): two queries that
    # differ only in budget must share results.
    timeout_millis: Optional[int] = None
    # ES-compatible `"profile": true` flag: return the per-query execution
    # profile (phase waterfall + device counters) in the response. Like
    # timeout_millis, NOT part of the leaf-cache key — profiling must not
    # fragment the cache.
    profile: bool = False
    # Caller-chosen handle for mid-flight cancellation via
    # `DELETE /api/v1/search/<query_id>` (reference role: ES task cancel).
    # Like timeout_millis, NOT part of the leaf-cache key: identity of the
    # in-flight attempt, not of the results.
    query_id: Optional[str] = None

    def __post_init__(self) -> None:
        self.sort_fields = normalize_sort_fields(tuple(self.sort_fields))
        # Count-only degradation (role of the reference's count-optimized
        # leaf path, leaf.rs QuickwitCollector w/ max_hits=0): no hits are
        # returned, so the sort is irrelevant — normalize to doc order.
        # Skips BM25 scoring and sort-column warmup in the executor, and
        # lets count-only requests with different sorts share cache entries.
        # search_after markers are keyed to the original sort, so requests
        # carrying one keep their sort spec (counts are unaffected either way).
        if (self.max_hits == 0 and self.start_offset == 0
                and not self.search_after):
            self.sort_fields = (SortField("_doc", "asc"),)

    def to_dict(self) -> dict[str, Any]:
        return {
            "index_ids": self.index_ids,
            "query_ast": self.query_ast.to_dict(),
            "max_hits": self.max_hits,
            "start_offset": self.start_offset,
            "sort_fields": [s.to_dict() for s in self.sort_fields],
            "aggs": self.aggs,
            "start_timestamp": self.start_timestamp,
            "end_timestamp": self.end_timestamp,
            "count_hits_exact": self.count_hits_exact,
            "search_after": self.search_after,
            "snippet_fields": list(self.snippet_fields),
            **({"timeout_millis": self.timeout_millis}
               if self.timeout_millis is not None else {}),
            **({"profile": True} if self.profile else {}),
            **({"query_id": self.query_id}
               if self.query_id is not None else {}),
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SearchRequest":
        return SearchRequest(
            index_ids=d["index_ids"],
            query_ast=ast_from_dict(d["query_ast"]),
            max_hits=d.get("max_hits", 20),
            start_offset=d.get("start_offset", 0),
            sort_fields=tuple(SortField.from_dict(s) for s in d.get("sort_fields", [{}])),
            aggs=d.get("aggs"),
            start_timestamp=d.get("start_timestamp"),
            end_timestamp=d.get("end_timestamp"),
            count_hits_exact=d.get("count_hits_exact", True),
            search_after=d.get("search_after"),
            snippet_fields=tuple(d.get("snippet_fields", ())),
            timeout_millis=d.get("timeout_millis"),
            profile=d.get("profile", False),
            query_id=d.get("query_id"),
        )


@dataclass(frozen=True)
class PartialHit:
    """Phase-1 hit: address + sort values, no document body
    (reference: `search.proto` PartialHit)."""
    sort_value: float          # primary sort key, already "higher is better"
    split_id: str
    doc_id: int
    raw_sort_value: Any = None  # original-typed value for search_after/display
    sort_value2: float = 0.0   # secondary key (higher-is-better; 0 if unused)
    raw_sort_value2: Any = None

    def address(self) -> tuple[str, int]:
        return (self.split_id, self.doc_id)


@dataclass
class SplitSearchError:
    split_id: str
    error: str
    retryable: bool = True


@dataclass
class LeafSearchResponse:
    """Per-leaf mergeable result (reference: `search.proto` LeafSearchResponse)."""
    num_hits: int = 0
    partial_hits: list[PartialHit] = field(default_factory=list)
    failed_splits: list[SplitSearchError] = field(default_factory=list)
    num_attempted_splits: int = 0
    num_successful_splits: int = 0
    # agg name -> intermediate state dict (kind-specific, numpy-backed)
    intermediate_aggs: dict[str, Any] = field(default_factory=dict)
    resource_stats: dict[str, float] = field(default_factory=dict)
    # Leaf-local execution profile (QueryProfile.to_dict()) when the request
    # asked for one over a remote hop; None for embedded leaves, which write
    # into the root's ambient profile directly.
    profile: Optional[dict[str, Any]] = None


@dataclass
class Hit:
    """Final hit with document body (phase 2)."""
    doc: dict[str, Any]
    score: Optional[float]
    sort_values: list[Any]
    split_id: str
    doc_id: int
    snippets: Optional[dict[str, list[str]]] = None


@dataclass
class SearchResponse:
    num_hits: int = 0
    hits: list[Hit] = field(default_factory=list)
    elapsed_time_micros: int = 0
    errors: list[str] = field(default_factory=list)
    aggregations: Optional[dict[str, Any]] = None
    scroll_id: Optional[str] = None
    # Deadline outcome: True when the query budget expired and this is a
    # partial result. `failed_splits` carries the structured per-split errors
    # (the flat `errors` strings above stay for backward compat).
    timed_out: bool = False
    # Cancellation outcome: True when the query was cancelled mid-flight
    # (REST DELETE or programmatic token) and this is whatever the chunked
    # leaves had accumulated at their last chunk boundary — possibly empty.
    cancelled: bool = False
    failed_splits: list[SplitSearchError] = field(default_factory=list)
    num_attempted_splits: int = 0
    num_successful_splits: int = 0
    # Execution profile (QueryProfile.to_dict()) when the request carried
    # `"profile": true`; additive in to_dict so unprofiled responses keep
    # their shape.
    profile: Optional[dict[str, Any]] = None

    def to_dict(self) -> dict[str, Any]:
        """Reference REST shape (`search_response_rest.rs:43`): hits are the
        raw JSON documents, snippets ride in a parallel array."""
        snippets = ([h.snippets for h in self.hits]
                    if any(h.snippets for h in self.hits) else None)
        return {
            "num_hits": self.num_hits,
            "hits": [h.doc for h in self.hits],
            **({"snippets": snippets} if snippets is not None else {}),
            "elapsed_time_micros": self.elapsed_time_micros,
            "errors": self.errors,
            **({"aggregations": self.aggregations}
               if self.aggregations is not None else {}),
            **({"scroll_id": self.scroll_id} if self.scroll_id else {}),
            # additive keys: only emitted when set, so pre-deadline response
            # shapes stay byte-identical
            **({"timed_out": True} if self.timed_out else {}),
            **({"cancelled": True} if self.cancelled else {}),
            **({"failed_splits": [
                {"split_id": e.split_id, "error": e.error,
                 "retryable": e.retryable} for e in self.failed_splits]}
               if self.failed_splits else {}),
            **({"profile": self.profile} if self.profile is not None else {}),
        }


@dataclass(frozen=True)
class SplitIdAndFooter:
    """What a leaf needs to open a split (reference: SplitIdAndFooterOffsets)."""
    split_id: str
    storage_uri: str   # storage root holding `{split_id}.split`
    file_len: Optional[int] = None
    footer_hint: Optional[int] = None
    num_docs: int = 0
    time_range: Optional[tuple[int, int]] = None  # micros, inclusive

    def to_dict(self) -> dict[str, Any]:
        return {"split_id": self.split_id, "storage_uri": self.storage_uri,
                "file_len": self.file_len, "footer_hint": self.footer_hint,
                "num_docs": self.num_docs,
                "time_range": list(self.time_range) if self.time_range else None}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SplitIdAndFooter":
        tr = d.get("time_range")
        return SplitIdAndFooter(
            d["split_id"], d["storage_uri"], d.get("file_len"),
            d.get("footer_hint"), d.get("num_docs", 0),
            (tr[0], tr[1]) if tr else None)


@dataclass
class LeafSearchRequest:
    """Root → leaf request: search one node's split batch of one index
    (reference: `search.proto` LeafSearchRequest)."""
    search_request: SearchRequest
    index_uid: str
    doc_mapping: dict[str, Any]          # serialized DocMapper
    splits: list[SplitIdAndFooter]
    # Remaining budget at dispatch time, in millis (None = unbounded). The
    # root serializes what is LEFT, not the original timeout, so time spent
    # queued at the root is not silently re-granted to the leaf.
    deadline_millis: Optional[int] = None
    # Resolved tenant (TenantContext.to_wire(): {"id", "class"}) so a remote
    # leaf schedules HBM admission / batching in the same class the root
    # resolved. Additive: absent for tenant-blind traffic. Like
    # deadline_millis, NOT part of the leaf-cache key.
    tenant: Optional[dict[str, Any]] = None
    # Kth sort value already collected elsewhere (INTERNAL higher-is-better
    # encoding, see collector.sort_value_threshold). Seeds the leaf's
    # dynamic-pruning threshold so a root retry's second round can skip
    # splits the first round already beat. Advisory only — a leaf that
    # ignores it returns a superset, never a wrong result.
    sort_value_threshold: Optional[float] = None

    def to_dict(self) -> dict[str, Any]:
        return {"search_request": self.search_request.to_dict(),
                "index_uid": self.index_uid,
                "doc_mapping": self.doc_mapping,
                "splits": [s.to_dict() for s in self.splits],
                **({"deadline_millis": self.deadline_millis}
                   if self.deadline_millis is not None else {}),
                **({"tenant": self.tenant}
                   if self.tenant is not None else {}),
                **({"sort_value_threshold": self.sort_value_threshold}
                   if self.sort_value_threshold is not None else {})}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "LeafSearchRequest":
        return LeafSearchRequest(
            search_request=SearchRequest.from_dict(d["search_request"]),
            index_uid=d["index_uid"],
            doc_mapping=d["doc_mapping"],
            splits=[SplitIdAndFooter.from_dict(s) for s in d["splits"]],
            deadline_millis=d.get("deadline_millis"),
            tenant=d.get("tenant"),
            sort_value_threshold=d.get("sort_value_threshold"))


@dataclass
class FetchDocsRequest:
    """Phase-2 request: fetch document bodies for global top hits
    (reference: `search.proto` FetchDocsRequest)."""
    index_uid: str
    split: SplitIdAndFooter
    doc_ids: list[int]
    snippet_fields: tuple[str, ...] = ()
    query_ast: Optional[QueryAst] = None  # for snippet highlighting

    def to_dict(self) -> dict[str, Any]:
        return {"index_uid": self.index_uid, "split": self.split.to_dict(),
                "doc_ids": self.doc_ids,
                "snippet_fields": list(self.snippet_fields),
                "query_ast": self.query_ast.to_dict() if self.query_ast else None}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FetchDocsRequest":
        return FetchDocsRequest(
            index_uid=d["index_uid"],
            split=SplitIdAndFooter.from_dict(d["split"]),
            doc_ids=d["doc_ids"],
            snippet_fields=tuple(d.get("snippet_fields", ())),
            query_ast=ast_from_dict(d["query_ast"]) if d.get("query_ast") else None)
