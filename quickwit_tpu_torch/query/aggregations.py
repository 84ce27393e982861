"""Aggregation request model (ES-compatible subset).

Role of the reference's aggregation proxy types (`quickwit-query/src/
aggregations.rs` + tantivy's aggregation request JSON): parses the ES
`aggs` request dict into typed specs the leaf executor lowers onto columnar
kernels (`ops/aggs.py`).

Supported: date_histogram (fixed_interval), histogram, terms, range,
composite (terms/histogram/date_histogram sources, after-pagination,
missing_bucket), avg/min/max/sum/stats/extended_stats/value_count,
percentiles, cardinality. Sub-aggregations: metrics (percentiles
included) under buckets at ANY depth, with ARBITRARY bucket nesting —
multiple sibling bucket children per level, each chain flattened into a
mixed-radix device bucket space (reference: tantivy's recursive
aggregation tree, collector.rs:523). Composite takes metric sub-aggs
(segment-reduced per run on device); range accepts metrics but no
bucket children.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

_INTERVAL_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_INTERVAL_MICROS = {"ms": 1_000, "s": 1_000_000, "m": 60_000_000,
                    "h": 3_600_000_000, "d": 86_400_000_000}


class AggParseError(ValueError):
    pass


def parse_interval_micros(text: str) -> int:
    m = _INTERVAL_RE.match(text.strip())
    if not m:
        raise AggParseError(f"unsupported interval {text!r} (use e.g. 30s, 5m, 1d)")
    return int(float(m.group(1)) * _INTERVAL_MICROS[m.group(2)])


DEFAULT_PERCENTS = (1, 5, 25, 50, 75, 95, 99)


@dataclass(frozen=True)
class MetricAgg:
    name: str
    kind: str          # avg | min | max | sum | stats | value_count | percentiles
    field: str
    percents: tuple[float, ...] = DEFAULT_PERCENTS
    keyed: bool = True  # percentiles output shape (ES `keyed` param)


@dataclass(frozen=True)
class DateHistogramAgg:
    name: str
    field: str
    interval_micros: int
    min_doc_count: int = 0
    extended_bounds: Optional[tuple[int, int]] = None  # micros
    offset_micros: int = 0  # ES `offset`: shifts bucket boundaries
    sub_metrics: tuple[MetricAgg, ...] = ()
    sub_buckets: tuple["AggSpec", ...] = ()


@dataclass(frozen=True)
class RangeAgg:
    """ES range aggregation: explicit [from, to) buckets, all emitted."""
    name: str
    field: str
    ranges: tuple[tuple[str, Optional[float], Optional[float]], ...]
    sub_metrics: tuple[MetricAgg, ...] = ()


@dataclass(frozen=True)
class HistogramAgg:
    name: str
    field: str
    interval: float
    min_doc_count: int = 0
    sub_metrics: tuple[MetricAgg, ...] = ()
    sub_buckets: tuple["AggSpec", ...] = ()


@dataclass(frozen=True)
class TermsAgg:
    name: str
    field: str
    size: int = 10
    min_doc_count: int = 1
    order_by_count_desc: bool = True
    # ES terms ordering target: "_count" (default), "_key", or the name
    # of a single-value sub-metric ("m" or "m.max" for stats fields)
    order_target: str = "_count"
    # per-split truncation (reference/tantivy `split_size`/`shard_size`):
    # each split forwards only its top-N buckets; the merge reports
    # doc_count_error_upper_bound accordingly. None = exact.
    split_size: Optional[int] = None
    sub_metrics: tuple[MetricAgg, ...] = ()
    sub_buckets: tuple["AggSpec", ...] = ()


@dataclass(frozen=True)
class CompositeSource:
    """One source of a composite aggregation key tuple."""
    name: str
    kind: str                     # "terms" | "histogram" | "date_histogram"
    field: str
    interval: float = 0.0         # histogram
    interval_micros: int = 0      # date_histogram
    missing_bucket: bool = False  # honored on every source kind (as in ES)


@dataclass(frozen=True)
class CompositeAgg:
    """ES composite aggregation: paginated buckets over multi-source key
    tuples in ascending lexicographic key order (`after` resumes strictly
    past a key tuple)."""
    name: str
    sources: tuple[CompositeSource, ...]
    size: int = 10
    after: Optional[tuple[Any, ...]] = None  # decoded per-source values
    sub_metrics: tuple[MetricAgg, ...] = ()
    sub_buckets: tuple["AggSpec", ...] = ()


AggSpec = Any  # union of the dataclasses above


_METRIC_KINDS = ("avg", "min", "max", "sum", "stats", "extended_stats",
                 "value_count", "percentiles", "cardinality")


def _parse_metric(name: str, kind: str, body: dict[str, Any]) -> MetricAgg:
    if not isinstance(body, dict):
        raise AggParseError(
            f"aggregation {name!r}: {kind} body must be an object")
    if "field" not in body:
        raise AggParseError(f"aggregation {name!r}: metric {kind} requires a field")
    if not isinstance(body.get("field"), str):
        raise AggParseError(
            f"aggregation {name!r}: field must be a string")
    raw_percents = body.get("percents", DEFAULT_PERCENTS)
    if not isinstance(raw_percents, (list, tuple)) or not all(
            isinstance(p, (int, float)) and not isinstance(p, bool)
            for p in raw_percents):
        raise AggParseError(
            f"aggregation {name!r}: percents must be a list of numbers")
    return MetricAgg(name=name, kind=kind, field=body["field"],
                     percents=tuple(float(p) for p in raw_percents),
                     keyed=body.get("keyed", True))


_BUCKET_KINDS = ("date_histogram", "histogram", "terms", "range")


def _parse_sub_aggs(name: str, sub: dict[str, Any], depth: int = 0):
    """(metrics, sub_buckets). Bucket children may nest arbitrarily deep
    and have siblings; the product of bucket counts along each chain is
    capped at lowering time (MAX_BUCKETS)."""
    metrics = []
    sub_buckets = []
    for sub_name, sub_body in sub.items():
        sub_kind = _agg_kind(sub_body)
        if sub_kind in _METRIC_KINDS:
            metrics.append(_parse_metric(sub_name, sub_kind, sub_body[sub_kind]))
        elif sub_kind == "range":
            # range buckets may overlap, so they have no single per-doc
            # bucket index to extend the mixed-radix space with
            raise AggParseError(
                f"aggregation {name!r}: range cannot nest under bucket "
                "aggregations")
        elif sub_kind in _BUCKET_KINDS:
            sub_buckets.append(_parse_one(sub_name, sub_body, depth=depth + 1))
        else:
            raise AggParseError(
                f"aggregation {name!r}: unsupported sub-aggregation {sub_kind}")
    return tuple(metrics), tuple(sub_buckets)


def _agg_kind(body: dict[str, Any]) -> str:
    kinds = [k for k in body if k not in ("aggs", "aggregations", "meta")]
    if len(kinds) != 1:
        raise AggParseError(f"aggregation body must have exactly one kind, got {kinds}")
    return kinds[0]


def _parse_one(name: str, body: dict[str, Any], depth: int = 0) -> AggSpec:
    if not isinstance(body, dict):
        raise AggParseError(
            f"aggregation {name!r} must be an object")
    kind = _agg_kind(body)
    params = body[kind]
    if kind not in _METRIC_KINDS and not isinstance(params, dict):
        # metric bodies are validated in _parse_metric; bucket bodies
        # must be objects too (ES rejects {"terms": 7} the same way)
        raise AggParseError(
            f"aggregation {name!r}: {kind} body must be an object")
    sub = body.get("aggs") or body.get("aggregations") or {}
    if not isinstance(sub, dict):
        raise AggParseError(
            f"aggregation {name!r}: nested aggs must be an object")
    sub_metrics, sub_buckets = _parse_sub_aggs(name, sub, depth)
    if kind == "date_histogram":
        interval = params.get("fixed_interval") or params.get("interval")
        if interval is None:
            raise AggParseError(f"date_histogram {name!r} requires fixed_interval")
        bounds = None
        if "extended_bounds" in params:
            # ES extended_bounds for date_histogram are epoch MILLISECONDS;
            # bounds_unit="micros" is the internal escape hatch
            b = params["extended_bounds"]
            scale = 1 if params.get("bounds_unit") == "micros" else 1000
            bounds = (int(b["min"]) * scale, int(b["max"]) * scale)
        offset = 0
        if params.get("offset"):
            text = str(params["offset"]).strip()
            sign = -1 if text.startswith("-") else 1
            offset = sign * parse_interval_micros(text.lstrip("+-"))
        return DateHistogramAgg(
            name=name, field=params["field"],
            interval_micros=parse_interval_micros(interval),
            min_doc_count=params.get("min_doc_count", 0),
            extended_bounds=bounds, offset_micros=offset,
            sub_metrics=sub_metrics, sub_buckets=sub_buckets)
    if kind == "histogram":
        return HistogramAgg(
            name=name, field=params["field"], interval=float(params["interval"]),
            min_doc_count=params.get("min_doc_count", 0),
            sub_metrics=sub_metrics, sub_buckets=sub_buckets)
    if kind == "terms":
        order = params.get("order", {"_count": "desc"})
        if not isinstance(order, dict) or len(order) != 1:
            raise AggParseError(
                f"terms aggregation {name!r}: order must be a single-entry "
                "map like {\"_count\": \"desc\"}")
        order_target, order_dir = next(iter(order.items()))
        if order_dir not in ("asc", "desc"):
            raise AggParseError(
                f"terms aggregation {name!r}: order direction must be "
                "asc or desc")
        if order_target not in ("_count", "_key"):
            # the target must resolve to ONE value (ES rejects anything
            # else with a 400; degrading silently would reorder wrong)
            metric_root, _, sub_field = order_target.partition(".")
            metric = next((m for m in sub_metrics
                           if m.name == metric_root), None)
            if metric is None:
                raise AggParseError(
                    f"terms aggregation {name!r}: order target "
                    f"{order_target!r} is not a sub-aggregation")
            single_value = ("avg", "min", "max", "sum", "value_count",
                            "cardinality")
            stats_fields = ("min", "max", "avg", "sum", "count",
                            "sum_of_squares", "variance", "std_deviation")
            if sub_field:
                if metric.kind not in ("stats", "extended_stats") \
                        or sub_field not in stats_fields:
                    raise AggParseError(
                        f"terms aggregation {name!r}: order target "
                        f"{order_target!r} does not resolve to a single "
                        "value")
            elif metric.kind not in single_value:
                raise AggParseError(
                    f"terms aggregation {name!r}: ordering by "
                    f"{metric.kind} requires a field path like "
                    f"\"{metric_root}.max\"")
        split_size = params.get("split_size", params.get(
            "shard_size", params.get("segment_size")))
        return TermsAgg(
            name=name, field=params["field"], size=params.get("size", 10),
            min_doc_count=params.get("min_doc_count", 1),
            order_by_count_desc=order_dir == "desc",
            order_target=order_target,
            split_size=int(split_size) if split_size is not None else None,
            sub_metrics=sub_metrics, sub_buckets=sub_buckets)
    if kind == "range":
        ranges = []
        for r in params.get("ranges", ()):
            lo = float(r["from"]) if "from" in r else None
            hi = float(r["to"]) if "to" in r else None
            key = r.get("key")
            if key is None:  # ES auto key: "from-to" with * for open ends
                key = f"{lo if lo is not None else '*'}-" \
                      f"{hi if hi is not None else '*'}"
            ranges.append((str(key), lo, hi))
        if not ranges:
            raise AggParseError(f"range aggregation {name!r} needs ranges")
        if sub_buckets:
            raise AggParseError(
                f"range aggregation {name!r}: nested bucket aggs under "
                "range are not supported yet")
        return RangeAgg(name=name, field=params["field"],
                        ranges=tuple(ranges), sub_metrics=sub_metrics)
    if kind == "composite":
        if depth > 0:
            raise AggParseError(
                f"composite aggregation {name!r} must be top-level")
        for metric in sub_metrics:
            if metric.kind in ("percentiles", "cardinality"):
                raise AggParseError(
                    f"composite aggregation {name!r}: {metric.kind} under "
                    "composite is not supported yet")
        return _parse_composite(name, params, sub_metrics, sub_buckets)
    if kind in _METRIC_KINDS:
        if sub_metrics or sub_buckets:
            raise AggParseError(f"metric aggregation {name!r} cannot have sub-aggs")
        return _parse_metric(name, kind, params)
    raise AggParseError(f"unsupported aggregation kind {kind!r}")


def _decode_after_value(value: Any, source_kind: str) -> Any:
    """Accept both plain ES after values and tantivy's type-prefixed form
    (`str:x`, `f64:1`, `i64:1`, `u64:1`) emitted by the reference.

    Decoding is source-kind-aware so a plain value is never misread:
    histogram sources take numbers (a bare string must be the typed form);
    terms sources keep strings as-is except the unambiguous prefixes —
    a term field legitimately holding "i64:42" still pages correctly
    because the numeric coercion is re-checked against the dictionary
    type at lowering (plan.py)."""
    if not isinstance(value, str):
        return value
    if source_kind in ("histogram", "date_histogram"):
        for prefix in ("f64:", "i64:", "u64:"):
            if value.startswith(prefix):
                return float(value[len(prefix):])
        try:
            return float(value)
        except ValueError:
            raise AggParseError(
                f"composite after value {value!r} is not numeric for a "
                f"{source_kind} source")
    if value.startswith("str:"):
        return value[4:]
    for prefix in ("f64:",):
        if value.startswith(prefix):
            return float(value[len(prefix):])
    for prefix in ("i64:", "u64:"):
        if value.startswith(prefix):
            return int(value[len(prefix):])
    return value


def _parse_composite(name: str, params: dict[str, Any],
                     sub_metrics: tuple = (),
                     sub_buckets: tuple = ()) -> "CompositeAgg":
    raw_sources = params.get("sources")
    if not raw_sources or not isinstance(raw_sources, list):
        raise AggParseError(
            f"composite aggregation {name!r} requires a sources list")
    sources = []
    for entry in raw_sources:
        if not isinstance(entry, dict) or len(entry) != 1:
            raise AggParseError(
                f"composite {name!r}: each source must be "
                "{name: {kind: {...}}}")
        src_name, src_body = next(iter(entry.items()))
        src_kind = _agg_kind(src_body)
        src_params = src_body[src_kind]
        if src_kind not in ("terms", "histogram", "date_histogram"):
            raise AggParseError(
                f"composite {name!r}: unsupported source kind {src_kind!r}")
        order = src_params.get("order", "asc")
        if order != "asc":
            raise AggParseError(
                f"composite {name!r}: descending source order is not "
                "supported yet")
        if "field" not in src_params:
            raise AggParseError(
                f"composite {name!r}: source {src_name!r} requires a field")
        interval = 0.0
        interval_micros = 0
        if src_kind == "histogram":
            interval = float(src_params["interval"])
            if interval <= 0:
                raise AggParseError(
                    f"composite {name!r}: histogram interval must be > 0")
        elif src_kind == "date_histogram":
            text = (src_params.get("fixed_interval")
                    or src_params.get("interval"))
            if text is None:
                raise AggParseError(
                    f"composite {name!r}: date_histogram source requires "
                    "fixed_interval")
            interval_micros = parse_interval_micros(text)
        sources.append(CompositeSource(
            name=src_name, kind=src_kind, field=src_params["field"],
            interval=interval, interval_micros=interval_micros,
            missing_bucket=bool(src_params.get("missing_bucket", False))))
    after = None
    if "after" in params:
        raw_after = params["after"]
        if not isinstance(raw_after, dict):
            raise AggParseError(f"composite {name!r}: after must be a map")
        missing = [s.name for s in sources if s.name not in raw_after]
        if missing:
            raise AggParseError(
                f"composite {name!r}: after is missing sources {missing}")
        after = tuple(_decode_after_value(raw_after[s.name], s.kind)
                      for s in sources)
    size = int(params.get("size", 10))
    if size < 1 or size > 4096:
        raise AggParseError(
            f"composite {name!r}: size must be in [1, 4096]")
    return CompositeAgg(name=name, sources=tuple(sources), size=size,
                        after=after, sub_metrics=sub_metrics,
                        sub_buckets=sub_buckets)


def parse_aggs(aggs: dict[str, Any]) -> list[AggSpec]:
    """ES `aggs` dict → typed specs."""
    if not isinstance(aggs, dict):
        raise AggParseError("aggs must be an object")
    return [_parse_one(name, body) for name, body in aggs.items()]
