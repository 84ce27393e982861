"""Incremental merge of leaf responses + aggregation finalization.

Role of the reference's `IncrementalCollector` (`collector.rs:1195`) and
root-side `merge_fruits` / `finalize_aggregation` (`root.rs:841,1120`): leaf
responses merge associatively — hit lists by sort key, aggregation states by
bucket key — so the same code runs the segment→split→node→root merge tree at
any level.

Internal hit ordering convention: `PartialHit.sort_value` is float64
"higher is better"; ties break by (split_id, doc_id) ascending, matching the
reference's doc-address tie-break.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..ops.aggs import (PCTL_NUM_BUCKETS, hll_estimate, merge_stats_states,
                        sketch_quantiles)
from ..query.aggregations import DEFAULT_PERCENTS
from .hostdecode import host_array, host_float, host_int, host_list
from .models import LeafSearchResponse, PartialHit


def _hit_order_key(h: PartialHit):
    return (-h.sort_value, -h.sort_value2, h.split_id, h.doc_id)


class _StrKey:
    """Order wrapper for text-sort merging: compares the DECODED term
    strings (per-split ordinals are not cross-split comparable); missing
    values (None) sort last in both directions (ES `missing: _last`)."""

    __slots__ = ("value", "desc")

    def __init__(self, value, desc: bool):
        self.value = value
        self.desc = desc

    def __lt__(self, other: "_StrKey") -> bool:
        a, b = self.value, other.value
        if a is None:
            return False  # None never precedes anything
        if b is None:
            return True
        return a > b if self.desc else a < b

    def __eq__(self, other) -> bool:
        return self.value == other.value


class IncrementalCollector:
    def __init__(self, max_hits: int, start_offset: int = 0,
                 search_after: Optional[tuple] = None,
                 string_sort: Optional[str] = None,
                 string_search_after: Optional[tuple] = None):
        self.max_hits = max_hits
        self.start_offset = start_offset
        self.search_after = search_after  # (sort_value, split_id, doc_id) internal
        # text-sort marker: (raw_term|None, split|None, doc) — filtered on
        # the DECODED strings (per-split ordinals are not comparable)
        self.string_search_after = string_search_after
        # "asc" | "desc" when the primary sort is a text field: merge by
        # raw_sort_value (term string) instead of the split-local float key
        self.string_sort = string_sort
        self.num_hits = 0
        self.failed_splits: list = []
        self.num_attempted_splits = 0
        self.num_successful_splits = 0
        self._hits: list[PartialHit] = []
        self._agg_states: dict[str, Any] = {}
        self.resource_stats: dict[str, float] = {}

    # ------------------------------------------------------------------
    def add_leaf_response(self, leaf: LeafSearchResponse) -> None:
        self.num_hits += leaf.num_hits
        self.failed_splits.extend(leaf.failed_splits)
        self.num_attempted_splits += leaf.num_attempted_splits
        self.num_successful_splits += leaf.num_successful_splits
        for key, value in leaf.resource_stats.items():
            self.resource_stats[key] = self.resource_stats.get(key, 0) + value
        hits = leaf.partial_hits
        if self.string_search_after is not None and self.string_sort:
            raw, m_split, m_doc = self.string_search_after
            desc = self.string_sort == "desc"
            marker = (_StrKey(raw, desc), m_split or "", m_doc)
            if m_split is None:
                hits = [h for h in hits
                        if _StrKey(raw, desc) < _StrKey(h.raw_sort_value,
                                                        desc)]
            else:
                hits = [h for h in hits
                        if marker < (_StrKey(h.raw_sort_value, desc),
                                     h.split_id, h.doc_id)]
        if self.search_after is not None:
            sa_v, sa_v2, sa_split, sa_doc = self.search_after
            if sa_split is None:
                # value-only ES marker: strictly after the value; docs
                # tying the marker on every key are skipped
                hits = [h for h in hits
                        if (-h.sort_value, -h.sort_value2) > (-sa_v, -sa_v2)]
            else:
                hits = [h for h in hits
                        if (-h.sort_value, -h.sort_value2, h.split_id,
                            h.doc_id) > (-sa_v, -sa_v2, sa_split, sa_doc)]
        self._hits.extend(hits)
        keep = self.start_offset + self.max_hits
        if len(self._hits) > 4 * max(keep, 1):
            self._hits.sort(key=self._order_key)
            del self._hits[keep:]
        for name, state in leaf.intermediate_aggs.items():
            self._merge_agg(name, state)

    # ------------------------------------------------------------------
    def _merge_agg(self, name: str, state: dict[str, Any]) -> None:
        current = self._agg_states.get(name)
        if current is None:
            self._agg_states[name] = _copy_state(state)
            return
        kind = state["kind"]
        if kind in ("date_histogram", "histogram"):
            _merge_histogram(current, state)
        elif kind == "terms":
            _merge_terms(current, state)
        elif kind == "range":
            _merge_bucket_maps(current["bucket_map"], _range_to_map(state))
        elif kind == "composite":
            bucket_map = current["bucket_map"]
            for key, bucket in bucket_map.items():
                if isinstance(bucket, int):  # pre-metrics wire shape
                    bucket_map[key] = {"doc_count": bucket, "metrics": {}}
            # buckets (and their nested sub_maps) merge by key tuple with
            # the same machinery every other bucket kind uses
            _merge_bucket_maps(bucket_map, dict(_composite_pairs(state)))
        elif kind == "percentiles":
            current["sketch"] = current["sketch"] + state["sketch"]
        elif kind == "cardinality":
            # HLL registers merge by elementwise max
            current["hll"] = np.maximum(current["hll"], state["hll"])
        else:  # metric state [count,sum,sum_sq,min,max]
            current["state"] = merge_stats_states(current["state"],
                                                  state["state"])

    # ------------------------------------------------------------------
    def _order_key(self, h: PartialHit):
        if self.string_sort is not None:
            return (_StrKey(h.raw_sort_value, self.string_sort == "desc"),
                    h.split_id, h.doc_id)
        return _hit_order_key(h)

    def partial_hits(self) -> list[PartialHit]:
        self._hits.sort(key=self._order_key)
        return self._hits[self.start_offset: self.start_offset + self.max_hits]

    def sort_value_threshold(self) -> Optional[float]:
        """Current Kth internal sort value (higher-is-better), or None when
        the top-K window is not yet full — the dynamic-pruning threshold
        (reference: `CanSplitDoBetter`, leaf.rs:1279).

        A pending split whose best achievable internal key is STRICTLY below
        this value cannot displace any collected hit: an equal primary key
        could still win on the (sort_value2, split_id, doc_id) tie-break, so
        callers must prune on `best < threshold`, never `<=`. Not meaningful
        for text sorts (split-local ordinals aren't comparable to time
        ranges or score bounds) — returns None there.
        """
        if self.string_sort is not None or self.max_hits <= 0:
            return None
        keep = self.start_offset + self.max_hits
        if len(self._hits) < keep:
            return None
        self._hits.sort(key=self._order_key)
        window = self._hits[self.start_offset: keep]
        if len(window) < self.max_hits:
            return None
        return window[-1].sort_value

    def to_leaf_response(self) -> LeafSearchResponse:
        """Re-emit as a leaf response (for tree-merging at the node level)."""
        self._hits.sort(key=self._order_key)
        return LeafSearchResponse(
            num_hits=self.num_hits,
            partial_hits=self._hits[: self.start_offset + self.max_hits],
            failed_splits=self.failed_splits,
            num_attempted_splits=self.num_attempted_splits,
            num_successful_splits=self.num_successful_splits,
            intermediate_aggs=self._agg_states,
            resource_stats=self.resource_stats,
        )

    def aggregation_states(self) -> dict[str, Any]:
        return self._agg_states


# --------------------------------------------------------------------------
# merge helpers: bucket states keyed absolutely so per-split origins align

def _copy_state(state: dict[str, Any]) -> dict[str, Any]:
    kind = state["kind"]
    if kind in ("date_histogram", "histogram"):
        copy = dict(state)
        copy["bucket_map"] = _histogram_to_map(state)
        copy.pop("counts", None)
        copy.pop("metrics", None)
        _carry_sub_info(copy, state)
        return copy
    if kind == "terms":
        copy = dict(state)
        copy["bucket_map"] = _terms_to_map(state)
        copy.pop("counts", None)
        copy.pop("metrics", None)
        copy.pop("keys", None)
        _carry_sub_info(copy, state)
        return copy
    if kind == "range":
        copy = dict(state)
        copy["bucket_map"] = _range_to_map(state)
        copy.pop("counts", None)
        copy.pop("metrics", None)
        return copy
    if kind == "composite":
        copy = dict(state)
        copy["bucket_map"] = dict(_composite_pairs(state))
        copy.pop("buckets", None)
        _carry_sub_info(copy, state)
        return copy
    return dict(state)


def _composite_pairs(state: dict[str, Any]):
    """(key_tuple, bucket) pairs from a leaf state ("buckets" list) or an
    already-merged state ("bucket_map") — wire decode turns tuples into
    lists, so keys re-freeze here. Buckets carry {"doc_count", "metrics"}
    (metric accumulators keyed by name)."""
    metric_kinds = state.get("metric_kinds", {})
    if "bucket_map" in state:
        return [(tuple(k) if isinstance(k, list) else k,
                 {"doc_count": b, "metrics": {}} if isinstance(b, int)
                 else b)
                for k, b in state["bucket_map"].items()]
    out = []
    for entry in state["buckets"]:
        values, count = entry[0], entry[1]
        metrics: dict = {}
        if len(entry) > 2:
            for name, accum in entry[2].items():
                acc = _new_metric_acc(metric_kinds.get(name, "avg"))
                acc.update({k: v for k, v in accum.items()
                            if k in ("sum", "count", "min", "max",
                                     "sum_sq")})
                metrics[name] = acc
        bucket = {"doc_count": count, "metrics": metrics}
        if len(entry) > 3 and state.get("subs"):
            # entry[3] is this bucket's run index into the flattened
            # child states: decode its nested children like any other
            # parent bucket kind
            _attach_sub_maps(bucket, state, host_int(entry[3]))
        out.append((tuple(values), bucket))
    return out


def _composite_order_key(key_tuple):
    """ES composite ordering: ascending per source, null first."""
    return tuple((0, "") if v is None else (1, v) for v in key_tuple)


def _finalize_composite(state: dict[str, Any]) -> dict[str, Any]:
    bucket_map = (state["bucket_map"] if "bucket_map" in state
                  else dict(_composite_pairs(state)))
    if "sub_infos" not in state and state.get("subs"):
        # finalizing a raw (never-merged) leaf state directly
        state = {**state,
                 "sub_infos": [_sub_info_of(s) for s in state["subs"]]}
    ordered = sorted(bucket_map.items(),
                     key=lambda kv: _composite_order_key(kv[0]))
    ordered = ordered[: state["size"]]
    sources = state["sources"]
    buckets = []
    for key_tuple, bucket in ordered:
        if isinstance(bucket, int):  # pre-metrics wire shape
            bucket = {"doc_count": bucket, "metrics": {}}
        key: dict[str, Any] = {}
        for value, info in zip(key_tuple, sources):
            if info["kind"] == "date_histogram" and value is not None:
                value = host_int(value) // 1000  # micros → ES integer ms
            key[info["name"]] = value
        entry = {"key": key, "doc_count": host_int(bucket["doc_count"])}
        for mname, acc in bucket["metrics"].items():
            entry[mname] = _finalize_metric(acc)
        for child_info in (state.get("sub_infos") or ()):
            entry[child_info["name"]] = _finalize_bucket_map(
                bucket.get("sub_maps", {}).get(child_info["name"], {}),
                child_info, child_info.get("sub_infos"))
        buckets.append(entry)
    out: dict[str, Any] = {"buckets": buckets}
    if buckets:
        out["after_key"] = buckets[-1]["key"]
    return out


def _range_to_map(state: dict[str, Any]) -> dict:
    """Range buckets keyed by their static range index (all emitted)."""
    if "bucket_map" in state:  # already-merged state (tree merging at root)
        return _copy_bucket_map(state["bucket_map"])
    counts = host_array(state["counts"])
    out = {}
    for i in range(len(state["ranges"])):
        acc_metrics = {}
        for name, arrays in state.get("metrics", {}).items():
            met_kind = state["metric_kinds"][name]
            acc = _new_metric_acc(
                met_kind, state.get("metric_percents", {}).get(name),
                state.get("metric_keyed", {}).get(name, True))
            _acc_metric(acc, arrays, i)
            acc_metrics[name] = acc
        out[i] = {"doc_count": host_int(counts[i]) if i < len(counts) else 0,
                  "metrics": acc_metrics}
    return out


def _carry_sub_info(copy: dict, state: dict) -> None:
    """Finalization parameters of the nested children, all levels."""
    subs = state.get("subs")
    copy.pop("subs", None)
    if subs:
        copy["sub_infos"] = [_sub_info_of(sub) for sub in subs]


def _sub_info_of(sub: dict) -> dict:
    info = {k: sub.get(k) for k in
            ("name", "kind", "interval", "origin", "min_doc_count",
             "size", "order_desc", "order_target", "extended_bounds",
             "offset")}
    if sub.get("subs"):
        info["sub_infos"] = [_sub_info_of(s) for s in sub["subs"]]
    return info


def _new_metric_acc(kind: str, percents=None, keyed: bool = True) -> dict[str, Any]:
    return {"sum": 0.0, "count": 0, "min": np.inf, "max": -np.inf, "sum_sq": 0.0,
            "kind": kind, "sketch": None, "hll": None, "percents": percents,
            "keyed": keyed}


def _acc_metric(acc: dict[str, Any], arrays: dict[str, np.ndarray], i: int) -> None:
    if "sum" in arrays:
        acc["sum"] += host_float(arrays["sum"][i])
    if "count" in arrays:
        acc["count"] += host_int(arrays["count"][i])
    if "min" in arrays:
        acc["min"] = min(acc["min"], host_float(arrays["min"][i]))
    if "max" in arrays:
        acc["max"] = max(acc["max"], host_float(arrays["max"][i]))
    if "sum_sq" in arrays:
        acc["sum_sq"] += host_float(arrays["sum_sq"][i])
    if "sketch" in arrays:
        row = host_array(arrays["sketch"][i])
        # non-inplace add: accs are shallow-copied by _copy_bucket_map
        acc["sketch"] = row if acc["sketch"] is None else acc["sketch"] + row
    if "hll" in arrays:
        row = host_array(arrays["hll"][i])
        # HLL registers merge by elementwise max (non-inplace, as above)
        acc["hll"] = row if acc.get("hll") is None \
            else np.maximum(acc["hll"], row)


def _copy_bucket_map(bucket_map: dict) -> dict:
    return {key: {"doc_count": b["doc_count"],
                  "metrics": {m: dict(acc) for m, acc in b["metrics"].items()},
                  **({"sub_maps": {n: _copy_bucket_map(m)
                                   for n, m in b["sub_maps"].items()}}
                     if "sub_maps" in b else {})}
            for key, b in bucket_map.items()}


def _sub_key(sub: dict, j: int):
    if sub["kind"] == "terms":
        keys = sub["keys"]
        return keys[j] if j < len(keys) else None
    return sub["origin"] + j * sub["interval"]


def _attach_sub_maps(bucket: dict, state: dict, parent_flat: int) -> None:
    """Nested children of one parent bucket, decoded recursively from the
    flattened mixed-radix device states (child flat index =
    parent_flat * child_nb + child_local)."""
    subs = state.get("subs")
    if not subs:
        return
    sub_maps: dict = {}
    for sub in subs:
        nb = sub["nb"]
        base = parent_flat * nb
        counts = sub["counts"]
        metric_kinds = sub.get("metric_kinds", {})
        metric_percents = sub.get("metric_percents", {})
        metric_keyed = sub.get("metric_keyed", {})
        sub_map: dict = {}
        for j in range(nb):
            flat = base + j
            if flat >= len(counts) or counts[flat] == 0:
                continue
            key = _sub_key(sub, j)
            if key is None:
                continue
            child = {"doc_count": host_int(counts[flat]), "metrics": {}}
            for mname, arrays in sub.get("metrics", {}).items():
                acc = _new_metric_acc(metric_kinds.get(mname, "avg"),
                                      metric_percents.get(mname),
                                      metric_keyed.get(mname, True))
                _acc_metric(acc, arrays, flat)
                child["metrics"][mname] = acc
            _attach_sub_maps(child, sub, flat)
            sub_map[key] = child
        sub_maps[sub["name"]] = sub_map
    bucket["sub_maps"] = sub_maps


def _histogram_to_map(state: dict[str, Any]) -> dict[float, dict[str, Any]]:
    if "bucket_map" in state:  # already-merged state (tree merging at root)
        return _copy_bucket_map(state["bucket_map"])
    counts = state["counts"]
    origin, interval = state["origin"], state["interval"]
    out: dict[float, dict[str, Any]] = {}
    nonzero = np.nonzero(counts)[0] if not state.get("extended_bounds") \
        else np.arange(len(counts))
    metric_kinds = state.get("metric_kinds", {})
    metric_percents = state.get("metric_percents", {})
    metric_keyed = state.get("metric_keyed", {})
    for i in host_list(nonzero):
        key = origin + i * interval
        bucket = {"doc_count": host_int(counts[i]), "metrics": {}}
        for mname, arrays in state.get("metrics", {}).items():
            acc = _new_metric_acc(metric_kinds.get(mname, "avg"),
                                  metric_percents.get(mname),
                                  metric_keyed.get(mname, True))
            _acc_metric(acc, arrays, i)
            bucket["metrics"][mname] = acc
        _attach_sub_maps(bucket, state, i)
        out[key] = bucket
    return out


def _terms_to_map(state: dict[str, Any]) -> dict[Any, dict[str, Any]]:
    if "bucket_map" in state:  # already-merged state (tree merging at root)
        return _copy_bucket_map(state["bucket_map"])
    counts = state["counts"]
    keys = state["keys"]
    metric_kinds = state.get("metric_kinds", {})
    metric_percents = state.get("metric_percents", {})
    metric_keyed = state.get("metric_keyed", {})
    out: dict[Any, dict[str, Any]] = {}
    for i in host_list(np.nonzero(counts)[0]):
        if i >= len(keys):
            continue
        bucket = {"doc_count": host_int(counts[i]), "metrics": {}}
        for mname, arrays in state.get("metrics", {}).items():
            acc = _new_metric_acc(metric_kinds.get(mname, "avg"),
                                  metric_percents.get(mname),
                                  metric_keyed.get(mname, True))
            _acc_metric(acc, arrays, i)
            bucket["metrics"][mname] = acc
        _attach_sub_maps(bucket, state, i)
        out[keys[i]] = bucket
    return out


def _merge_bucket_maps(bucket_map: dict, incoming: dict) -> None:
    for key, bucket in incoming.items():
        cur = bucket_map.get(key)
        if cur is None:
            bucket_map[key] = bucket
            continue
        cur["doc_count"] += bucket["doc_count"]
        for mname, acc in bucket["metrics"].items():
            cacc = cur["metrics"].get(mname)
            if cacc is None:
                cur["metrics"][mname] = acc
            else:
                cacc["sum"] += acc["sum"]
                cacc["count"] += acc["count"]
                cacc["min"] = min(cacc["min"], acc["min"])
                cacc["max"] = max(cacc["max"], acc["max"])
                cacc["sum_sq"] += acc["sum_sq"]
                if acc.get("sketch") is not None:
                    cacc["sketch"] = acc["sketch"] \
                        if cacc.get("sketch") is None \
                        else cacc["sketch"] + acc["sketch"]
                if acc.get("hll") is not None:
                    cacc["hll"] = acc["hll"] \
                        if cacc.get("hll") is None \
                        else np.maximum(cacc["hll"], acc["hll"])
        if "sub_maps" in bucket:
            if "sub_maps" not in cur:
                cur["sub_maps"] = bucket["sub_maps"]
            else:
                for name, sub_map in bucket["sub_maps"].items():
                    if name not in cur["sub_maps"]:
                        cur["sub_maps"][name] = sub_map
                    else:
                        _merge_bucket_maps(cur["sub_maps"][name], sub_map)


def _merge_histogram(current: dict[str, Any], state: dict[str, Any]) -> None:
    _merge_bucket_maps(current["bucket_map"], _histogram_to_map(state))
    if state.get("extended_bounds") and not current.get("extended_bounds"):
        current["extended_bounds"] = state["extended_bounds"]


def _merge_terms(current: dict[str, Any], state: dict[str, Any]) -> None:
    _merge_bucket_maps(current["bucket_map"], _terms_to_map(state))
    if state.get("error_bound"):
        current["error_bound"] = (current.get("error_bound", 0)
                                  + state["error_bound"])
    if state.get("other_docs"):
        current["other_docs"] = (current.get("other_docs", 0)
                                 + state["other_docs"])


# --------------------------------------------------------------------------
# finalization → ES-shaped aggregation results

def _finalize_metric(acc: dict[str, Any]) -> dict[str, Any]:
    kind = acc["kind"]
    count = acc["count"]
    if kind == "cardinality":
        hll = acc.get("hll")
        return {"value": round(hll_estimate(hll)) if hll is not None
                else 0}
    if kind == "value_count":
        return {"value": count}
    if kind == "sum":
        return {"value": acc["sum"]}
    if kind == "avg":
        return {"value": (acc["sum"] / count) if count else None}
    if kind == "min":
        return {"value": acc["min"] if np.isfinite(acc["min"]) else None}
    if kind == "max":
        return {"value": acc["max"] if np.isfinite(acc["max"]) else None}
    if kind == "stats":
        return {
            "count": count, "sum": acc["sum"],
            "min": acc["min"] if np.isfinite(acc["min"]) else None,
            "max": acc["max"] if np.isfinite(acc["max"]) else None,
            "avg": (acc["sum"] / count) if count else None,
        }
    if kind == "extended_stats":
        avg = (acc["sum"] / count) if count else None
        # population variance: E[x^2] - E[x]^2 (ES's default)
        variance = ((acc["sum_sq"] / count - avg * avg)
                    if count else None)
        if variance is not None:
            variance = max(variance, 0.0)
        sampling = (count * variance / (count - 1)
                    if count and count > 1 and variance is not None else None)
        std = variance ** 0.5 if variance is not None else None
        out = {
            "count": count, "sum": acc["sum"],
            "min": acc["min"] if np.isfinite(acc["min"]) else None,
            "max": acc["max"] if np.isfinite(acc["max"]) else None,
            "avg": avg,
            "sum_of_squares": acc["sum_sq"],
            "variance": variance,
            "variance_population": variance,
            "variance_sampling": sampling,
            "std_deviation": std,
            "std_deviation_population": std,
            "std_deviation_sampling":
                sampling ** 0.5 if sampling is not None else None,
        }
        if avg is not None and std is not None:
            out["std_deviation_bounds"] = {
                "upper": avg + 2 * std, "lower": avg - 2 * std,
                "upper_population": avg + 2 * std,
                "lower_population": avg - 2 * std,
                "upper_sampling": (avg + 2 * out["std_deviation_sampling"]
                                   if out["std_deviation_sampling"]
                                   is not None else None),
                "lower_sampling": (avg - 2 * out["std_deviation_sampling"]
                                   if out["std_deviation_sampling"]
                                   is not None else None),
            }
        return out
    if kind == "percentiles":
        percents = acc.get("percents") or DEFAULT_PERCENTS
        sketch = acc.get("sketch")
        if sketch is None:
            sketch = np.zeros(PCTL_NUM_BUCKETS, dtype=np.int32)
        return {"values": _quantile_values(sketch, percents,
                                           acc.get("keyed", True))}
    raise ValueError(f"unknown metric kind {kind}")


def _quantile_values(sketch, percents, keyed: bool = True):
    """ES-shaped percentile values; empty sketches yield null (NaN is not
    valid JSON and ES emits null for empty percentiles). `keyed: false`
    emits the list-of-{key,value} shape."""
    quantiles = sketch_quantiles(sketch, [p / 100.0 for p in percents])
    if keyed:
        return {f"{p:g}": (None if np.isnan(v) else v)
                for p, v in zip(percents, quantiles)}
    return [{"key": host_float(p), "value": (None if np.isnan(v) else v)}
            for p, v in zip(percents, quantiles)]


class _KeyOrd:
    """Typed key ordering for terms `_key` sorts (numbers before their
    string forms never mix: a terms agg's keys share one type)."""

    def __init__(self, key):
        self.key = key

    def __lt__(self, other: "_KeyOrd") -> bool:
        a, b = self.key, other.key
        if isinstance(a, str) or isinstance(b, str):
            return str(a) < str(b)
        return a < b

    def __eq__(self, other) -> bool:
        return self.key == other.key


def _finalize_bucket_map(bucket_map: dict, info: dict[str, Any],
                         sub_infos: Optional[list] = None) -> dict[str, Any]:
    """One bucket map → ES-shaped buckets, recursing into nested children
    at any depth."""
    kind = info["kind"]

    def entry_for(key, bucket, key_scaled):
        entry: dict[str, Any] = {"key": key_scaled,
                                 "doc_count": bucket["doc_count"]}
        if kind == "date_histogram":
            from ..utils.datetime_utils import format_micros_rfc3339
            entry["key_as_string"] = format_micros_rfc3339(host_int(key))
        for mname, acc in bucket["metrics"].items():
            entry[mname] = _finalize_metric(acc)
        for child_info in (sub_infos or ()):
            entry[child_info["name"]] = _finalize_bucket_map(
                bucket.get("sub_maps", {}).get(child_info["name"], {}),
                child_info, child_info.get("sub_infos"))
        return entry

    if kind == "terms":
        min_dc = info.get("min_doc_count")
        min_dc = 1 if min_dc is None else min_dc
        items = [(k, b) for k, b in bucket_map.items()
                 if b["doc_count"] >= min_dc]
        desc = info.get("order_desc", True)
        target = info.get("order_target", "_count")
        if target == "_key":
            items.sort(key=lambda kb: _KeyOrd(kb[0]), reverse=desc)
        elif target != "_count":
            # order by a single-value sub-metric ("m" or "m.max"):
            # missing/NaN metric values sort last in either direction
            metric_name, _, sub_field = target.partition(".")

            def sort_key(kb):
                acc = kb[1]["metrics"].get(metric_name)
                value = None
                if acc is not None:
                    final = _finalize_metric(acc)
                    value = final.get(sub_field or "value")
                    if isinstance(value, float) and np.isnan(value):
                        value = None
                if value is None:
                    return (1, 0, str(kb[0]))
                return (0, -value if desc else value, str(kb[0]))

            items.sort(key=sort_key)
        elif desc:
            items.sort(key=lambda kb: (-kb[1]["doc_count"], str(kb[0])))
        else:  # ES order {"_count": "asc"}: rarest terms first
            items.sort(key=lambda kb: (kb[1]["doc_count"], str(kb[0])))
        size = info.get("size") or 10
        total_other = (sum(b["doc_count"] for _, b in items[size:])
                       + info.get("other_docs", 0))
        return {"buckets": [entry_for(k, b, k) for k, b in items[:size]],
                "sum_other_doc_count": host_int(total_other),
                # nonzero only under split_size truncation: per-split
                # largest-dropped counts summed at merge
                "doc_count_error_upper_bound": host_int(
                    info.get("error_bound", 0))}

    # histograms
    min_dc = info.get("min_doc_count") or 0
    interval = info["interval"]
    bounds = info.get("extended_bounds")
    keys = sorted(bucket_map)
    if keys and min_dc == 0:
        # ES semantics: empty buckets are materialized across the observed
        # range (and any extended_bounds) when min_doc_count=0
        lo, hi = keys[0], keys[-1]
        if bounds and kind == "date_histogram":
            offset = info.get("offset", 0) or 0
            lo = min(lo, ((bounds[0] - offset) // interval) * interval
                     + offset)
            hi = max(hi, ((bounds[1] - offset) // interval) * interval
                     + offset)
        num = host_int(round((hi - lo) / interval)) + 1
        # leaf planning caps per-split ranges, but the merged range across
        # splits/nodes with disjoint time ranges can be far wider — apply
        # the AggregationLimitsGuard cap here too, like the reference does
        # at every merge level
        from .plan import MAX_BUCKETS
        if num > MAX_BUCKETS:
            raise ValueError(
                f"aggregation would materialize {num} buckets at merge "
                f"(max {MAX_BUCKETS}); raise the interval or set "
                f"min_doc_count>=1")
        keys = [lo + i * interval for i in range(num)]
    buckets = []
    for key in keys:
        bucket = bucket_map.get(key, {"doc_count": 0, "metrics": {}})
        if bucket["doc_count"] < min_dc:
            continue
        scaled = key / 1000.0 if kind == "date_histogram" else key
        buckets.append(entry_for(key, bucket, scaled))
    return {"buckets": buckets}


def finalize_aggregations(agg_states: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, state in agg_states.items():
        if "bucket_map" not in state and state["kind"] in (
                "date_histogram", "histogram", "terms", "range"):
            state = _copy_state(state)
        kind = state["kind"]
        if kind in ("date_histogram", "histogram", "terms"):
            out[name] = _finalize_bucket_map(
                state["bucket_map"], state,
                sub_infos=state.get("sub_infos"))
        elif kind == "range":
            buckets = []
            for i, (key, lo, hi) in enumerate(state["ranges"]):
                bucket = state["bucket_map"].get(
                    i, {"doc_count": 0, "metrics": {}})
                entry: dict[str, Any] = {"key": key,
                                         "doc_count": bucket["doc_count"]}
                if lo is not None:
                    entry["from"] = lo
                if hi is not None:
                    entry["to"] = hi
                for mname, acc in bucket["metrics"].items():
                    entry[mname] = _finalize_metric(acc)
                buckets.append(entry)
            out[name] = {"buckets": buckets}
        elif kind == "composite":
            out[name] = _finalize_composite(state)
        elif kind == "percentiles":
            out[name] = {"values": _quantile_values(
                state["sketch"], state["percents"],
                state.get("keyed", True))}
        elif kind == "cardinality":
            from ..ops.aggs import hll_estimate
            out[name] = {"value": round(hll_estimate(state["hll"]))}
        else:
            c, s, s2, mn, mx = state["state"]
            acc = {"kind": kind, "count": host_int(c),
                   "sum": host_float(s), "sum_sq": host_float(s2),
                   "min": host_float(mn), "max": host_float(mx)}
            out[name] = _finalize_metric(acc)
    return out
