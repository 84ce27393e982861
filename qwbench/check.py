"""The comparison that decides `correct`: a sample of the answers the
timed path gave, each against the plain reference's answer to the same
request over the same raw documents.

Numbers compared, each over the whole sample, each with its limit in the
deployment's file (`configs/<config>.json`, `check.limits`):

- `count_wrong`: hit counts, bucket keys and bucket doc counts that differ
  (each one counts), buckets one side lacks, buckets out of order, hits
  returned where none were asked for, and answers that carry errors;
- `agg_gap`: the widest relative gap of an aggregated value (averages,
  extrema, sums, percentile estimates).
"""

from __future__ import annotations

import math

NUMBERS = ("count_wrong", "agg_gap")


def program_answer(response) -> dict:
    """A `SearchResponse` as the reference's answer is shaped."""
    return {"num_hits": response.num_hits,
            "hits": [(h.split_id, h.doc_id) for h in response.hits],
            "aggs": response.aggregations or {},
            "errors": list(response.errors)}


def _rel(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is None and b is None else math.inf
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _aggs(got: dict, want: dict, tally: dict) -> None:
    for name, w in want.items():
        g = got.get(name)
        if not isinstance(g, dict):
            tally["count_wrong"] += 1
            continue
        if "buckets" in w:
            gb = {_key(b["key"]): b for b in g.get("buckets", [])}
            wb = {_key(b["key"]): b for b in w["buckets"]}
            tally["count_wrong"] += len(set(gb) ^ set(wb))
            if [_key(b["key"]) for b in w["buckets"]] != [
                    _key(b["key"]) for b in g.get("buckets", [])
                    if _key(b["key"]) in wb]:
                tally["count_wrong"] += 1            # bucket order
            for key in set(gb) & set(wb):
                if gb[key]["doc_count"] != wb[key]["doc_count"]:
                    tally["count_wrong"] += 1
                subs = {k: v for k, v in wb[key].items()
                        if isinstance(v, dict)}
                _aggs(gb[key], subs, tally)
            if "sum_other_doc_count" in w and g.get(
                    "sum_other_doc_count") != w["sum_other_doc_count"]:
                tally["count_wrong"] += 1
        elif "values" in w:
            gv = {float(k): v for k, v in (g.get("values") or {}).items()}
            for k, v in w["values"].items():
                if float(k) not in gv:
                    tally["count_wrong"] += 1
                    continue
                tally["agg_gap"] = max(tally["agg_gap"],
                                       _rel(gv[float(k)], v))
        else:
            tally["agg_gap"] = max(tally["agg_gap"],
                                   _rel(g.get("value"), w.get("value")))


def _key(key):
    return float(key) if isinstance(key, (int, float)) else key


def judge(got: dict, want: dict, tally: dict) -> None:
    """Add one answer's faults to `tally` (the numbers above)."""
    if got.get("errors"):
        tally["count_wrong"] += 1
    if got["num_hits"] != want["num_hits"]:
        tally["count_wrong"] += 1
    tally["count_wrong"] += len(got["hits"])
    _aggs(got["aggs"], want["aggs"], tally)


def verdict(tally: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}})."""
    shown = {name: {"value": tally[name], "limit": limits[name]}
             for name in NUMBERS}
    ok = all(tally[name] <= limits[name] for name in NUMBERS)
    return ok, shown


def empty_tally() -> dict:
    return {"count_wrong": 0, "agg_gap": 0.0}
