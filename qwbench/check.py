"""The comparison that decides `correct`: a sample of the answers the
timed path gave, each against the plain reference's answer to the same
request over the same raw documents.

Numbers compared, each over the whole sample, each with its limit in the
deployment's file (`configs/<config>.json`, `check.limits`):

- `count_wrong`: hit counts, bucket keys and bucket doc counts that differ
  (each one counts), buckets one side lacks, buckets out of order, hits
  returned where none were asked for, and answers that carry errors; and
  of the hits of a request that asks for them, each one missing from or
  extra to min(`max_hits`, hit count), each one whose doc does not match
  the request, each duplicate, each fetched document that differs from
  the raw one; under a score sort, each hit whose reference score lies
  below the reference's k-th best by more than the score tolerance, and
  each pair of consecutive hits out of order by more than it; under a
  field sort, each place where the list differs from the reference's;
- `agg_gap`: the widest relative gap of an aggregated value (averages,
  extrema, sums, percentile estimates);
- `score_gap`, judged only where the deployment's limits name it: the
  widest relative gap between a hit's returned score and the reference's
  float64 score of the same doc. Its limit is also the score tolerance
  above, so a near-tie at the cut may fall either way, and no more.
"""

from __future__ import annotations

import math

NUMBERS = ("count_wrong", "agg_gap")
OPTIONAL = ("score_gap",)


def program_answer(response) -> dict:
    """A `SearchResponse` as the reference's answer is shaped."""
    return {"num_hits": response.num_hits,
            "hits": [{"split_id": h.split_id, "doc_id": h.doc_id,
                      "score": h.score, "doc": h.doc}
                     for h in response.hits],
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


def _below(low: float, high: float, tolerance: float) -> bool:
    """Whether `low` lies below `high` by more than the tolerance."""
    return high - low > tolerance * max(abs(low), abs(high))


def _hits(got: list, want: dict, tally: dict, tolerance: float) -> None:
    """The faults of a request's hits, by the reference's `lookup`."""
    expected = want["hits"]
    tally["count_wrong"] += abs(len(got) - len(expected))
    seen, matched = set(), []
    for hit in got:
        address = (hit["split_id"], hit["doc_id"])
        found = None if address in seen else want["lookup"](*address)
        seen.add(address)
        if found is None:                   # a duplicate, or no match
            tally["count_wrong"] += 1
            continue
        score, doc = found
        if doc is not None and hit["doc"] != doc:
            tally["count_wrong"] += 1
        matched.append((hit, score))
    if want["sort"][0] != "_score":
        tally["count_wrong"] += sum(
            (h["split_id"], h["doc_id"]) != (w["split_id"], w["doc_id"])
            for h, w in zip(got, expected))
        return
    kth = expected[-1]["score"] if expected else 0.0
    for hit, score in matched:
        tally["score_gap"] = max(tally["score_gap"], _rel(hit["score"],
                                                          score))
        if _below(score, kth, tolerance):
            tally["count_wrong"] += 1
    for (_, first), (_, second) in zip(matched, matched[1:]):
        if _below(first, second, tolerance):
            tally["count_wrong"] += 1


def judge(got: dict, want: dict, tally: dict, tolerance: float = 0.0) -> None:
    """Add one answer's faults to `tally` (the numbers above); `tolerance`
    is the score tolerance."""
    if got.get("errors"):
        tally["count_wrong"] += 1
    if got["num_hits"] != want["num_hits"]:
        tally["count_wrong"] += 1
    if "hits" in want:
        _hits(got["hits"], want, tally, tolerance)
    else:
        tally["count_wrong"] += len(got["hits"])
    _aggs(got["aggs"], want["aggs"], tally)


def judged(limits: dict) -> tuple[str, ...]:
    """The numbers a deployment's limits judge."""
    return NUMBERS + tuple(name for name in OPTIONAL if name in limits)


def verdict(tally: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}})."""
    names = judged(limits)
    shown = {name: {"value": tally[name], "limit": limits[name]}
             for name in names}
    ok = all(tally[name] <= limits[name] for name in names)
    return ok, shown


def empty_tally() -> dict:
    return {"count_wrong": 0, "agg_gap": 0.0, "score_gap": 0.0}
