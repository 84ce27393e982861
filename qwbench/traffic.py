"""The one traffic generator: it reads a mix's parameters
(`traffic/<mix>.json`), draws the requests a run offers and when each is
due, as plain request specs (the ES query DSL, aggregations, time bounds),
and drives the system under test with them in an open loop: each request
is sent when it is due, whatever came back before.

The run's seed orders the traffic, and every seed offers the same work:
the laws are sampled at fixed quantiles, and the seed permutes the
samples and the gaps between arrivals (a Poisson mix) or draws when the
staggered dashboards first refresh and the order of their panels (a
refresh mix).

A Poisson mix:

    {"loop": "poisson", "rate_qps": 3,
     "warmup": {"per_kind": 4, "seconds": 2},
     "kinds": [{"name": ..., "weight": ...,
                "draws": {"<var>": {"law": ..., ...}},
                "request": {"query": {...}, "max_hits": 10, "aggs": {...},
                            "start_timestamp": "$<var>.from_us", ...}}]}

Laws: `time_range` (`lengths_s`, `align_s`: a range on a grid inside the
corpus's span, `{"from_us", "to_us"}`); `query_terms` (`field`, `count`:
the least and the most terms a query, `zipf_s`, `top`: distinct terms
drawn under Zipf(`zipf_s`) from the field's `top` most frequent, named by
the corpus's `term_name(config, field, rank)`, `{"text": "w1 w2 ..."}`
for a `match` query).

A refresh mix, dashboards on a fixed auto-refresh interval, each refresh
sending all of the dashboard's panels at once over one shared range that
ends "now"; "now" runs along the corpus's last seconds with the run's
clock and reaches the corpus's end as the window closes:

    {"loop": "refresh", "refresh_s": 10,
     "dashboards": [{"name": "last-15m", "range_s": 900}, ...],
     "warmup": {"rounds": 1, "seconds": 3},
     "panels": [{"name": ..., "request": {...,
                 "start_timestamp": "$range.from_us",
                 "end_timestamp": "$range.to_us"}}]}

A string `"$var"` or `"$var.key"` anywhere in a request takes the drawn
value.
"""

from __future__ import annotations

import copy
import math
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from . import cells
from .corpus.common import sub_seed


def _rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def _fixed_counts(weights: list[float], n: int) -> list[int]:
    raw = [w * n / sum(weights) for w in weights]
    counts = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[
            :n - sum(counts)]:
        counts[i] += 1
    return counts


def _law_values(law: dict, m: int, config: dict, rng) -> list:
    """m values of one law at its fixed quantiles, in the seed's order."""
    q = (np.arange(m) + 0.5) / max(m, 1)
    kind = law["law"]
    if kind == "time_range":
        start, span = config["start_ts"], config["span_seconds"]
        lengths = [law["lengths_s"][i % len(law["lengths_s"])]
                   for i in range(m)]
        where = q[rng.permutation(m)]     # positions apart from lengths
        values = []
        for length, at in zip(lengths, where):
            slots = (span - length) // law["align_s"] + 1
            lo_s = start + int(at * slots) * law["align_s"]
            values.append({"from_us": lo_s * 1_000_000,
                           "to_us": (lo_s + length) * 1_000_000})
    elif kind == "query_terms":
        values = _query_terms(law, m, config, q, rng)
    else:
        raise ValueError(f"unknown law {kind!r}")
    return [values[i] for i in rng.permutation(m)]


def _query_terms(law: dict, m: int, config: dict, q: np.ndarray,
                 rng) -> list[dict]:
    """m queries' texts: each query's term count at fixed quantiles of
    [least, most], the terms' ranks at fixed quantiles of the Zipf law
    over the `top` ranks, dealt to the queries in the seed's order; a rank
    that a query already holds moves to the next one it does not."""
    least, most = law["count"]
    counts = least + np.floor(q * (most - least + 1)).astype(int)
    top = law["top"]
    cdf = np.cumsum((np.arange(top) + 1.0) ** -law["zipf_s"])
    n = int(counts.sum())
    ranks = np.minimum(np.searchsorted(cdf / cdf[-1],
                                       (np.arange(n) + 0.5) / n), top - 1)
    ranks = ranks[rng.permutation(n)]
    corpus = cells.corpus_module(config)
    values, at = [], 0
    for count in counts:
        held = []
        for rank in ranks[at:at + count]:
            rank = int(rank)
            while rank in held:
                rank = (rank + 1) % top
            held.append(rank)
        at += count
        values.append({"text": " ".join(
            corpus.term_name(config, law["field"], r) for r in held)})
    return values


def _substitute(node, drawn: dict):
    if isinstance(node, dict):
        return {k: _substitute(v, drawn) for k, v in node.items()}
    if isinstance(node, list):
        return [_substitute(v, drawn) for v in node]
    if isinstance(node, str) and node.startswith("$"):
        var, _, key = node[1:].partition(".")
        return drawn[var][key] if key else drawn[var]
    return node


def _poisson_requests(mix: dict, config: dict, n: int, seed: int,
                      tag: str) -> list[dict]:
    """n request specs of a Poisson mix, each `{"kind", "request"}`."""
    rng = _rng(seed, f"traffic/{tag}")
    kinds = mix["kinds"]
    counts = _fixed_counts([k["weight"] for k in kinds], n)
    per_kind = []
    for kind, m in zip(kinds, counts):
        draws = {var: _law_values(law, m, config, rng)
                 for var, law in sorted(kind.get("draws", {}).items())}
        per_kind.append([{"kind": kind["name"], "request": _substitute(
            copy.deepcopy(kind["request"]),
            {var: vals[i] for var, vals in draws.items()})}
            for i in range(m)])
    labels = np.concatenate([np.full(m, i) for i, m in enumerate(counts)])
    labels = labels[rng.permutation(n)]
    cursor = [0] * len(kinds)
    out = []
    for label in labels:
        out.append(per_kind[label][cursor[label]])
        cursor[label] += 1
    return out


def _poisson_offsets(mix: dict, seconds: float, seed: int,
                     tag: str) -> np.ndarray:
    """Offsets (s) of the arrivals: exponential gaps at the mix's rate, at
    fixed quantiles in the seed's order, spanning the window."""
    n = max(1, int(round(mix["rate_qps"] * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)[_rng(seed, f"arrivals/{tag}").permutation(n)]
    return (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())


def _panel(mix: dict, config: dict, dashboard: dict, panel: dict,
           now_ms: int) -> dict:
    range_ms = int(dashboard["range_s"]) * 1000
    drawn = {"range": {"from_us": (now_ms - range_ms) * 1000,
                       "to_us": now_ms * 1000}}
    return {"kind": panel["name"], "dashboard": dashboard["name"],
            "request": _substitute(copy.deepcopy(panel["request"]), drawn)}


def corpus_end_ms(config: dict) -> int:
    return (config["start_ts"] + config["span_seconds"]) * 1000


def _refresh_schedule(mix: dict, config: dict, seconds: float, seed: int,
                      tag: str) -> tuple[list[dict], np.ndarray]:
    """Each dashboard refreshes `n = max(1, seconds // refresh_s)` times,
    `refresh_s` apart; the dashboards are staggered evenly over the
    interval from a first phase the seed draws, so that every seed offers
    the same arrivals, shifted. A refresh sends every panel at once, in an
    order the seed draws, over [now - range, now), where now (ms) is the
    corpus's end less the time left to the window's close."""
    rng = _rng(seed, f"refresh/{tag}")
    every = float(mix["refresh_s"])
    n = max(1, int(seconds // every))
    stagger = every / len(mix["dashboards"])
    room = seconds - (n - 1) * every - (len(mix["dashboards"]) - 1) * stagger
    first = rng.uniform(0.0, max(1e-3, min(stagger, room)))
    end_ms = corpus_end_ms(config)
    due = []
    for d, dashboard in enumerate(mix["dashboards"]):
        phase = first + d * stagger
        for k in range(n):
            at = phase + k * every
            now_ms = end_ms - int(round((seconds - at) * 1000))
            for i in rng.permutation(len(mix["panels"])):
                due.append((at, _panel(mix, config, dashboard,
                                       mix["panels"][i], now_ms)))
    order = sorted(range(len(due)), key=lambda i: due[i][0])
    return ([due[i][1] for i in order],
            np.array([due[i][0] for i in order]))


def schedule(mix: dict, config: dict, seconds: float, seed: int,
             tag: str) -> tuple[list[dict], np.ndarray]:
    """The specs a window of `seconds` offers and when each is due (s
    after the window opens), sorted by when they are due."""
    if mix["loop"] == "refresh":
        return _refresh_schedule(mix, config, seconds, seed, tag)
    offsets = _poisson_offsets(mix, seconds, seed, tag)
    return _poisson_requests(mix, config, len(offsets), seed, tag), offsets


def warm_specs(mix: dict, config: dict, seed: int) -> list[dict]:
    """Every request shape of the mix, to be sent one by one in set-up:
    `per_kind` specs of each kind, or `rounds` refreshes of each
    dashboard's panels ending at the corpus's end."""
    warm = mix.get("warmup", {})
    if mix["loop"] == "refresh":
        return [_panel(mix, config, dashboard, panel, corpus_end_ms(config))
                for _ in range(warm.get("rounds", 1))
                for dashboard in mix["dashboards"]
                for panel in mix["panels"]]
    return _poisson_requests(mix, config, warm.get("per_kind", 2)
                             * len(mix["kinds"]), seed, "warmup")


def at_rate(mix: dict, qps: float) -> dict:
    """The mix offering `qps` requests a second (the sweep's knob)."""
    if mix["loop"] == "refresh":
        return dict(mix, refresh_s=(len(mix["dashboards"])
                                    * len(mix["panels"]) / qps))
    return dict(mix, rate_qps=qps)


class Outcome:
    """What became of one request."""

    __slots__ = ("index", "kind", "due", "sent", "done", "response",
                 "error")

    def __init__(self, index, kind, due):
        self.index, self.kind, self.due = index, kind, due
        self.sent = self.done = None
        self.response = self.error = None


def _serve(call, spec, outcome, clock):
    outcome.sent = clock()
    try:
        outcome.response = call(spec["request"])
    except Exception as exc:           # a failed request is counted, not fatal
        outcome.error = f"{type(exc).__name__}: {exc}"
    outcome.done = clock()


def open_loop(call, specs: list[dict], offsets: np.ndarray, seconds: float,
              straggle_s: float = 60.0, workers: int = 64):
    """Send specs[i] at offsets[i] after the start whatever came back,
    then wait for the stragglers, up to `straggle_s` past the close. A
    request still out then never came. Returns (outcomes, start, the
    window's close)."""
    clock = time.perf_counter
    outcomes = [Outcome(i, s["kind"], float(o))
                for i, (s, o) in enumerate(zip(specs, offsets))]
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="qwbench-client")
    start = clock()
    end = start + seconds
    futures = []
    try:
        for spec, outcome in zip(specs, outcomes):
            outcome.due = start + outcome.due
            delay = outcome.due - clock()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(_serve, call, spec, outcome, clock))
        wait(futures, timeout=max(0.0, end + straggle_s - clock()))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    return outcomes, start, end
