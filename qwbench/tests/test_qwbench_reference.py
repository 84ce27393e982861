"""The plain reference against the port's CPU path, the result line's
shape, and the rule that nothing the benchmark runs loads JAX or the JAX
package. On the CPU at small sizes."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

from types import SimpleNamespace

import numpy as np
import pytest

from qwbench import cells, check, harness, roofline, run, traffic
from qwbench.node import Node
from qwbench.tests import logs_corpus

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["otel-dashboard-open"]


# a mix as a later data-only cell could add it: Poisson arrivals of
# aggregation requests over drawn time ranges
POISSON = {"loop": "poisson", "rate_qps": 1.0,
           "kinds": [{"name": "by_service", "weight": 0.5,
                      "draws": {"w": {"law": "time_range",
                                      "lengths_s": [300, 900],
                                      "align_s": 60}},
                      "request": {"max_hits": 0,
                                  "start_timestamp": "$w.from_us",
                                  "end_timestamp": "$w.to_us",
                                  "aggs": {"s": {"terms": {
                                      "field": "service_name", "size": 5}}}}},
                     {"name": "slowest", "weight": 0.5,
                      "request": {"max_hits": 0, "aggs": {"m": {"max": {
                          "field": "span_duration_millis"}}}}}]}


def small(name: str, mix: dict | None = None):
    """A cell's parts at a size the CPU runs in seconds."""
    work = cells.cell(name)
    config = cells.load_config(work["config"])
    mix = dict(mix or cells.load_traffic(work["traffic"]))
    config["docs_per_split"] = 6000
    config["splits"] = 3
    mix = traffic.at_rate(mix, 8.0)
    mix["warmup"] = {"per_kind": 1, "rounds": 1, "seconds": 0}
    return work, config, mix


def kinds_of(mix: dict) -> set[str]:
    return {k["name"] for k in mix.get("kinds", mix.get("panels", []))}


@pytest.mark.parametrize("mix", [None, POISSON], ids=["cell", "poisson"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_cpu_path_for_every_kind(name, mix):
    work, config, mix = small(name, mix)
    cell = harness.Cell(work, 5_000_000_021, "cpu", config, mix)
    cell.build_corpus()
    node = Node(cell.config, cell.splits, "cpu")
    specs = cell.schedule(4.0, "kinds")[0]
    assert {s["kind"] for s in specs} == kinds_of(mix)
    items = [(s["request"], check.program_answer(node.search(s["request"])))
             for s in specs]
    tally = harness.judge(cell, items)
    ok, shown = check.verdict(tally, config["check"]["limits"])
    assert ok, shown
    assert tally["count_wrong"] == 0
    assert all(got["num_hits"] for _, got in items)


@pytest.mark.parametrize("mix", [None, POISSON], ids=["cell", "poisson"])
@pytest.mark.parametrize("name", CELLS)
def test_every_seed_offers_the_same_work_in_another_order(name, mix):
    work, config, mix = small(name, mix)
    one = harness.Cell(work, 2**40 + 1, "cpu", config, mix).schedule(
        20.0, "window")
    two = harness.Cell(work, 2**40 + 1, "cpu", config, mix).schedule(
        20.0, "window")
    other = harness.Cell(work, 7, "cpu", config, mix).schedule(
        20.0, "window")
    assert one[0] == two[0] and list(one[1]) == list(two[1])
    assert one[0] != other[0]
    assert len(one[0]) == len(other[0])
    assert sorted(s["kind"] for s in one[0]) == sorted(
        s["kind"] for s in other[0])
    if mix["loop"] == "poisson":
        gaps = [sorted(np.diff(np.append(x[1], 20.0))) for x in (one, other)]
        assert gaps[0] == pytest.approx(gaps[1], rel=1e-9)
    else:                               # the same arrivals, shifted
        assert list(np.diff(one[1])) == pytest.approx(
            list(np.diff(other[1])), abs=1e-9)


def test_a_refresh_sends_its_panels_together_over_one_range():
    work, config, mix = small("otel-dashboard-open")
    specs, offsets = harness.Cell(work, 3, "cpu", config, mix).schedule(
        10.0, "window")
    end_us = traffic.corpus_end_ms(config) * 1000
    per = {}
    for spec, at in zip(specs, offsets):
        request = spec["request"]
        per.setdefault((spec["dashboard"], float(at)), set()).add(
            (request["start_timestamp"], request["end_timestamp"]))
        # "now" runs along the corpus's last seconds to its end
        assert end_us - 10_000_000 <= request["end_timestamp"] <= end_us
        assert request["end_timestamp"] % 1000 == 0
    assert all(len(ranges) == 1 for ranges in per.values())
    panels = len(mix["panels"])
    assert len(specs) == panels * len(per)


def test_result_line_has_the_contracts_keys():
    work, config, mix = small("otel-dashboard-open")
    result = harness.run_cell(work, 2**32 + 3, 1.0, False, "cpu",
                              time.perf_counter(), config, mix)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # device_ms_per_query comes from the card's trace, so not on the CPU
    assert set(result["metrics"]) == {"setup_s"}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    assert set(result["checks"]) == set(check.NUMBERS) | {"failed"}
    assert result["correct"] is True
    json.dumps(result)


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "otel-dashboard-open", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                package = ".".join(path.relative_to(ROOT).with_suffix("")
                                   .parts[:-node.level])
                out.add(f"{package}.{node.module}" if node.module
                        else package)
            elif node.module:
                out.add(node.module)
    return out


def test_nothing_the_benchmark_runs_imports_jax():
    """Every module reachable from `qwbench` through imports in this
    repository, by whole top-level name."""
    todo = [p for p in (ROOT / "qwbench").rglob("*.py")]
    seen, tops = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            tops.add(name.split(".")[0])
            parts = name.split(".")
            for cut in range(len(parts), 0, -1):
                base = ROOT.joinpath(*parts[:cut])
                for cand in (base.with_suffix(".py"), base / "__init__.py"):
                    if cand.exists():
                        todo.append(cand)
                        break
                else:
                    continue
                break
    assert not tops & set(harness.FORBIDDEN), sorted(tops)
    assert any(p.parts[-2] == "search" for p in seen)   # the port was walked


def test_loading_the_benchmark_loads_no_jax():
    code = ("import sys, importlib, pkgutil, qwbench\n"
            "for m in pkgutil.walk_packages(qwbench.__path__, 'qwbench.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import qwbench.node\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'quickwit_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# --- the freeze of the existing cell ----------------------------------------

FROZEN = Path(__file__).with_name("frozen_otel_dashboard_open.json")


def test_otel_dashboard_open_reads_as_it_did():
    """`otel-dashboard-open`'s window schedule, the bytes each request
    needs and the reference's answers, for one seed, equal what the
    harness gave before it could judge searches (values taken from that
    commit: `frozen_otel_dashboard_open.json`)."""
    from qwbench.reference import search as reference
    frozen = json.loads(FROZEN.read_text())
    work = cells.cell("otel-dashboard-open")
    config = cells.load_config(work["config"])
    mix = cells.load_traffic(work["traffic"])
    specs, offsets = harness.Cell(work, frozen["seed"], "cpu", config,
                                  mix).schedule(frozen["seconds"], "window")
    assert specs == frozen["specs"]
    assert [float(x) for x in offsets] == frozen["offsets"]
    config = dict(config, docs_per_split=frozen["docs_per_split"],
                  splits=frozen["splits"])
    cell = harness.Cell(work, frozen["seed"], "cpu", config, mix)
    cell.build_corpus()
    bytes_of = cell.needed_bytes(Node(cell.config, cell.splits,
                                      "cpu").footers)
    assert [bytes_of(s["request"]) for s in specs] == frozen["needed"]
    splits = cell.reference_splits("cpu")
    answers = [reference.answer(splits, s["request"])
               for s in specs[:len(frozen["answers"])]]
    assert json.loads(json.dumps(answers)) == frozen["answers"]


# --- searches: hits, full-text queries and fetched documents ----------------

S = logs_corpus.CONFIG["start_ts"] * 1_000_000
MIN = 60 * 1_000_000
SEARCHES = {
    "match_or_top10": {"query": {"match": {"body": "t0 t5 t77"}},
                       "max_hits": 10},
    "match_and_top100": {"query": {"match": {"body": {
        "query": "t1 t2", "operator": "and"}}}, "max_hits": 100},
    "bool_every_occur_in_time": {
        "query": {"bool": {
            "must": [{"match": {"body": "t3"}}],
            "should": [{"match": {"body": "t10 t11"}}],
            "filter": [{"range": {"tenant_id": {"gte": 2}}}],
            "must_not": [{"term": {"severity_text": "DEBUG"}}]}},
        "max_hits": 10, "start_timestamp": S + 10 * MIN,
        "end_timestamp": S + 40 * MIN},
    "bool_should_only_top100": {"query": {"bool": {"should": [
        {"match": {"body": "t4"}}, {"match": {"body": "t40"}}]}},
        "max_hits": 100},
    "term_u64_top10": {"query": {"term": {"tenant_id": 3}},
                       "max_hits": 10},
    "terms_agg_u64": {"query": {"match": {"body": "t2"}}, "max_hits": 0,
                      "aggs": {"by_tenant": {"terms": {
                          "field": "tenant_id", "size": 5}}}},
    "newest_first_top100_in_time": {
        "query": {"match": {"body": "t6 t8"}}, "max_hits": 100,
        "sort_by": [{"field": "timestamp", "order": "desc"}],
        "start_timestamp": S + MIN, "end_timestamp": S + 30 * MIN},
    "newest_first_of_tenant_top10": {
        "query": {"bool": {"filter": [{"term": {"tenant_id": 3}}]}},
        "max_hits": 10,
        "sort_by": [{"field": "timestamp", "order": "desc"}]},
    "hits_and_aggs_top100": {
        "query": {"match": {"body": "t0 t1"}}, "max_hits": 100,
        "aggs": {"sev": {"terms": {"field": "severity_text"}},
                 "tenants": {"terms": {"field": "tenant_id"}}}},
}


def logs_work(bench: dict | None = None) -> dict:
    """The search cell as a later `BENCHMARK.json` entry would name it."""
    bench = json.loads(json.dumps(bench or cells.benchmark()))
    bench["workloads"].append({
        "name": "test-logs-search", "config": logs_corpus.CONFIG["name"],
        "traffic": "test-logs-explorer", "chips": 1,
        "why": "full-text searches with hits over 3 small splits"})
    return cells.cell("test-logs-search", bench)


@pytest.fixture(scope="module")
def logs():
    """The search deployment's corpus, its node and the reference's view,
    on the CPU."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        logs_corpus.registered(monkeypatch)
        cell = harness.Cell(logs_work(), 2**31 + 99, "cpu",
                            logs_corpus.config(), logs_corpus.MIX)
        cell.build_corpus()
        node = Node(cell.config, cell.splits, "cpu")
        yield SimpleNamespace(cell=cell, node=node,
                              splits=cell.reference_splits("cpu"))


def search_tally(logs, request, got) -> dict:
    from qwbench.reference import search as reference
    tally = check.empty_tally()
    limits = logs.cell.config["check"]["limits"]
    check.judge(got, reference.answer(logs.splits, request), tally,
                limits["score_gap"])
    return tally


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_reference_agrees_with_the_cpu_path_on_searches(logs, name):
    request = SEARCHES[name]
    got = check.program_answer(logs.node.search(request))
    tally = search_tally(logs, request, got)
    limits = logs.cell.config["check"]["limits"]
    assert tally["count_wrong"] == 0, tally
    assert tally["score_gap"] <= limits["score_gap"], tally
    assert got["num_hits"] > len(got["hits"]) > 0 or not request["max_hits"]
    assert all(h["doc"]["body"] for h in got["hits"])
    if request.get("sort_by") or not request["max_hits"]:
        assert tally["score_gap"] == 0.0
    else:
        assert tally["score_gap"] > 0.0      # the port scores in float32


def _deep_hit(logs, request) -> dict:
    """A hit of the request far below its k-th best score."""
    from qwbench.reference import search as reference
    return reference.answer(logs.splits, dict(request, max_hits=2000))[
        "hits"][-1]


def _no_match(logs, request) -> dict:
    from qwbench.reference import search as reference
    want = reference.answer(logs.splits, request)
    doc = next(d for d in range(logs.splits[0].n)
               if want["lookup"](logs.splits[0].split_id, d) is None)
    return {"split_id": logs.splits[0].split_id, "doc_id": doc,
            "score": 1.0, "doc": {}}


def _swap(hits: list, differ) -> None:
    """Swap the first two consecutive hits that `differ`."""
    i = next(i for i in range(len(hits) - 1) if differ(hits[i], hits[i + 1]))
    hits[i], hits[i + 1] = hits[i + 1], hits[i]


PLANTED = {
    # name: (request, fault, count_wrong it adds, whether score_gap fails)
    "swapped_hit": ("match_or_top10", lambda logs, got, r: _swap(
        got["hits"], lambda a, b: a["score"] > b["score"] * 1.001), 1, False),
    "dropped_hit": ("match_or_top10", lambda logs, got, r: got["hits"].pop(
        4), 1, False),
    "hit_outside_the_top_k": ("match_or_top10", lambda logs, got, r:
                              got["hits"].__setitem__(
                                  -1, _deep_hit(logs, r)), 1, False),
    "hit_that_does_not_match": ("match_and_top100", lambda logs, got, r:
                                got["hits"].__setitem__(
                                    -1, _no_match(logs, r)), 1, False),
    "duplicate_hit": ("match_and_top100", lambda logs, got, r:
                      got["hits"].__setitem__(-1, dict(got["hits"][0])),
                      1, False),
    "score_off_by_1e-3": ("bool_every_occur_in_time", lambda logs, got, r:
                          got["hits"][2].__setitem__(
                              "score", got["hits"][2]["score"] * 1.001),
                          0, True),
    "wrong_document": ("newest_first_of_tenant_top10", lambda logs, got, r:
                       got["hits"][1].__setitem__("doc", dict(
                           got["hits"][1]["doc"], severity_text="ERROR",
                           body=got["hits"][1]["doc"]["body"] + " t1")),
                       1, False),
    "wrong_num_hits": ("term_u64_top10", lambda logs, got, r:
                       got.__setitem__("num_hits", got["num_hits"] - 1),
                       1, False),
    "field_sort_swapped": ("newest_first_top100_in_time",
                           lambda logs, got, r: _swap(got["hits"], lambda a, b:
                                                      a["doc"]["timestamp"]
                                                      != b["doc"]["timestamp"]),
                           2, False),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_a_planted_search_fault_is_caught(logs, fault):
    name, plant, wrong, gap = PLANTED[fault]
    request = SEARCHES[name]
    got = check.program_answer(logs.node.search(request))
    plant(logs, got, request)
    tally = search_tally(logs, request, got)
    ok, _ = check.verdict(tally, logs.cell.config["check"]["limits"])
    assert not ok
    assert tally["count_wrong"] == wrong, tally
    limit = logs.cell.config["check"]["limits"]["score_gap"]
    assert (tally["score_gap"] > limit) is gap, tally


def test_a_search_cell_runs_end_to_end_on_the_cpu(monkeypatch):
    """A deployment, corpus and mix defined in test files alone, through
    `run_cell`: drawn query terms, hits by score and newest first, the
    fetched documents judged."""
    logs_corpus.registered(monkeypatch)
    result = harness.run_cell(logs_work(), 2**32 + 77, 3.0, False, "cpu",
                              time.perf_counter(), logs_corpus.config(),
                              logs_corpus.MIX)
    assert list(result["checks"]) == ["count_wrong", "agg_gap", "score_gap",
                                      "failed"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 20
    assert 0 < result["checks"]["score_gap"]["value"] <= 1e-5


def test_query_terms_are_drawn_at_fixed_quantiles(monkeypatch):
    logs_corpus.registered(monkeypatch)
    config = logs_corpus.config()
    law = logs_corpus.MIX["kinds"][0]["draws"]["q"]
    draws = [[v["text"] for v in traffic._law_values(
        law, 200, config, traffic._rng(seed, "t"))] for seed in (5, 5, 6)]
    assert draws[0] == draws[1] != draws[2]
    for texts in draws:
        terms = [text.split() for text in texts]
        assert all(len(set(t)) == len(t) and 1 <= len(t) <= 3
                   for t in terms)
        assert sorted(map(len, terms)) == sorted(
            map(len, [text.split() for text in draws[0]]))
    counts = {}
    for text in draws[0]:
        for word in text.split():
            counts[word] = counts.get(word, 0) + 1
    top = [logs_corpus.term_name(config, "body", r) for r in range(3)]
    assert [counts[w] for w in top] == sorted(
        (counts[w] for w in top), reverse=True)
    assert counts[top[0]] > 5 * counts.get(
        logs_corpus.term_name(config, "body", 150), 1)


def test_needed_bytes_of_a_search(logs):
    """Postings of each distinct term, the timestamps in the range, and
    the sort column of the matched docs."""
    bytes_of = logs.cell.needed_bytes(logs.node.footers)
    assert bytes_of(SEARCHES["match_or_top10"]) == {"search": 12 * sum(
        split.doc_freq("body", w) for split in logs.splits
        for w in ("t0", "t5", "t77"))}
    request = SEARCHES["newest_first_top100_in_time"]
    want = 0
    for split in logs.splits:
        width = harness._stored_widths(logs.node.footers[split.split_id])[
            "timestamp"]
        in_range = split.request_mask({k: v for k, v in request.items()
                                       if k != "query"})
        want += (12 * (split.doc_freq("body", "t6")
                       + split.doc_freq("body", "t8"))
                 + width * int(in_range.sum())
                 + width * int(split.request_mask(request).sum()))
    assert bytes_of(request) == {"search": want}


def test_needed_bytes_of_a_request_that_searches_and_aggregates(logs):
    """Hits with aggregations, and aggregations under a full-text query:
    `search` has the query's postings, `aggs` the aggregated columns,
    each column counted once."""
    bytes_of = logs.cell.needed_bytes(logs.node.footers)
    ts_field = logs.cell.config["doc_mapping"]["timestamp_field"]
    tables = [{"ts_us": logs.cell.ts_us(raw),
               "width": harness._stored_widths(logs.node.footers[sid])}
              for raw, (sid, _, _) in zip(logs.cell.raws, logs.cell.splits)]
    for name, words in (("hits_and_aggs_top100", ("t0", "t1")),
                        ("terms_agg_u64", ("t2",))):
        request = SEARCHES[name]
        postings = 12 * sum(split.doc_freq("body", w)
                            for split in logs.splits for w in words)
        assert bytes_of(request) == {
            "aggs": roofline.aggregation_bytes(request, ts_field, tables),
            "search": postings}
        assert bytes_of(request)["aggs"] > 0 and postings > 0
    # bounded in time, the timestamps go to `aggs` alone
    request = dict(SEARCHES["hits_and_aggs_top100"],
                   start_timestamp=S + MIN, end_timestamp=S + 30 * MIN)
    got = bytes_of(request)
    assert got["search"] == 12 * sum(split.doc_freq("body", w)
                                     for split in logs.splits
                                     for w in ("t0", "t1"))
    assert got["aggs"] == roofline.aggregation_bytes(request, ts_field,
                                                     tables)
    assert ts_field in roofline.fields_read(request, ts_field)


@pytest.mark.parametrize("field,terms", [
    ("body", ["t0", "t1", "t77", "t499", "nosuchword"]),
    ("tenant_id", [0, 3, 10**9]),
    ("severity_text", ["DEBUG", "ERROR", "NOSUCH"])])
def test_doc_freq_counts_the_docs_that_hold_the_term(logs, field, terms):
    for split in logs.splits:
        for term in terms:
            query = ({"match": {field: term}} if field == "body"
                     else {"term": {field: term}})
            assert split.doc_freq(field, term) == int(
                split.evaluate(query).sum())
