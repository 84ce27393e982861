"""The hdfs-logs search deployment (`configs/hdfs-logs-4x10m.json`,
`corpus/hdfs_logs.py`, `traffic/log-explorer.json`) and its cell
`hdfs-search-open`: the mix's draws, the cell's per-layer readers on
built runs, and a scaled-down run through `run_cell` on the CPU."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from qwbench import cells, harness, roofline, traffic
from qwbench.corpus import hdfs_logs

CELL = "hdfs-search-open"
READERS = ("topk_kernel_share", "search_roofline", "fetch_docs_ms")


def config() -> dict:
    return cells.load_config("hdfs-logs-4x10m")


def mix() -> dict:
    return cells.load_traffic("log-explorer")


def law(kind: str) -> dict:
    (found,) = [k for k in mix()["kinds"] if k["name"] == kind]
    return found.get("draws", {})


def test_the_cell_and_its_metrics_are_declared():
    bench = cells.benchmark()
    work = cells.cell(CELL, bench)
    assert (work["config"], work["traffic"], work["chips"]) == (
        "hdfs-logs-4x10m", "log-explorer", 1)
    assert [m["name"] for m in work["end_to_end"]] == [
        "device_ms_per_query", "setup_s"]
    assert [m["name"] for m in work["per_layer"]] == list(READERS)
    for metric in work["per_layer"]:
        assert metric["workloads"] == [CELL]
        assert metric["moves"] == "device_ms_per_query"
        assert callable(cells.reader(metric["name"]))
    (entry,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    assert cells.load_config(work["config"])["reduced"].keys() == set(
        entry["reduced"])


def test_the_deployment_keeps_its_published_scale():
    cfg = config()
    assert cfg["splits"] * cfg["docs_per_split"] == 40_000_000
    assert cfg["docs_per_split"] == 10_000_000
    assert cfg["body_words"]["size"] == 100_000
    names = [f["name"] for f in cfg["doc_mapping"]["field_mappings"]]
    assert names == ["timestamp", "tenant_id", "severity_text", "body",
                     "resource"]
    assert cfg["doc_mapping"]["default_search_fields"] == [
        "severity_text", "body"]
    assert "score_gap" in cfg["check"]["limits"]


def test_a_line_has_the_published_width():
    """The distributed tutorial's 13 GB over 40M docs: ~325 B a line, in
    the dataset's keys and their order."""
    cfg = config()
    cfg["docs_per_split"] = 20_000
    raw = hdfs_logs.draw(cfg, 2**31 + 5, "cpu")
    _, sizes = hdfs_logs.store_stream(cfg, raw)
    assert 315 < sizes.mean() < 335
    doc = hdfs_logs.document(cfg, raw, 0)
    assert list(doc) == ["timestamp", "severity_text", "body", "resource",
                         "attributes", "tenant_id"]
    assert doc["resource"]["service"] in cfg["services"]
    assert doc["attributes"]["class"] in cfg["classes"]


def rank(word: str) -> int:
    return int(word[1:].rstrip("a"))


def test_term_names_are_ranks():
    """Every word 8 characters: its rank, padded with a's."""
    cfg = config()
    assert [hdfs_logs.term_name(cfg, "body", r) for r in (0, 9, 99_999)] \
        == ["w0aaaaaa", "w9aaaaaa", "w99999aa"]
    assert hdfs_logs.words(cfg)[1234] == "w1234aaa"
    assert {len(w) for w in hdfs_logs.words(cfg)} == {8}
    assert [rank(w) for w in hdfs_logs.words(cfg)] == list(range(100_000))
    with pytest.raises(KeyError):
        hdfs_logs.term_name(cfg, "severity_text", 0)


def test_a_uniform_law_draws_the_whole_vocabulary():
    """`rare_term_lookup`: one word a query, Zipf 0 over all 100,000
    ranks: fixed quantiles spread evenly, far past the frequent words."""
    q = law("rare_term_lookup")["q"]
    assert (q["zipf_s"], q["top"], q["count"]) == (0, 100_000, [1, 1])
    texts = [v["text"] for v in traffic._law_values(
        q, 50, config(), traffic._rng(2**33 + 1, "t"))]
    ranks = sorted(rank(t) for t in texts)
    assert all(len(t.split()) == 1 for t in texts)
    assert len(set(ranks)) == 50
    gaps = [b - a for a, b in zip(ranks, ranks[1:])]
    assert min(gaps) >= 1999 and max(gaps) <= 2001
    assert ranks[0] < 2000 and ranks[-1] > 98_000


@pytest.mark.parametrize("kind, least, most, top", [
    ("newest_matching", 1, 2, 2000), ("top_by_score_1", 1, 1, 200),
    ("top_by_score_2", 2, 2, 200), ("top_by_score_3", 3, 3, 200)])
def test_frequent_word_laws(kind, least, most, top):
    q = law(kind)["q"]
    texts = [v["text"] for v in traffic._law_values(
        q, 300, config(), traffic._rng(2**33 + 2, kind))]
    words = [t.split() for t in texts]
    assert {len(w) for w in words} == set(range(least, most + 1))
    ranks = [rank(w) for ws in words for w in ws]
    assert max(ranks) < top
    assert ranks.count(0) > ranks.count(top // 2)


def test_top_by_score_is_one_query_law_dealt_by_word_count():
    """BM25 top 10 of 1 to 3 frequent words, 0.3 of the requests, dealt as
    three kinds of one word count each, so that every seed sends the same
    single-word searches, and the leaf cache meets the same repeats."""
    kinds = [k for k in mix()["kinds"] if k["name"].startswith(
        "top_by_score")]
    assert [k["draws"]["q"]["count"] for k in kinds] == [[1, 1], [2, 2],
                                                         [3, 3]]
    assert sum(k["weight"] for k in kinds) == pytest.approx(0.3)
    assert len({k["weight"] for k in kinds}) == 1
    for k in kinds:
        assert k["request"] == {"query": {"match": {"body": "$q.text"}},
                                "max_hits": 10}
        assert (k["draws"]["q"]["zipf_s"], k["draws"]["q"]["top"]) == (
            1.1, 200)
    cfg = config()

    def single_words(seed):
        specs = traffic.schedule(mix(), cfg, 51.0, seed, "window")[0]
        return sorted(s["request"]["query"]["match"]["body"] for s in specs
                      if s["kind"] == "top_by_score_1")
    assert single_words(2**31 + 1) == single_words(2**33 + 7)


def test_time_ranges_fall_inside_the_span():
    cfg = config()
    for kind, lengths in (("newest_matching", {900, 3600}),
                          ("tenant_errors", {3600})):
        w = law(kind)["w"]
        values = traffic._law_values(w, 40, cfg, traffic._rng(3, kind))
        start = cfg["start_ts"] * 1_000_000
        end = (cfg["start_ts"] + cfg["span_seconds"]) * 1_000_000
        assert {(v["to_us"] - v["from_us"]) // 1_000_000
                for v in values} == lengths
        assert all(start <= v["from_us"] and v["to_us"] <= end
                   for v in values)


# --- the readers ------------------------------------------------------------

def outcome(profile=None):
    return SimpleNamespace(response=SimpleNamespace(profile=profile))


def test_topk_kernel_share_over_requests_and_their_leaves():
    read = cells.reader("topk_kernel_share")
    done = [outcome({"counters": {"topk_evals": 4.0,
                                  "topk_kernel_evals": 1.0}}),
            outcome({"counters": {}, "leaves": [
                {"counters": {"topk_evals": 2.0, "topk_kernel_evals": 2.0}},
                {"counters": {"topk_evals": 2.0}}]}),
            outcome(None)]
    assert read(SimpleNamespace(done=done)) == pytest.approx(37.5)


def test_topk_kernel_share_is_none_without_counters():
    """A program that records no top-k counters, as one older than
    them does, reads as nothing."""
    read = cells.reader("topk_kernel_share")
    assert read(SimpleNamespace(done=[outcome({"counters": {
        "device_dispatches": 3.0}})])) is None
    assert read(SimpleNamespace(done=[])) is None


def test_search_roofline_reads_the_searches_bytes():
    read = cells.reader("search_roofline")
    needed = [{"search": 3.35e9}, {"aggs": 1e9}, {"search": 3.35e9,
                                                  "aggs": 5.0}]
    # 6.7 GB at 3.35 TB/s is 2 ms; over 0.1 s busy, 2%
    assert read(SimpleNamespace(needed=needed, busy_s=0.1)) == \
        pytest.approx(2.0)
    assert read(SimpleNamespace(needed=[{"aggs": 1e9}], busy_s=0.1)) is None
    assert read(SimpleNamespace(needed=needed, busy_s=0.0)) is None
    assert roofline.share(6.7e9, 0.1) == pytest.approx(2.0)


def test_fetch_docs_ms_averages_per_request():
    read = cells.reader("fetch_docs_ms")
    assert read(SimpleNamespace(phases={"fetch_docs": [2.0, 4.0, 0.0]})) \
        == pytest.approx(2.0)
    assert read(SimpleNamespace(phases={})) is None


# --- a run on the CPU ---------------------------------------------------------

def small():
    """The deployment and its mix at a size the CPU runs in seconds: 4
    splits of 12,000 docs over 4 hours, the vocabulary, its law and the
    mix's kinds unchanged."""
    cfg = config()
    cfg["docs_per_split"] = 12_000
    cfg["span_seconds"] = 4 * 3600
    m = traffic.at_rate(mix(), 8.0)
    m["warmup"] = {"per_kind": 1, "seconds": 0}
    return cfg, m


def test_the_cell_runs_end_to_end_on_the_cpu():
    cfg, m = small()
    result = harness.run_cell(cells.cell(CELL), 2**32 + 2024, 4.0, False,
                              "cpu", time.perf_counter(), cfg, m)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 30
    assert list(result["checks"]) == ["count_wrong", "agg_gap", "score_gap",
                                      "failed"]
    assert 0 < result["checks"]["score_gap"]["value"] \
        <= cfg["check"]["limits"]["score_gap"]
    assert set(result["metrics"]) == {"setup_s"}


def test_the_readers_read_a_profiled_window():
    """The window's profiles as a traced run reads them, on the CPU: the
    top-k programs counted (none on the kernel here), the fetch timed,
    the searches' bytes counted."""
    from qwbench.node import Node
    cfg, m = small()
    cell = harness.Cell(cells.cell(CELL), 2**31 + 5, "cpu", cfg, m)
    cell.build_corpus()
    node = Node(cell.config, cell.splits, "cpu")
    specs, offsets = cell.schedule(3.0, "window")
    outcomes, _, _ = traffic.open_loop(
        lambda s: node.search(s, profile=True), specs, offsets, 3.0)
    done = [o for o in outcomes if o.response is not None]
    phases = {"fetch_docs": [sum(p["duration_ms"] for p in
                                 o.response.profile["phases"]
                                 if p["name"] == "fetch_docs")
                             for o in done]}
    bytes_of = cell.needed_bytes(node.footers)
    run = SimpleNamespace(done=done, phases=phases, busy_s=1.0,
                          needed=[bytes_of(specs[o.index]["request"])
                                  for o in done])
    assert cells.reader("topk_kernel_share")(run) == 0.0
    assert cells.reader("fetch_docs_ms")(run) > 0
    assert cells.reader("search_roofline")(run) > 0
    assert all("search" in n for n in run.needed)
