"""Log search over the hdfs-logs deployment (`qwbench/configs/
hdfs-logs-4x10m.json`) on the CPU at small sizes: the benchmark's corpus
module builds the bytes `SplitWriter` writes, doc store included; every
request kind of its mix (`qwbench/traffic/log-explorer.json`) through the
benchmark's node equals the plain reference; and the query profile counts
the split programs that selected hits (`topk_evals`, and on the card
`topk_kernel_evals`: here the fused kernel's route is checked) on the
solo, convoy, stacked and batch routes, and the root's fetch
(`docs_fetched`, `store_blocks_read`). The same kinds run on the card at
the deployment's split size in `tests/test_torch_cuda_hdfs_search.py`.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qwbench import cells, check, traffic
from qwbench.corpus import common, hdfs_logs
from qwbench.node import Node
from qwbench.reference import search as reference
from qwbench.tests.test_qwbench_corpus import (
    arrays_of, assert_same_split, writer_split,
)
from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index.format import SplitFileBuilder, SplitFooter
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.models.doc_mapper import DocMapper
from quickwit_tpu_torch.observability.profile import (
    DOCS_FETCHED, STORE_BLOCKS_READ, TOPK_EVALS, TOPK_KERNEL_EVALS,
    QueryProfile, profile_scope,
)
from quickwit_tpu_torch.query.es_dsl import es_query_to_ast
from quickwit_tpu_torch.search import executor as ex
from quickwit_tpu_torch.search import leaf
from quickwit_tpu_torch.search.models import SearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage

SEED = 2**31 + 424
SPLITS = 3
DOCS = 4000
KINDS = ("newest_matching", "top_by_score_1", "top_by_score_2",
         "top_by_score_3", "rare_term_lookup", "tenant_errors")


def small_config(docs: int = DOCS) -> dict:
    """The deployment at a CPU's size: 3 splits of a few thousand docs,
    each over an hour, the vocabulary and its law unchanged (timestamps
    then repeat within a split, so field sorts meet ties)."""
    config = cells.load_config("hdfs-logs-4x10m")
    config["splits"] = SPLITS
    config["docs_per_split"] = docs
    config["span_seconds"] = SPLITS * 3600
    return config


def documents(config: dict, raw: dict) -> list[dict]:
    return [hdfs_logs.document(config, raw, i)
            for i in range(raw["ts"].shape[0])]


@pytest.mark.parametrize("split", range(SPLITS))
def test_corpus_split_equals_the_writers(split):
    """Every array, the doc store's included, and every field's meta."""
    config = small_config()
    raw = hdfs_logs.draw(config, SEED, "cpu", split=split)
    ours, facts = hdfs_logs.build(config, raw)
    assert_same_split(ours, writer_split(config, documents(config, raw)),
                      store=True)
    footer, arrays = arrays_of(ours)
    assert len(arrays["store.block_offsets"]) > 3
    slice_s = config["span_seconds"] // SPLITS
    lo = (config["start_ts"] + split * slice_s) * 1_000_000
    assert lo <= facts["time_range"][0] <= facts["time_range"][1] \
        < lo + slice_s * 1_000_000
    assert facts["time_range"] == footer.time_range


@pytest.mark.parametrize("docs", [1, 479, 2000])
def test_vectorised_doc_store_equals_common_doc_store(docs):
    """The store built on the device from the words' bytes and the
    numbers' digits, against `common.doc_store` over the same docs:
    one doc, one block, several blocks."""
    config = small_config(docs)
    raw = hdfs_logs.draw(config, SEED + docs, "cpu", split=1)
    ours, theirs = SplitFileBuilder(), SplitFileBuilder()
    stream, sizes = hdfs_logs.store_stream(config, raw)
    assert hdfs_logs.doc_store(ours, stream, sizes) == common.doc_store(
        theirs, documents(config, raw))
    footer = SplitFooter(num_docs=docs, num_docs_padded=docs, arrays={},
                         fields={})
    ours, theirs = (arrays_of(b.finish(footer))[1] for b in (ours, theirs))
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name],
                                      err_msg=name)


def test_draws_follow_the_deployment():
    """Each split in its slice of the span and in time order, 10 tenants,
    10 to 20 words a doc, the most frequent word in most docs."""
    config = small_config(20_000)
    raw = hdfs_logs.draw(config, SEED, "cpu", split=2)
    ts = raw["ts"]
    assert bool((ts[1:] >= ts[:-1]).all())
    slice_s = config["span_seconds"] // SPLITS
    assert int(ts[0]) >= config["start_ts"] + 2 * slice_s
    assert sorted(torch.unique(raw["tenant"]).tolist()) == list(range(10))
    lengths = raw["body_offsets"][1:] - raw["body_offsets"][:-1]
    assert int(lengths.min()) == 10 and int(lengths.max()) == 20
    first = torch.zeros(20_000, dtype=torch.bool)
    doc = torch.repeat_interleave(torch.arange(20_000), lengths)
    first[doc[raw["body_ids"] == 0]] = True
    assert 0.8 < float(first.float().mean()) < 0.95
    shares = torch.bincount(raw["severity"].long(), minlength=4) / 20_000
    assert torch.allclose(shares, torch.tensor(config["severity_p"],
                                               dtype=shares.dtype),
                          atol=0.02)


# --- the node, the reference and the profile ----------------------------

@pytest.fixture(scope="module")
def deployment():
    """The small deployment's splits, the node over them and the
    reference's view, on the CPU."""
    config = small_config()
    raws, splits = [], []
    for i in range(SPLITS):
        raw = hdfs_logs.draw(config, SEED, "cpu", split=i)
        data, facts = hdfs_logs.build(config, raw)
        raws.append(raw)
        splits.append((f"s{i:04d}", data, facts))
    node = Node(config, splits, "cpu")
    refs = [reference.Split(config, raw, sid, "cpu",
                            lambda doc_id, raw=raw: hdfs_logs.document(
                                config, raw, doc_id))
            for raw, (sid, _, _) in zip(raws, splits)]
    mix = traffic.at_rate(cells.load_traffic("log-explorer"), 8.0)
    specs = traffic.schedule(mix, config, 8.0, SEED, "kinds")[0]
    return SimpleNamespace(config=config, node=node, refs=refs,
                           splits=splits, specs=specs,
                           mapper=DocMapper.from_dict(config["doc_mapping"]))


@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_equals_the_reference(deployment, kind):
    limits = deployment.config["check"]["limits"]
    requests = [s["request"] for s in deployment.specs if s["kind"] == kind]
    assert len(requests) >= 6
    tally = check.empty_tally()
    hits = 0
    for request in requests:
        got = check.program_answer(deployment.node.search(request))
        check.judge(got, reference.answer(deployment.refs, request), tally,
                    limits["score_gap"])
        hits += len(got["hits"])
    ok, shown = check.verdict(tally, limits)
    assert ok, shown
    assert tally["count_wrong"] == 0
    assert hits > 0
    if kind.startswith("top_by_score") or kind == "rare_term_lookup":
        assert 0 < tally["score_gap"] <= limits["score_gap"]
    else:
        assert tally["score_gap"] == 0.0


def _request(query: dict, max_hits: int) -> SearchRequest:
    return SearchRequest(index_ids=["hdfs-logs"],
                         query_ast=es_query_to_ast(query), max_hits=max_hits)


def _reader(deployment, i: int = 0) -> SplitReader:
    split_id, data, _ = deployment.splits[i]
    storage = RamStorage(Uri.parse(f"ram:///hdfs_search/{split_id}"))
    storage.put(f"{split_id}.split", data)
    return SplitReader(storage, f"{split_id}.split")


def _prepared(deployment, query: dict, max_hits: int, reader=None):
    reader = reader or _reader(deployment)
    request = _request(query, max_hits)
    plan = leaf.prepare_plan_only(request, deployment.mapper, reader, "s")
    arrays, _, _ = leaf.warmup_device_arrays(reader, plan, device="cpu")
    return request, reader, plan, arrays


def _word(deployment, rank: int) -> str:
    return hdfs_logs.term_name(deployment.config, "body", rank)


def _counted(run) -> dict:
    profile = QueryProfile("q")
    with profile_scope(profile):
        run()
    return profile.counters()


@pytest.mark.parametrize("query, fused", [
    ("one_word", True), ("two_words", False), ("tenant_filter", False)])
def test_a_solo_program_counts_its_top_k(deployment, query, fused):
    """One split program that selects hits counts once; the CPU computes
    no top-k on the kernel, and the fused route is the posting-space
    single-word search's alone."""
    queries = {"one_word": {"match": {"body": _word(deployment, 2)}},
               "two_words": {"match": {"body": " ".join(
                   _word(deployment, r) for r in (2, 5))}},
               "tenant_filter": {"bool": {"filter": [
                   {"term": {"tenant_id": 3}},
                   {"term": {"severity_text": "ERROR"}}]}}}
    request, reader, plan, arrays = _prepared(deployment, queries[query], 10)
    assert ex._takes_fused_kernel(plan, 10) is fused
    counters = _counted(lambda: leaf.execute_prepared_split(
        request, deployment.mapper, reader, "s", plan, arrays, "cpu"))
    assert counters[TOPK_EVALS] == 1
    assert counters.get(TOPK_KERNEL_EVALS, 0) == 0


def test_a_count_only_program_selects_no_hits(deployment):
    request, reader, plan, arrays = _prepared(
        deployment, {"match": {"body": _word(deployment, 2)}}, 0)
    counters = _counted(lambda: leaf.execute_prepared_split(
        request, deployment.mapper, reader, "s", plan, arrays, "cpu"))
    assert TOPK_EVALS not in counters


def test_a_convoy_counts_each_lane(deployment):
    """Three riders over one plan's arrays: one dispatch, three programs
    that selected hits."""
    _, _, plan, arrays = _prepared(
        deployment, {"match": {"body": _word(deployment, 4)}}, 10)
    assert ex._takes_fused_kernel(plan, 10)
    counters = _counted(lambda: ex.readback_plan_multi(
        ex.dispatch_plan_multi(plan, 10, arrays, [plan.scalars] * 3,
                               device="cpu")))
    assert counters[TOPK_EVALS] == 3
    assert counters.get(TOPK_KERNEL_EVALS, 0) == 0


def test_a_stacked_group_counts_each_lane(deployment):
    """Two distinct rare words whose postings pad to one length stack into
    one group: two programs that selected hits."""
    reader = _reader(deployment)
    prepared = [_prepared(deployment, {"match": {"body": _word(
        deployment, rank)}}, 10, reader) for rank in (3000, 3001)]
    plans = [p[2] for p in prepared]
    assert plans[0].signature(10) == plans[1].signature(10)
    counters = _counted(lambda: ex.readback_plan_stacked(
        ex.dispatch_plan_stacked(plans, 10, [p[3] for p in prepared],
                                 device="cpu")))
    assert counters[TOPK_EVALS] == 2
    assert counters.get(TOPK_KERNEL_EVALS, 0) == 0


def _profile_counters(profile: dict) -> dict:
    out = dict(profile.get("counters", {}))
    for child in profile.get("leaves", ()):
        for name, value in _profile_counters(child).items():
            out[name] = out.get(name, 0.0) + value
    return out


def _blocks(deployment, hits) -> int:
    """The distinct doc-store blocks that hold the hits' docs."""
    firsts = {sid: arrays_of(data)[1]["store.block_first_doc"]
              for sid, data, _ in deployment.splits}
    return len({(h.split_id, int(np.searchsorted(firsts[h.split_id],
                                                 h.doc_id, "right")))
                for h in hits})


@pytest.mark.parametrize("max_hits", [3, 40])
def test_the_root_counts_its_fetch_and_each_splits_top_k(deployment,
                                                         max_hits):
    """A request over every split: each split's program counted once, the
    fetched docs and the zlib blocks they lie in counted in the fetch."""
    word = _word(deployment, 9)
    response = deployment.node.search(
        {"query": {"match": {"body": word}}, "max_hits": max_hits},
        profile=True)
    counters = _profile_counters(response.profile)
    assert len(response.hits) == max_hits
    assert counters[TOPK_EVALS] == SPLITS
    assert counters.get(TOPK_KERNEL_EVALS, 0) == 0
    assert counters[DOCS_FETCHED] == max_hits
    assert counters[STORE_BLOCKS_READ] == _blocks(deployment, response.hits)
    assert [p["name"] for p in response.profile["phases"]].count(
        "fetch_docs") == 1
