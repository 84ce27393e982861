"""The one-pass aggregation kernel's routing, on the CPU.

On CUDA tensors `search/executor.py` sends an aggregation node to
`ops/kernels/aggs.py::bucket_aggregate` when the kernel computes its state
exactly, from what the node and its columns show (`_kernel_route`): a
terms or date_histogram bucket agg without children, or a top-level
metric, whose metrics are all count, sum, avg, min, max, stats or
percentiles over integer columns with max|value| * docs < 2^53. On CPU
tensors every node takes the torch path (`executor._eval_agg_torch`), the
kernel's plain version, and the wrapper refuses them. Here: how every
synthetic case of `tests/test_torch_cuda_aggs.py` and each plan shape that
engages or bypasses on real lowered plans would route on the card, that
the CPU runs the torch path for them all, the 2^53 edge, the profile
counters and the wrapper's checks. The kernel's state against the torch
path's is in `tests/test_torch_cuda_aggs.py`, on the card.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_cuda_aggs import (  # noqa: F401 - an autouse fixture
    BUCKETS, PANELS, assert_same_state, edge_routes, synthetic_masks,
    synthetic_nodes, synthetic_view, whole_split_programs)

from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index import SplitWriter
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.models.doc_mapper import (
    DocMapper, FieldMapping, FieldType)
from quickwit_tpu_torch.observability.profile import (
    AGG_EVALS, AGG_KERNEL_EVALS, QueryProfile, profile_scope)
from quickwit_tpu_torch.ops.kernels import aggs as ak
from quickwit_tpu_torch.query.ast import MatchAll, Term
from quickwit_tpu_torch.search import executor as ex
from quickwit_tpu_torch.search import leaf
from quickwit_tpu_torch.search.models import SearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage

CPU_DOCS = 4096


# --- the synthetic cases: routed for the card, the torch path here --------

@pytest.mark.parametrize("mask_name", ["empty", "full", "random", "window"])
@pytest.mark.parametrize("node_name", sorted(synthetic_nodes(4)))
@pytest.mark.parametrize("nb", BUCKETS)
def test_cpu_takes_the_torch_path_for_kernel_shapes(nb, node_name,
                                                    mask_name):
    """Every synthetic node routes to the kernel on the card; on the CPU
    `_eval_aggs` gives the torch path's state, launches nothing and counts
    no kernel node."""
    view = synthetic_view(CPU_DOCS, nb, "cpu")
    mask = synthetic_masks(CPU_DOCS, "cpu")[mask_name]
    node = synthetic_nodes(nb)[node_name]
    assert ex._kernel_route(node, view, CPU_DOCS) is not None
    before = ak.bucket_aggregate.launches
    profile = QueryProfile("q")
    with profile_scope(profile):
        got = ex._eval_aggs([node], view, view.scalars, mask)
    assert_same_state(got, [ex._eval_agg_torch(node, view, view.scalars,
                                               mask)], node_name)
    assert ak.bucket_aggregate.launches == before
    assert profile.counters()[AGG_EVALS] == 1
    assert profile.counters()[AGG_KERNEL_EVALS] == 0


def test_u64_column_at_the_2_53_edge_routes_to_torch():
    assert edge_routes("cpu", CPU_DOCS) == (False, True)


@pytest.mark.parametrize("docs", [1, 4096, 524_288])
def test_exact_column_bound(docs):
    """(min + 255) * docs < 2^53 routes; reaching it does not; squares
    bound the same way."""
    lanes = torch.zeros(docs, dtype=torch.uint8)
    edge = 2**53 // docs - 255
    for fmin, routes in ((edge - 1, True), (edge, False)):
        frame = (np.asarray(1, np.uint64), np.asarray(fmin, np.uint64))
        assert (ak.exact_column(lanes, None, frame) is not None) == routes
    squares = int(np.sqrt(2**53 // docs)) - 255
    frame = (np.asarray(1, np.uint64), np.asarray(squares + 8, np.uint64))
    assert ak.exact_column(lanes, None, frame) is not None
    assert ak.exact_column(lanes, None, frame, squares=True) is None


def test_exact_column_refuses_what_it_cannot_sum():
    ones = torch.ones(64, dtype=torch.uint8)
    assert ak.exact_column(torch.zeros(64, dtype=torch.float64), ones) is None
    assert ak.exact_column(torch.zeros(64, dtype=torch.int64), ones) is None
    assert ak.exact_column(torch.zeros(64, dtype=torch.uint64), ones) is None
    assert ak.exact_column(torch.zeros(64, dtype=torch.int32), ones) \
        is not None
    assert ak.exact_column(torch.zeros(64, dtype=torch.uint8),
                           torch.ones(64, dtype=torch.int32)) is None
    f64_frame = (np.asarray(1.0), np.asarray(0.0))
    assert ak.exact_column(ones, ones, f64_frame) is None


# --- routing on lowered plans ---------------------------------------------

T0 = 1_600_000_000
MAPPER = DocMapper(field_mappings=[
    FieldMapping("ts", FieldType.DATETIME, fast=True, indexed=False,
                 input_formats=("unix_timestamp",)),
    FieldMapping("svc", FieldType.TEXT, tokenizer="raw", fast=True),
    FieldMapping("tags", FieldType.TEXT, tokenizer="raw", fast=True),
    FieldMapping("dur", FieldType.U64, fast=True, indexed=False),
    FieldMapping("delta", FieldType.I64, fast=True, indexed=False),
    FieldMapping("big", FieldType.U64, fast=True, indexed=False),
    FieldMapping("ratio", FieldType.F64, fast=True, indexed=False)],
    timestamp_field="ts")


@pytest.fixture(scope="module")
def reader():
    rng = np.random.RandomState(21)
    writer = SplitWriter(MAPPER)
    for i in range(3000):
        writer.add_json_doc({
            "ts": T0 + i * 7,
            "svc": f"svc{rng.randint(0, 6)}",
            "tags": [f"tag{t}" for t in rng.randint(0, 9,
                                                    rng.randint(1, 4))],
            "dur": int(rng.randint(0, 5000)),
            "delta": int(rng.randint(-400, 400)),
            "big": int(2**50 + rng.randint(0, 1000)),
            "ratio": float(rng.rand())})
    storage = RamStorage(Uri.parse("ram:///agg_kernel"))
    storage.put("s.split", writer.finish())
    return SplitReader(storage, "s.split")


def routes(reader, aggs, query=None, monkeypatch=None, timed=True):
    """Whether each aggregation node of the request's split program would
    take the kernel on the card (over a time range where `timed`)."""
    found = []
    evaluate = ex._eval_aggs
    caller = threading.get_ident()

    def spy(nodes, view, scalars, valid):
        for node in nodes if threading.get_ident() == caller else ():
            found.append(ex._kernel_route(node, view, valid.shape[0])
                         is not None)
        return evaluate(nodes, view, scalars, valid)

    monkeypatch.setattr(ex, "_eval_aggs", spy)
    bounds = {"start_timestamp": (T0 + 2000) * 1_000_000,
              "end_timestamp": (T0 + 15000) * 1_000_000} if timed else {}
    request = SearchRequest(index_ids=["i"], query_ast=query or MatchAll(),
                            max_hits=0, aggs=aggs, **bounds)
    plan = leaf.prepare_plan_only(request, MAPPER, reader, "s")
    arrays, _, _ = leaf.warmup_device_arrays(reader, plan, device="cpu")
    leaf.execute_prepared_split(request, MAPPER, reader, "s", plan, arrays,
                                "cpu")
    return found


def _metric(kind, field="dur"):
    body = {"field": field}
    if kind == "percentiles":
        body["percents"] = [50, 99]
    return {kind: body}


ENGAGING = {
    "terms_percentiles": {"a": {"terms": {"field": "svc"},
                                "aggs": {"p": _metric("percentiles")}}},
    "date_histogram_avg_max": {"a": {
        "date_histogram": {"field": "ts", "fixed_interval": "1m"},
        "aggs": {"avg": _metric("avg"), "max": _metric("max")}}},
    "date_histogram_counts": {"a": {
        "date_histogram": {"field": "ts", "fixed_interval": "1h"}}},
    "terms_every_kind": {"a": {"terms": {"field": "svc"}, "aggs": {
        k: _metric(k) for k in ("sum", "min", "value_count", "stats",
                                "avg", "max", "percentiles")}}},
    "terms_two_columns": {"a": {"terms": {"field": "svc"}, "aggs": {
        "d": _metric("avg"), "n": _metric("stats", "delta")}}},
    "top_percentiles": {"p": _metric("percentiles")},
    "top_avg": {"a": _metric("avg")},
    "top_stats_negative": {"s": _metric("stats", "delta")},
}

BYPASSING = {
    "composite": {"a": {"composite": {"sources": [
        {"s": {"terms": {"field": "svc"}}}]}}},
    "range": {"a": {"range": {"field": "dur", "ranges": [
        {"to": 100}, {"from": 100}]}}},
    "histogram": {"a": {"histogram": {"field": "dur", "interval": 100}}},
    "terms_multivalued": {"a": {"terms": {"field": "tags"}}},
    "nested_buckets": {"a": {"terms": {"field": "svc"}, "aggs": {
        "b": {"date_histogram": {"field": "ts", "fixed_interval": "1h"}}}}},
    "cardinality": {"a": {"cardinality": {"field": "svc"}}},
    "terms_cardinality": {"a": {"terms": {"field": "svc"}, "aggs": {
        "c": {"cardinality": {"field": "dur"}}}}},
    "extended_stats": {"a": {"terms": {"field": "svc"}, "aggs": {
        "e": _metric("extended_stats")}}},
    "f64_column": {"a": {"terms": {"field": "svc"}, "aggs": {
        "r": _metric("avg", "ratio")}}},
    "u64_past_2_53": {"a": {"terms": {"field": "svc"}, "aggs": {
        "b": _metric("sum", "big")}}},
    "top_stats_squares_past_2_53": {"a": _metric("avg", "big")},
}


def body(aggs: dict) -> dict:
    """The one aggregation of a shape, without its name."""
    (value,) = aggs.values()
    return value


@pytest.mark.parametrize("shape", sorted(ENGAGING))
def test_engaging_plans_take_the_kernel(reader, monkeypatch, shape):
    assert routes(reader, ENGAGING[shape], monkeypatch=monkeypatch) == [True]


@pytest.mark.parametrize("shape", sorted(BYPASSING))
def test_bypassing_plans_take_the_torch_path(reader, monkeypatch, shape):
    assert routes(reader, BYPASSING[shape], monkeypatch=monkeypatch) \
        == [False]


def test_posting_space_takes_the_torch_path(reader, monkeypatch):
    """A single-term query runs over its postings: the `_GatherView`
    gathers each column at the posting's doc id, and the node takes the
    torch path."""
    assert ex._posting_space_eligible(leaf.prepare_plan_only(
        SearchRequest(index_ids=["i"], query_ast=Term("svc", "svc1"),
                      max_hits=0, aggs=ENGAGING["terms_percentiles"]),
        MAPPER, reader, "s"))
    found = routes(reader, ENGAGING["terms_percentiles"],
                   query=Term("svc", "svc1"), monkeypatch=monkeypatch,
                   timed=False)
    assert found == [False]


def test_every_node_of_a_request_routes_on_its_own(reader, monkeypatch):
    aggs = {"p": body(ENGAGING["top_percentiles"]),
            "r": body(BYPASSING["range"]),
            "d": body(ENGAGING["date_histogram_avg_max"])}
    assert routes(reader, aggs, monkeypatch=monkeypatch) \
        == [True, False, True]


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_the_dashboard_panels_take_the_kernel(monkeypatch, panel):
    """The benchmark cell's panels over a small split of its corpus route
    to the kernel."""
    from qwbench import cells
    from qwbench.corpus import otel_traces
    config = cells.load_config("otel-traces-64x512k")
    config["docs_per_split"] = CPU_DOCS
    data, _ = otel_traces.build(config, otel_traces.draw(config, 9, "cpu"))
    storage = RamStorage(Uri.parse("ram:///agg_kernel_otel"))
    storage.put("s.split", data)
    mapper = DocMapper.from_dict(config["doc_mapping"])
    split = SplitReader(storage, "s.split")
    found = []
    evaluate = ex._eval_aggs
    caller = threading.get_ident()

    def spy(nodes, view, scalars, valid):
        for node in nodes if threading.get_ident() == caller else ():
            assert ex._kernel_route(node, view, valid.shape[0]) is not None
            found.append(node)
        return evaluate(nodes, view, scalars, valid)

    monkeypatch.setattr(ex, "_eval_aggs", spy)
    end_us = (config["start_ts"] + config["span_seconds"]) * 1_000_000
    request = SearchRequest(index_ids=["i"], query_ast=MatchAll(),
                            max_hits=0, aggs=PANELS[panel],
                            start_timestamp=end_us - 900 * 1_000_000,
                            end_timestamp=end_us)
    plan = leaf.prepare_plan_only(request, mapper, split, "s")
    arrays, _, _ = leaf.warmup_device_arrays(split, plan, device="cpu")
    leaf.execute_prepared_split(request, mapper, split, "s", plan, arrays,
                                "cpu")
    assert len(found) == 1


# --- the profile counters -------------------------------------------------

def test_profile_counts_nodes_and_kernel_nodes(reader):
    """Three nodes, two of which the card would give the kernel: the CPU
    counts the three and computes none on the kernel (the card's count is
    in `tests/test_torch_cuda_aggs.py`)."""
    aggs = {"p": body(ENGAGING["top_percentiles"]),
            "r": body(BYPASSING["range"]),
            "t": body(ENGAGING["terms_percentiles"])}
    request = SearchRequest(index_ids=["i"], query_ast=MatchAll(),
                            max_hits=0, aggs=aggs)
    plan = leaf.prepare_plan_only(request, MAPPER, reader, "s")
    arrays, _, _ = leaf.warmup_device_arrays(reader, plan, device="cpu")
    profile = QueryProfile("q")
    with profile_scope(profile):
        leaf.execute_prepared_split(request, MAPPER, reader, "s", plan,
                                    arrays, "cpu")
    counters = profile.counters()
    assert counters[AGG_EVALS] == 3
    assert counters[AGG_KERNEL_EVALS] == 0


# --- the wrapper's checks -------------------------------------------------

def _mask(docs=64):
    return torch.ones(docs, dtype=torch.bool)


def _i32(docs=64):
    return ak.Column(torch.zeros(docs, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda: ak.bucket_aggregate(_mask().to(torch.uint8), 1, ak.SKETCH,
                                metric=_i32()),
    lambda: ak.bucket_aggregate(_mask(), 1, ak.COUNTS),
    lambda: ak.bucket_aggregate(_mask(), 0, ak.COUNTS, kind="terms",
                                bucket=_i32()),
    lambda: ak.bucket_aggregate(_mask(), 4, ak.COUNTS, kind="terms",
                                bucket=ak.Column(torch.zeros(
                                    64, dtype=torch.int64))),
    lambda: ak.bucket_aggregate(_mask(), 4, ak.COUNTS, kind="terms",
                                bucket=_i32(32)),
    lambda: ak.bucket_aggregate(_mask(), 1, ak.SUM),
    lambda: ak.bucket_aggregate(_mask(), 1, ak.SUM, stats=True,
                                metric=_i32()),
    lambda: ak.bucket_aggregate(_mask(), 1, ak.SUM, metric=ak.Column(
        torch.zeros(64, dtype=torch.float64))),
    lambda: ak.bucket_aggregate(_mask(), 1, ak.SKETCH, metric=_i32()),
], ids=["mask_dtype", "top_level_counts", "no_buckets", "i64_ordinals",
        "short_column", "metric_without_column", "partial_stats",
        "f64_lanes", "cpu_tensors"])
def test_wrapper_refuses_what_the_kernel_does_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
