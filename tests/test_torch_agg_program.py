"""Every aggregation kind of the port's leaf program against the JAX
package's, on the same split bytes.

Each engine lowers the request with its own lowering and runs its own
program through its own staged leaf entry points (prepare, stage,
execute): the port on CPU torch (`device="cpu"`), the JAX package on the
CPU. The splits: the 30,720- and 50,000-doc hdfs splits of the other port
tests, a 50,000-doc otel-traces split (`synthetic_otel_split`, BASELINE
config 5), and splits written by the JAX package's `SplitWriter` (a
multivalued raw `tags` field, FOR-packed and raw numeric columns, an f64
column holding -0.0, +0.0 and NaN). Covered: every metric kind at the top
level and nested two deep under terms, histogram and date_histogram, in
posting space and in doc space; range with overlapping ranges and every
sub-metric; composite with 1-3 sources, `missing_bucket`, `after`,
metrics and bucket children; multivalued terms; and the finalized
aggregations.

Tolerances:
- exact (bit for bit): hits, counts, sort values and scores; every count,
  min, max, sketch counter, HLL register, composite key and range count;
  f64 `sum`/`sum_sq` of an integer column whose exact total is below
  2^53;
- `rtol=1e-12`: other f64 sums (XLA's CPU reduction order is not torch's)
  and, in the finalized output, every float derived from them (`avg`,
  `variance`, `std_deviation`, ...). Metric names starting `f_` are over
  the f64 column.
"""

import os

import numpy as np
import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    HDFS_MAPPER as J_HDFS_MAPPER, OTEL_BENCH_MAPPER as J_OTEL_MAPPER,
    synthetic_hdfs_split, synthetic_otel_split)
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import leaf as j_leaf
from quickwit_tpu.search.collector import (
    IncrementalCollector as JCollector,
    finalize_aggregations as j_finalize)
from quickwit_tpu.search.models import SearchRequest as JSearchRequest
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER as T_HDFS_MAPPER, OTEL_BENCH_MAPPER as T_OTEL_MAPPER)
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search import leaf as t_leaf
from quickwit_tpu_torch.search.collector import (
    IncrementalCollector as TCollector,
    finalize_aggregations as t_finalize)
from quickwit_tpu_torch.search.models import SearchRequest as TSearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

SPLIT = "split-a"
EXACT_LIMIT = 2.0**53


# --- harness ----------------------------------------------------------------

class Engine:
    def __init__(self, name, Q, Req, leaf, mapper, reader, collector,
                 finalize):
        self.name, self.Q, self.Req, self.leaf = name, Q, Req, leaf
        self.mapper, self.reader = mapper, reader
        self.collector, self.finalize = collector, finalize

    def search(self, query, aggs, max_hits):
        request = self.Req(index_ids=["i"], query_ast=query(self.Q),
                           max_hits=max_hits, aggs=dict(aggs))
        plan = self.leaf.prepare_plan_only(request, self.mapper, self.reader,
                                           SPLIT)
        if self.name == "jax":
            arrays = self.leaf.warmup_device_arrays(self.reader, plan)[0]
            resp = self.leaf.execute_prepared_split(
                request, self.mapper, self.reader, SPLIT, plan, arrays)
        else:
            arrays, _ = self.leaf.warmup_device_arrays(self.reader, plan,
                                                       "cpu")
            resp = self.leaf.execute_prepared_split(
                request, self.mapper, self.reader, SPLIT, plan, arrays,
                "cpu")
        collector = self.collector(max_hits)
        collector.add_leaf_response(resp)
        return plan, resp, self.finalize(collector.aggregation_states())


def engines(data, j_mapper, t_mapper, uri):
    js = JRamStorage(JUri.parse(uri))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse(uri))
    ts.put("s.split", data)
    return (Engine("jax", JQ, JSearchRequest, j_leaf, j_mapper,
                   JSplitReader(js, "s.split"), JCollector, j_finalize),
            Engine("torch", TQ, TSearchRequest, t_leaf, t_mapper,
                   TSplitReader(ts, "s.split"), TCollector, t_finalize))


def _is_sum(key) -> bool:
    return key in ("sum", "sum_sq")


def _close_sum(want, got, path):
    """A sum: exact for an integer column below 2^53, else rtol=1e-12."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    floating = any(part.startswith("f_") for part in path.split("."))
    if not floating and np.all(np.abs(want) < EXACT_LIMIT):
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64), err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=path)


def _exact(want, got, path):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, path
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64), err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def assert_states_match(want, got, path="aggs"):
    """Intermediate aggregation states under the tolerances above."""
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for key in want:
            sub = f"{path}.{key}"
            if _is_sum(key) and isinstance(want[key], (np.ndarray, float)):
                _close_sum(want[key], got[key], sub)
            elif key == "state" and path.count(".") == 1:
                # top-level stats: [count, sum, sum_sq, min, max]
                w, g = np.asarray(want[key]), np.asarray(got[key])
                assert w.dtype == g.dtype and w.shape == g.shape, sub
                _close_sum(w[1:3], g[1:3], sub)
                _exact(w[[0, 3, 4]], g[[0, 3, 4]], sub)
            else:
                assert_states_match(want[key], got[key], sub)
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_states_match(w, g, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        _exact(want, got, path)
    elif isinstance(want, float):
        _exact(np.float64(want), np.float64(got), path)
    else:
        assert want == got, path


def assert_finalized_match(want, got, path="final"):
    """Finalized aggregations: ints and strings exact, floats to
    rtol=1e-12 (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for key in want:
            assert_finalized_match(want[key], got[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_finalized_match(w, g, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=path)
    else:
        assert want == got and type(want) is type(got), path


def hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value)
            for h in resp.partial_hits]


def both(pair, query, aggs, max_hits=0):
    """One request on both engines; asserts the responses and the
    finalized aggregations match. Returns (port plan, port response, port
    finalized aggregations)."""
    j_eng, t_eng = pair
    _, j_resp, j_final = j_eng.search(query, aggs, max_hits)
    t_plan, t_resp, t_final = t_eng.search(query, aggs, max_hits)
    assert t_resp.num_hits == j_resp.num_hits > 0
    assert hits(t_resp) == hits(j_resp)
    assert_states_match(j_resp.intermediate_aggs, t_resp.intermediate_aggs)
    assert_finalized_match(j_final, t_final)
    return t_plan, t_resp, t_final


# --- requests -----------------------------------------------------------------

def metrics(field, prefix="", cardinality=True, extended=True):
    """One aggregation of every metric kind over `field`. Columns whose
    values sit far from zero next to their spread (timestamps, the packed
    u64 field near 2^40) leave out extended_stats: its variance,
    sum_sq / n - mean^2, cancels most digits there (timestamps: ~3e22 from
    terms of ~3e30), so a one-ulp difference in sum_sq, which rtol=1e-12
    allows, shows at 1e-8 or worse in it."""
    out = {
        f"{prefix}sum": {"sum": {"field": field}},
        f"{prefix}avg": {"avg": {"field": field}},
        f"{prefix}count": {"value_count": {"field": field}},
        f"{prefix}min": {"min": {"field": field}},
        f"{prefix}max": {"max": {"field": field}},
        f"{prefix}stats": {"stats": {"field": field}},
        f"{prefix}pct": {"percentiles": {"field": field,
                                         "percents": [1, 50, 95, 99.9]}},
    }
    if extended:
        out[f"{prefix}ext"] = {"extended_stats": {"field": field}}
    if cardinality:
        out[f"{prefix}card"] = {"cardinality": {"field": field}}
    return out


def composite_metrics(field, prefix=""):
    """Every metric kind a composite takes (not percentiles or
    cardinality)."""
    return {name: spec for name, spec in metrics(field, prefix).items()
            if not name.endswith(("pct", "card"))}


def bucket(kind_params, aggs=None):
    spec = dict(kind_params)
    if aggs:
        spec["aggs"] = aggs
    return spec


SEV = {"terms": {"field": "severity_text", "size": 10}}
DAY = {"date_histogram": {"field": "timestamp", "fixed_interval": "1d"}}
TENANT_HIST = {"histogram": {"field": "tenant_id", "interval": 3}}


def error_term(Q):
    return Q.Term("severity_text", "ERROR")


def bool_query(Q):
    return Q.Bool(must=(Q.Term("severity_text", "ERROR"),),
                  should=(Q.Term("body", "term000003"),))


def match_all(Q):
    return Q.MatchAll()


# name -> (query, aggs, max_hits, posting space?)
HDFS_REQUESTS = {
    "top_level_doc_space": (match_all, {
        **metrics("tenant_id"),
        **metrics("timestamp", "ts_", extended=False),
        "sev_card": {"cardinality": {"field": "severity_text"}}}, 0, False),
    "top_level_posting_space": (error_term, {
        **metrics("tenant_id", cardinality=False),
        **metrics("timestamp", "ts_", cardinality=False,
                  extended=False)}, 10, True),
    "terms_date_histogram_posting_space": (error_term, {
        "by_sev": bucket(SEV, {
            **metrics("tenant_id", "l1_", cardinality=False),
            "per_day": bucket(DAY, metrics("tenant_id",
                                           cardinality=False))})}, 10, True),
    "terms_date_histogram_doc_space": (bool_query, {
        "by_sev": bucket(SEV, {
            **metrics("tenant_id", "l1_"),
            "per_day": bucket(DAY, metrics("tenant_id"))})}, 10, False),
    "histogram_terms": (match_all, {
        "by_tenant": bucket(TENANT_HIST, {
            "sev_card": {"cardinality": {"field": "severity_text"}},
            "by_sev": bucket(SEV, {
                **metrics("timestamp", "ts_", extended=False),
                **metrics("tenant_id")})})}, 0, False),
    "date_histogram_histogram_posting_space": (
        lambda Q: Q.Term("severity_text", "WARN"), {
            "per_day": bucket(DAY, {
                "by_tenant": bucket(TENANT_HIST, metrics(
                    "tenant_id", cardinality=False))})}, 10, True),
    "range_overlapping": (bool_query, {
        "r_tenant": bucket({"range": {"field": "tenant_id", "ranges": [
            {"to": 3}, {"from": 2, "to": 7}, {"from": 5}, {"from": 0}]}},
            {**metrics("tenant_id"),
             **metrics("timestamp", "ts_", extended=False),
             "sev_card": {"cardinality": {"field": "severity_text"}}})},
        10, False),
    "range_posting_query": (error_term, {
        "r_ts": bucket({"range": {"field": "timestamp", "ranges": [
            {"to": 1_600_000_000_000_000 + 2 * 86400 * 10**6},
            {"from": 1_600_000_000_000_000 + 86400 * 10**6}]}},
            metrics("tenant_id"))}, 10, False),
}


@pytest.fixture(scope="module", params=[30_720, 50_000])
def hdfs(request):
    return engines(synthetic_hdfs_split(request.param, seed=7),
                   J_HDFS_MAPPER, T_HDFS_MAPPER,
                   f"ram:///aggs-{request.param}")


@pytest.mark.parametrize("name", list(HDFS_REQUESTS))
def test_hdfs_aggregations_match_jax(hdfs, name):
    query, aggs, max_hits, posting = HDFS_REQUESTS[name]
    plan, resp, final = both(hdfs, query, aggs, max_hits)
    assert t_executor._posting_space_eligible(plan) == posting
    if max_hits:
        assert len(resp.partial_hits) == max_hits


COMPOSITE = {
    "one_source": {"sources": [{"sev": SEV}], "size": 3},
    "two_sources": {"sources": [{"sev": SEV}, {"day": DAY}], "size": 5},
    # 100 runs: the segment reductions take the sort path (> 64 buckets)
    "three_sources": {"sources": [
        {"day": DAY}, {"sev": SEV},
        {"tenant": {"histogram": {"field": "tenant_id", "interval": 2}}}],
        "size": 100},
}


@pytest.mark.parametrize("space", ["doc_space", "posting_space"])
@pytest.mark.parametrize("name", list(COMPOSITE))
def test_composite_pages_match_jax(hdfs, name, space):
    """Page 1, then page 2 through the finalized `after_key`, with every
    metric kind a composite takes and a terms child; over every doc, and
    over a Term query's postings (the composite runs over the [P] posting
    lanes)."""
    query = match_all if space == "doc_space" else (
        lambda Q: Q.Term("body", "term000003"))
    spec = {"composite": dict(COMPOSITE[name]), "aggs": {
        **composite_metrics("tenant_id"),
        "ts_max": {"max": {"field": "timestamp"}},
        "tenants": {"terms": {"field": "tenant_id", "size": 10}}}}
    plan, _, final = both(hdfs, query, {"c": spec}, 10)
    assert t_executor._posting_space_eligible(plan) == (
        space == "posting_space")
    page1 = final["c"]["buckets"]
    assert len(page1) == COMPOSITE[name]["size"]
    spec["composite"]["after"] = final["c"]["after_key"]
    _, _, final2 = both(hdfs, query, {"c": spec}, 10)
    keys1 = [tuple(b["key"].values()) for b in page1]
    keys2 = [tuple(b["key"].values()) for b in final2["c"]["buckets"]]
    assert keys2 and keys1[-1] < keys2[0]


# --- otel-traces (BASELINE config 5) --------------------------------------------

DURATION = "span_duration_micros"
OTEL_REQUESTS = {
    "c5_percentiles": {"p": {"percentiles": {
        "field": DURATION, "percents": [50, 95, 99]}}},
    "latency_by_service": {
        "by_service": bucket({"terms": {"field": "service_name",
                                        "size": 10}}, {
            "p": {"percentiles": {"field": DURATION,
                                  "percents": [50, 95, 99]}},
            "ext": {"extended_stats": {"field": DURATION}},
            "card": {"cardinality": {"field": DURATION}}}),
        "per_minute": bucket({"date_histogram": {
            "field": "span_start_timestamp", "fixed_interval": "1m"}}, {
            "avg": {"avg": {"field": DURATION}},
            "max": {"max": {"field": DURATION}}})},
    "duration_ranges": {"r_duration": bucket({"range": {
        "field": DURATION, "ranges": [
            {"to": 5000}, {"from": 2000, "to": 20000}, {"from": 10000}]}},
        {**metrics(DURATION),
         "svc_card": {"cardinality": {"field": "service_name"}}})},
    "all_metrics": metrics(DURATION),
}


@pytest.fixture(scope="module")
def otel():
    return engines(synthetic_otel_split(50_000, seed=7), J_OTEL_MAPPER,
                   T_OTEL_MAPPER, "ram:///aggs-otel")


@pytest.mark.parametrize("name", list(OTEL_REQUESTS))
def test_otel_aggregations_match_jax(otel, name):
    _, resp, final = both(otel, match_all, OTEL_REQUESTS[name], 0)
    assert resp.num_hits == 50_000
    if name == "c5_percentiles":
        assert len(final["p"]["values"]) == 3


# --- splits written by SplitWriter ---------------------------------------------

def _written_mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("timestamp", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("severity_text", dm.FieldType.TEXT,
                            tokenizer="raw", fast=True),
            dm.FieldMapping("tags", dm.FieldType.TEXT, tokenizer="raw",
                            fast=True),
            dm.FieldMapping("packed_u64", dm.FieldType.U64, fast=True),
            dm.FieldMapping("code", dm.FieldType.I64, fast=True),
            dm.FieldMapping("score", dm.FieldType.F64, fast=True),
        ],
        timestamp_field="timestamp")


def _written_corpus():
    rng = np.random.RandomState(21)
    vocab = [f"tag{i:02d}" for i in range(50)]
    docs = []
    for i in range(4000):
        doc = {"timestamp": 1_600_000_000 + i * 90,
               "severity_text": ["INFO", "WARN", "ERROR"][i % 3],
               "tags": list(rng.choice(vocab, rng.randint(1, 5))),
               "packed_u64": int(2**40 + rng.randint(0, 60_000) * 3),
               "score": float(rng.choice([-0.0, 0.0, 0.5, -1.25, 7.0]))}
        if i % 11:
            doc["code"] = int(rng.randint(-500, 500))
        if i == 1234:
            doc["score"] = float("nan")
        docs.append(doc)
    return docs


def _written_engines(packed: bool):
    from quickwit_tpu.index.writer import SplitWriter
    from quickwit_tpu.models import doc_mapper as jdm
    from quickwit_tpu_torch.models import doc_mapper as tdm
    prev = os.environ.get("QW_DISABLE_PACKED")
    os.environ["QW_DISABLE_PACKED"] = "0" if packed else "1"
    try:
        writer = SplitWriter(_written_mapper(jdm))
        for doc in _written_corpus():
            writer.add_json_doc(doc)
        data = writer.finish()
    finally:
        if prev is None:
            os.environ.pop("QW_DISABLE_PACKED")
        else:
            os.environ["QW_DISABLE_PACKED"] = prev
    return engines(data, _written_mapper(jdm), _written_mapper(tdm),
                   f"ram:///aggs-written-{'packed' if packed else 'raw'}")


@pytest.fixture(scope="module", params=["packed", "raw"])
def written(request):
    return request.param, _written_engines(request.param == "packed")


def packed_range(Q):
    return Q.Range("packed_u64", lower=Q.RangeBound(2**40 + 30_000, True),
                   upper=Q.RangeBound(2**40 + 150_000, False))


WRITTEN_REQUESTS = {
    "terms_mv": (match_all, {"tags": {"terms": {"field": "tags",
                                                "size": 50}}}),
    "terms_mv_packed_range": (packed_range, {
        "tags": {"terms": {"field": "tags", "size": 5}},
        **metrics("packed_u64", "u_", extended=False)}),
    "f64_zeros_nan_top_level": (match_all, metrics("score", "f_")),
    "f64_zeros_nan_nested": (packed_range, {
        "by_sev": bucket(SEV, {
            **metrics("score", "f_"),
            "per_hour": bucket({"date_histogram": {
                "field": "timestamp", "fixed_interval": "1h"}},
                {**metrics("score", "f_"), **metrics("code", "c_")})})}),
    "composite_missing_bucket": (match_all, {"c": {
        "composite": {"size": 40, "sources": [
            {"sev": SEV},
            {"code": {"histogram": {"field": "code", "interval": 100,
                                    "missing_bucket": True}}},
            {"u": {"histogram": {"field": "packed_u64",
                                 "interval": 50_000}}}]},
        "aggs": {**composite_metrics("code", "c_"),
                 "by_hour": bucket({"date_histogram": {
                     "field": "timestamp", "fixed_interval": "1h"}})}}}),
}


@pytest.mark.parametrize("name", list(WRITTEN_REQUESTS))
def test_written_split_aggregations_match_jax(written, name):
    layout, pair = written
    query, aggs = WRITTEN_REQUESTS[name]
    plan, resp, final = both(pair, query, aggs)
    if name == "terms_mv":
        assert any(a.kind == "terms_mv" for a in plan.aggs)
        assert sum(b["doc_count"] for b in final["tags"]["buckets"]) > \
            resp.num_hits
    if layout == "packed" and name == "terms_mv_packed_range":
        assert plan.rebase


def test_missing_bucket_page_two_matches_jax(written):
    """A composite page 2 whose `after` holds a missing (null) key."""
    _, pair = written
    spec = {"composite": {"size": 7, "sources": [
        {"code": {"histogram": {"field": "code", "interval": 250,
                                "missing_bucket": True}}},
        {"sev": SEV}]}}
    _, _, final = both(pair, match_all, {"c": spec})
    assert final["c"]["buckets"][0]["key"]["code"] is None
    spec["composite"]["after"] = final["c"]["after_key"]
    both(pair, match_all, {"c": spec})


def test_range_bounds_of_a_later_request_are_its_own(hdfs):
    """Two requests on one reader with a range agg of the same name and
    other ranges: the second counts over its own bounds. The staging key
    holds the bounds' bytes (the JAX package keys them by name alone, and
    its second request reuses the first one's staged bounds), so the port
    is held against the JAX package on a fresh reader."""
    _, t_eng = hdfs
    first = {"r": {"range": {"field": "tenant_id", "ranges": [
        {"to": 3}, {"from": 2, "to": 7}, {"from": 5}, {"from": 0}]}}}
    second = {"r": {"range": {"field": "tenant_id", "ranges": [
        {"from": 4, "to": 6}, {"to": 1}]}}}
    t_eng.search(match_all, first, 0)
    _, resp, _ = t_eng.search(match_all, second, 0)
    data = t_eng.reader.storage.get_all("s.split")
    fresh_jax, _ = engines(data, J_HDFS_MAPPER, T_HDFS_MAPPER,
                           "ram:///aggs-fresh")
    _, want, _ = fresh_jax.search(match_all, second, 0)
    np.testing.assert_array_equal(resp.intermediate_aggs["r"]["counts"],
                                  want.intermediate_aggs["r"]["counts"])
    tenants = t_eng.reader.column_values("tenant_id")[0][:resp.num_hits]
    assert resp.intermediate_aggs["r"]["counts"].tolist() == [
        int(((tenants >= 4) & (tenants < 6)).sum()), int((tenants < 1).sum())]
