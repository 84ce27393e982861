"""The port's single-split leaf search against the JAX package's, end to end.

Both engines read one split written by the JAX package's generator and
answer the same requests; hits, counts, intermediate aggregation states and
the finalized (user-visible) aggregations must be equal. The port runs on
the CPU (`device="cpu"`), where its fused score + top-k step takes the
kernel's plain torch version.
"""

import numpy as np
import pytest

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    HDFS_MAPPER as J_HDFS_MAPPER, body_term, synthetic_hdfs_split)
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search.collector import (
    IncrementalCollector as JCollector,
    finalize_aggregations as j_finalize)
from quickwit_tpu.search.leaf import (
    leaf_search_single_split as j_leaf_search)
from quickwit_tpu.search.models import SearchRequest as JSearchRequest
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER as T_HDFS_MAPPER
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search.collector import (
    IncrementalCollector as TCollector,
    finalize_aggregations as t_finalize)
from quickwit_tpu_torch.search.leaf import (
    leaf_search_single_split as t_leaf_search)
from quickwit_tpu_torch.search.models import SearchRequest as TSearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

AGGS = {"over_time": {"date_histogram": {"field": "timestamp",
                                         "fixed_interval": "1d"}},
        "severities": {"terms": {"field": "severity_text", "size": 10}}}

# name -> (query builder over an ast module, max_hits, aggs)
REQUESTS = {
    "flagship": (lambda Q: Q.Term("severity_text", "ERROR"), 10, AGGS),
    "c1_term_top10": (lambda Q: Q.Term("severity_text", "ERROR"), 10, None),
    "c3_agg_only": (lambda Q: Q.Term("severity_text", "ERROR"), 0, AGGS),
    "body_top10": (lambda Q: Q.Term("body", body_term(3)), 10, None),
}


def _request(engine: str, name: str):
    build, max_hits, aggs = REQUESTS[name]
    Q, Req = (JQ, JSearchRequest) if engine == "jax" else (TQ, TSearchRequest)
    return Req(index_ids=["hdfs-logs"], query_ast=build(Q), max_hits=max_hits,
               aggs=dict(aggs) if aggs else {})


@pytest.fixture(scope="module", params=[30_720, 50_000])
def readers(request):
    """(jax reader, port reader) over one JAX-written split."""
    data = synthetic_hdfs_split(request.param, seed=7)
    js = JRamStorage(JUri.parse("ram:///leaf"))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse("ram:///leaf"))
    ts.put("s.split", data)
    return JSplitReader(js, "s.split"), TSplitReader(ts, "s.split")


def _hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def _assert_same_state(a, b, path="aggs"):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same_state(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(REQUESTS))
def test_leaf_matches_jax(readers, name):
    j_reader, t_reader = readers
    j_resp = j_leaf_search(_request("jax", name), J_HDFS_MAPPER, j_reader,
                           "split-a")
    t_resp = t_leaf_search(_request("torch", name), T_HDFS_MAPPER, t_reader,
                           "split-a", device="cpu")
    assert t_resp.num_hits == j_resp.num_hits > 0
    assert _hits(t_resp) == _hits(j_resp)
    assert len(t_resp.partial_hits) == min(REQUESTS[name][1], j_resp.num_hits)
    assert (t_resp.num_attempted_splits, t_resp.num_successful_splits,
            t_resp.failed_splits) == (1, 1, [])
    _assert_same_state(t_resp.intermediate_aggs, j_resp.intermediate_aggs)

    # what a user sees: the collector's hits and finalized aggregations
    max_hits = REQUESTS[name][1]
    j_col, t_col = JCollector(max_hits), TCollector(max_hits)
    j_col.add_leaf_response(j_resp)
    t_col.add_leaf_response(t_resp)
    assert ([(h.doc_id, h.sort_value) for h in t_col.partial_hits()]
            == [(h.doc_id, h.sort_value) for h in j_col.partial_hits()])
    j_aggs = j_finalize(j_col.aggregation_states())
    t_aggs = t_finalize(t_col.aggregation_states())
    assert t_aggs == j_aggs
    if REQUESTS[name][2]:
        buckets = t_aggs["severities"]["buckets"]
        assert sum(b["doc_count"] for b in buckets) == t_resp.num_hits


# --- a split from the JAX package's document writer ---------------------------
# FOR-packed columns (rebased in the posting-space gather), positional text
# with varying tf, and an f64 column for a float histogram.

WRITER_AGGS = {
    "per_hour": {"date_histogram": {"field": "timestamp",
                                    "fixed_interval": "1h"}},
    # 700 buckets: past the compare-and-reduce bucket limit
    "per_minute": {"date_histogram": {"field": "timestamp",
                                      "fixed_interval": "1m"}},
    "latency": {"histogram": {"field": "latency", "interval": 25.0}},
    "severities": {"terms": {"field": "severity_text", "size": 10}},
    "tenants": {"terms": {"field": "severity_text", "size": 2},
                "aggs": {"hours": {"date_histogram": {
                    "field": "timestamp", "fixed_interval": "2h"}}}},
}

# name -> (query builder, max_hits, aggs, sort)
WRITER_REQUESTS = {
    "error_top10_aggs": (lambda Q: Q.Term("severity_text", "ERROR"), 10,
                         WRITER_AGGS, None),
    "alpha_bm25_top10": (lambda Q: Q.Term("body", "alpha"), 10, WRITER_AGGS,
                         None),
    # body postings keep doc order (positions recorded), so a field sort
    # stays in posting space and keys on the packed timestamp column
    "gamma_by_timestamp": (lambda Q: Q.Term("body", "gamma"), 5, {},
                           ("timestamp", "asc")),
    "beta_top100": (lambda Q: Q.Term("body", "beta"), 100, {}, None),
}


def _writer_mapper(FieldMapping, FieldType, DocMapper):
    return DocMapper(
        field_mappings=[
            FieldMapping("timestamp", FieldType.DATETIME, fast=True,
                         input_formats=("unix_timestamp",)),
            FieldMapping("tenant_id", FieldType.U64, fast=True),
            FieldMapping("severity_text", FieldType.TEXT, tokenizer="raw",
                         fast=True),
            FieldMapping("body", FieldType.TEXT, record="position"),
            FieldMapping("latency", FieldType.F64, fast=True),
        ],
        timestamp_field="timestamp", default_search_fields=("body",))


@pytest.fixture(scope="module")
def writer_split():
    from quickwit_tpu.index.writer import SplitWriter
    from quickwit_tpu.models import doc_mapper as jdm
    from quickwit_tpu_torch.models import doc_mapper as tdm
    rng = np.random.RandomState(42)
    j_mapper = _writer_mapper(jdm.FieldMapping, jdm.FieldType, jdm.DocMapper)
    writer = SplitWriter(j_mapper)
    for i in range(700):
        words = (["alpha"] * int(rng.randint(1, 4))
                 + ["beta"] * int(rng.randint(0, 3)) + ["gamma"])
        rng.shuffle(words)
        writer.add_json_doc({
            "timestamp": 1_600_000_000 + i * 60,
            "tenant_id": int(rng.randint(0, 5)),
            "severity_text": ["DEBUG", "INFO", "WARN", "ERROR"][
                int(rng.randint(0, 4))],
            "body": " ".join(words),
            "latency": float(rng.gamma(2.0, 50.0)),
        })
    data = writer.finish()
    js = JRamStorage(JUri.parse("ram:///writer"))
    js.put("w.split", data)
    ts = TRamStorage(TUri.parse("ram:///writer"))
    ts.put("w.split", data)
    t_mapper = _writer_mapper(tdm.FieldMapping, tdm.FieldType, tdm.DocMapper)
    return (JSplitReader(js, "w.split"), j_mapper,
            TSplitReader(ts, "w.split"), t_mapper)


@pytest.mark.parametrize("name", list(WRITER_REQUESTS))
def test_leaf_matches_jax_on_writer_split(writer_split, name):
    from quickwit_tpu.search.models import SortField as JSortField
    from quickwit_tpu_torch.search.models import SortField as TSortField
    j_reader, j_mapper, t_reader, t_mapper = writer_split
    build, max_hits, aggs, sort = WRITER_REQUESTS[name]
    assert j_reader.column_packing("timestamp") is not None

    def request(Q, Req, SortField):
        extra = {"sort_fields": (SortField(*sort),)} if sort else {}
        return Req(index_ids=["w"], query_ast=build(Q), max_hits=max_hits,
                   aggs=dict(aggs), **extra)

    j_resp = j_leaf_search(request(JQ, JSearchRequest, JSortField), j_mapper,
                           j_reader, "split-w")
    t_resp = t_leaf_search(request(TQ, TSearchRequest, TSortField), t_mapper,
                           t_reader, "split-w", device="cpu")
    assert t_resp.num_hits == j_resp.num_hits > 0
    assert _hits(t_resp) == _hits(j_resp)
    _assert_same_state(t_resp.intermediate_aggs, j_resp.intermediate_aggs)
    j_col, t_col = JCollector(max_hits), TCollector(max_hits)
    j_col.add_leaf_response(j_resp)
    t_col.add_leaf_response(t_resp)
    assert t_finalize(t_col.aggregation_states()) == \
        j_finalize(j_col.aggregation_states())
