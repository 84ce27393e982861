"""The port's doc-space leaf program against the JAX package's.

Both engines read the same split bytes (written by the JAX package), lower
the same request with their own lowering and run their own program: the
port on CPU torch (`device="cpu"`), the JAX package on the CPU. Every
comparison is exact: doc ids, counts, f64 sort values (both keys), f32
hit scores, raw sort values and aggregation states.

Covered: `bench.py`'s c2 request, Bool shapes (must_not,
minimum_should_match, should-only, exists), MatchAll/MatchNone, range
bounds on the i32-seconds, i64 and f64-promoted paths, FOR-packed and raw
zonemapped splits, search_after in each relation, two-key sorts in both
spaces, threshold pushdown in both spaces, and the mask-fill program with
`mask_override`. Unit cases hold `range_mask`, the compare types,
`minimum_should_match_mask`, `exact_topk_2key`, `block_max_threshold_mask`
and the mask packing against their JAX functions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.synthetic import (
    HDFS_MAPPER as J_HDFS_MAPPER, body_term, synthetic_hdfs_split)
from quickwit_tpu.index.writer import _column_zonemaps
from quickwit_tpu.ops import masks as j_masks
from quickwit_tpu.ops import topk as j_topk
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import executor as j_executor
from quickwit_tpu.search import leaf as j_leaf
from quickwit_tpu.search.models import (
    SearchRequest as JSearchRequest, SortField as JSortField)
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.index.synthetic import HDFS_MAPPER as T_HDFS_MAPPER
from quickwit_tpu_torch.ops import masks as t_masks
from quickwit_tpu_torch.ops import topk as t_topk
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search import leaf as t_leaf
from quickwit_tpu_torch.search.models import (
    SearchRequest as TSearchRequest, SortField as TSortField)
from quickwit_tpu_torch.search.plan import PRange
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

DAY_US = 86400 * 1_000_000
T0_US = 1_600_000_000 * 1_000_000
SPLIT = "split-m"

AGGS = {"over_time": {"date_histogram": {"field": "timestamp",
                                         "fixed_interval": "1d"}},
        "severities": {"terms": {"field": "severity_text", "size": 10}}}


def c2_query(Q):
    """`bench.py`'s c2_bool_range_top100 query, verbatim."""
    return Q.Bool(
        must=(Q.Term("severity_text", "ERROR"),),
        should=(Q.Term("body", body_term(3)), Q.Term("body", body_term(7))),
        filter=(Q.Range("timestamp",
                        lower=Q.RangeBound(T0_US + DAY_US, True),
                        upper=Q.RangeBound(T0_US + 4 * DAY_US, False)),))


# --- harness ----------------------------------------------------------------

class Engine:
    """One side of the comparison: its own modules, types and reader."""

    def __init__(self, name, Q, Req, SortField, leaf, mapper, reader):
        self.name, self.Q, self.Req, self.SortField = name, Q, Req, SortField
        self.leaf, self.mapper, self.reader = leaf, mapper, reader

    def request(self, query, max_hits=100, sort=(), aggs=None,
                search_after=None):
        sort_fields = tuple(self.SortField(*s) for s in sort) or (
            self.SortField(),)
        return self.Req(index_ids=["i"], query_ast=query(self.Q),
                        max_hits=max_hits, sort_fields=sort_fields,
                        aggs=dict(aggs) if aggs else {},
                        search_after=search_after)

    def search(self, request, threshold=None, mask=None):
        extra = {}
        if mask is not None:
            extra = {"mask_override": mask, "mask_key": "mask.test"}
        if self.name == "jax":
            plan = self.leaf.prepare_plan_only(
                request, self.mapper, self.reader, SPLIT,
                sort_value_threshold=threshold, **extra)
            arrays, _, _ = self.leaf.warmup_device_arrays(self.reader, plan)
            resp = self.leaf.execute_prepared_split(
                request, self.mapper, self.reader, SPLIT, plan, arrays)
        else:
            plan = self.leaf.prepare_plan_only(
                request, self.mapper, self.reader, SPLIT,
                sort_value_threshold=threshold, **extra)
            arrays, _ = self.leaf.warmup_device_arrays(self.reader, plan,
                                                       "cpu")
            resp = self.leaf.execute_prepared_split(
                request, self.mapper, self.reader, SPLIT, plan, arrays,
                "cpu")
        return plan, resp


def engines(data, j_mapper, t_mapper, uri):
    js = JRamStorage(JUri.parse(uri))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse(uri))
    ts.put("s.split", data)
    return (Engine("jax", JQ, JSearchRequest, JSortField, j_leaf, j_mapper,
                   JSplitReader(js, "s.split")),
            Engine("torch", TQ, TSearchRequest, TSortField, t_leaf, t_mapper,
                   TSplitReader(ts, "s.split")))


def hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def assert_same_state(a, b, path="aggs"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            assert_same_state(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def both(pair, query, threshold=None, masks=(None, None), **req):
    """Run one request on both engines, assert the responses equal, and
    return (port plan, port response)."""
    j_eng, t_eng = pair
    _, j_resp = j_eng.search(j_eng.request(query, **req), threshold,
                             masks[0])
    t_plan, t_resp = t_eng.search(t_eng.request(query, **req), threshold,
                                  masks[1])
    assert t_resp.num_hits == j_resp.num_hits
    assert hits(t_resp) == hits(j_resp)
    assert_same_state(t_resp.intermediate_aggs, j_resp.intermediate_aggs)
    return t_plan, t_resp


@pytest.fixture(scope="module")
def hdfs():
    return engines(synthetic_hdfs_split(50_000, seed=7), J_HDFS_MAPPER,
                   T_HDFS_MAPPER, "ram:///docspace")


# --- c2 ---------------------------------------------------------------------

def test_c2_program_matches_jax(hdfs):
    """Each side's own lowering and `_build`, through `execute_plan`: the
    whole result tree, dead lanes included, is equal."""
    j_eng, t_eng = hdfs
    j_plan = j_lower(c2_query(JQ), J_HDFS_MAPPER, j_eng.reader, [])
    t_plan = t_lower(c2_query(TQ), T_HDFS_MAPPER, t_eng.reader, [])
    assert not t_executor._posting_space_eligible(t_plan)
    j_res = j_executor.execute_plan(
        j_plan, 100, [jnp.asarray(a) for a in j_plan.arrays])
    t_res = t_executor.execute_plan(
        t_plan, 100, [torch.from_numpy(np.array(a)) for a in t_plan.arrays],
        device="cpu")
    assert t_res["count"] == j_res["count"] > 100
    assert t_res["sort_values2"] is None and j_res["sort_values2"] is None
    for key in ("sort_values", "doc_ids", "scores"):
        want = np.asarray(j_res[key])
        assert t_res[key].dtype == want.dtype, key
        np.testing.assert_array_equal(t_res[key], want)


def test_c2_leaf_matches_jax(hdfs):
    """`leaf_search_single_split` on both sides, then the staged entry
    points (prepare, stage, execute) on both sides."""
    j_eng, t_eng = hdfs
    j_resp = j_leaf.leaf_search_single_split(
        j_eng.request(c2_query), J_HDFS_MAPPER, j_eng.reader, SPLIT)
    t_resp = t_leaf.leaf_search_single_split(
        t_eng.request(c2_query), T_HDFS_MAPPER, t_eng.reader, SPLIT,
        device="cpu")
    assert t_resp.num_hits == j_resp.num_hits > 100
    assert hits(t_resp) == hits(j_resp) and len(t_resp.partial_hits) == 100
    _, resp = both(hdfs, c2_query)
    assert hits(resp) == hits(t_resp)
    # the s32 datetime path carries the range
    plan = hdfs[1].search(hdfs[1].request(c2_query))[0]
    ranges = [n for n in plan.root.filter if isinstance(n, PRange)]
    assert plan.arrays[ranges[0].values_slot].dtype == np.int32


# --- query shapes -------------------------------------------------------------

SHAPES = {
    "must_not": (lambda Q: Q.Bool(
        must=(Q.Term("severity_text", "ERROR"),),
        must_not=(Q.Term("body", body_term(3)),)), {}),
    "minimum_should_match": (lambda Q: Q.Bool(
        should=(Q.Term("body", body_term(3)), Q.Term("body", body_term(7)),
                Q.Term("severity_text", "WARN")),
        minimum_should_match=2), {}),
    "should_only_or": (lambda Q: Q.Bool(
        should=(Q.Term("severity_text", "ERROR"),
                Q.Term("severity_text", "WARN"))), AGGS),
    "exists_ordinal": (lambda Q: Q.FieldPresence("severity_text"), AGGS),
    "exists_text": (lambda Q: Q.Bool(
        must=(Q.FieldPresence("body"),),
        must_not=(Q.Term("severity_text", "INFO"),)), {}),
    "match_all": (lambda Q: Q.MatchAll(), AGGS),
    "match_none": (lambda Q: Q.MatchNone(), AGGS),
    "filter_only_count": (lambda Q: Q.Bool(
        filter=(Q.Term("severity_text", "WARN"),
                Q.Range("tenant_id", lower=Q.RangeBound(2, True)))), AGGS),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_query_shape_matches_jax(hdfs, name):
    query, aggs = SHAPES[name]
    _, resp = both(hdfs, query, aggs=aggs, max_hits=50)
    if name != "match_none":
        assert resp.num_hits > 0
    if aggs:
        buckets = resp.intermediate_aggs["severities"]["counts"]
        assert int(buckets.sum()) == resp.num_hits


def test_count_only_matches_jax(hdfs):
    _, resp = both(hdfs, SHAPES["should_only_or"][0], aggs=AGGS, max_hits=0)
    assert resp.num_hits > 0 and resp.partial_hits == []


# --- range bounds -------------------------------------------------------------

def _range(field, lo=None, lo_incl=True, hi=None, hi_incl=True):
    def query(Q):
        return Q.Range(field,
                       lower=Q.RangeBound(lo, lo_incl) if lo is not None
                       else None,
                       upper=Q.RangeBound(hi, hi_incl) if hi is not None
                       else None)
    return query


RANGES = {
    # whole seconds, inclusive lower, exclusive upper: the i32-seconds path
    "datetime_s32": (_range("timestamp", T0_US + DAY_US, True,
                            T0_US + 2 * DAY_US, False), np.int32),
    # exclusive lower: the i64 path
    "datetime_i64_exclusive": (_range("timestamp", T0_US + DAY_US, False,
                                      T0_US + 2 * DAY_US, True), np.int64),
    # a sub-second bound: the i64 path
    "datetime_i64_subsecond": (_range("timestamp", T0_US + DAY_US + 500_000,
                                      True, T0_US + DAY_US + 7_200_000_001,
                                      True), np.int64),
    # an i64 column against u64 bounds: compared in f64
    "u64_bounds": (_range("tenant_id", 3, False, 7, True), np.int64),
    "u64_above_2_53": (_range("tenant_id", 2**53 + 1, True), np.int64),
    "u64_upper_above_2_63": (_range("tenant_id", 4, True, 2**63 + 5, False),
                             np.int64),
}


@pytest.mark.parametrize("name", list(RANGES))
def test_range_bounds_match_jax(hdfs, name):
    query, values_dtype = RANGES[name]
    plan, _ = both(hdfs, query, max_hits=20, sort=(("timestamp", "asc"),))
    assert plan.arrays[plan.root.values_slot].dtype == values_dtype


# --- packed and raw zonemapped splits ------------------------------------------

def _writer_corpus():
    rng = np.random.RandomState(11)
    docs = []
    for i in range(3000):
        doc = {
            "timestamp": 1_600_000_000 + i * 60,       # u16 lanes
            "tenant_id": int(rng.randint(0, 7)),        # u8 lanes
            "severity_text": ["INFO", "WARN", "ERROR"][i % 3],
            "big": int(rng.randint(0, 3_000_000)),      # u32 lanes
            "latency": float(rng.gamma(2.0, 50.0)),     # f64, never packed
            "body": " ".join(rng.choice(["alpha", "beta", "gamma", "delta"],
                                        int(rng.randint(1, 5)))),
        }
        if i % 13 != 0:
            doc["code"] = int(rng.randint(-500, 500))   # negatives + nulls
        docs.append(doc)
    return docs


def _writer_mapper(FieldMapping, FieldType, DocMapper):
    return DocMapper(
        field_mappings=[
            FieldMapping("timestamp", FieldType.DATETIME, fast=True,
                         input_formats=("unix_timestamp",)),
            FieldMapping("tenant_id", FieldType.U64, fast=True),
            FieldMapping("severity_text", FieldType.TEXT, tokenizer="raw",
                         fast=True),
            FieldMapping("big", FieldType.I64, fast=True),
            FieldMapping("latency", FieldType.F64, fast=True),
            FieldMapping("code", FieldType.I64, fast=True),
            FieldMapping("body", FieldType.TEXT),
        ],
        timestamp_field="timestamp", default_search_fields=("body",))


def _writer_engines(packed: bool):
    from quickwit_tpu.index.writer import SplitWriter
    from quickwit_tpu.models import doc_mapper as jdm
    from quickwit_tpu_torch.models import doc_mapper as tdm
    j_mapper = _writer_mapper(jdm.FieldMapping, jdm.FieldType, jdm.DocMapper)
    t_mapper = _writer_mapper(tdm.FieldMapping, tdm.FieldType, tdm.DocMapper)
    prev = os.environ.get("QW_DISABLE_PACKED")
    os.environ["QW_DISABLE_PACKED"] = "0" if packed else "1"
    try:
        writer = SplitWriter(j_mapper)
        for doc in _writer_corpus():
            writer.add_json_doc(doc)
        data = writer.finish()
    finally:
        if prev is None:
            os.environ.pop("QW_DISABLE_PACKED")
        else:
            os.environ["QW_DISABLE_PACKED"] = prev
    return engines(data, j_mapper, t_mapper,
                   f"ram:///writer-{'packed' if packed else 'raw'}")


@pytest.fixture(scope="module", params=["packed", "raw"])
def written(request):
    return request.param, _writer_engines(request.param == "packed")


WRITER_REQUESTS = {
    "ranges_and": (lambda Q: Q.Bool(
        must=(Q.Term("body", "alpha"),),
        filter=(Q.Range("timestamp",
                        lower=Q.RangeBound(1_600_000_000 + 600 * 60, True),
                        upper=Q.RangeBound(1_600_000_000 + 2400 * 60, False)),
                Q.Range("tenant_id", lower=Q.RangeBound(2, False),
                        upper=Q.RangeBound(5, True)),
                Q.Range("big", lower=Q.RangeBound(70_000, True)),
                Q.Range("code", lower=Q.RangeBound(-100, True),
                        upper=Q.RangeBound(250, False)))),
     (), {"tenants": {"terms": {"field": "severity_text", "size": 5}},
          "per_hour": {"date_histogram": {"field": "timestamp",
                                          "fixed_interval": "1h"}}}),
    # out-of-frame bounds clamp to never-matching deltas
    "out_of_frame": (lambda Q: Q.Bool(should=(
        Q.Range("code", lower=Q.RangeBound(10_000, True)),
        Q.Range("big", upper=Q.RangeBound(-5, True)),
        Q.Range("tenant_id", lower=Q.RangeBound(3, True),
                upper=Q.RangeBound(3, True)))),
        (("big", "desc"),), {}),
    "sorted_by_packed_columns": (lambda Q: Q.Bool(
        must_not=(Q.Range("code", upper=Q.RangeBound(0, False)),)),
        (("code", "desc"), ("timestamp", "asc")), {}),
    "latency_range_by_latency": (lambda Q: Q.Range(
        "latency", lower=Q.RangeBound(40.5, True),
        upper=Q.RangeBound(90.25, False)), (("latency", "asc"),), {}),
    "exists_code_by_tenant": (lambda Q: Q.FieldPresence("code"),
                              (("tenant_id", "asc"), ("code", "desc")), {}),
}


@pytest.mark.parametrize("name", list(WRITER_REQUESTS))
def test_written_split_matches_jax(written, name):
    layout, pair = written
    query, sort, aggs = WRITER_REQUESTS[name]
    plan, resp = both(pair, query, max_hits=40, sort=sort, aggs=aggs)
    assert resp.num_hits > 0
    if layout == "packed" and name == "ranges_and":
        lanes = {str(a.dtype) for a in plan.arrays}
        assert {"uint8", "uint16", "uint32"} <= lanes


# --- search_after --------------------------------------------------------------

def _page_two_equals_hits_101_to_200(pair, query, sort):
    _, top200 = both(pair, query, max_hits=200, sort=sort)
    _, page1 = both(pair, query, max_hits=100, sort=sort)
    last = page1.partial_hits[-1]
    marker = [last.raw_sort_value]
    if len(sort) > 1:
        marker.append(last.raw_sort_value2)
    marker += [SPLIT, last.doc_id]
    _, page2 = both(pair, query, max_hits=100, sort=sort,
                    search_after=marker)
    assert hits(page2) == hits(top200)[100:200]


def test_search_after_page_two_by_score(hdfs):
    _page_two_equals_hits_101_to_200(hdfs, c2_query, ())


def test_search_after_page_two_two_keys(hdfs):
    _page_two_equals_hits_101_to_200(
        hdfs, c2_query, (("timestamp", "desc"), ("tenant_id", "asc")))


# (marker, sort): split ids before, equal to and after SPLIT give the
# relations lt, lt_tie and le
SEARCH_AFTER = {
    "lt_one_key": (lambda: [1_600_100_000_000_000, "split-z", 0],
                   (("timestamp", "desc"),)),
    "le_one_key": (lambda: [1_600_100_000_000_000, "split-a", 0],
                   (("timestamp", "desc"),)),
    "lt_tie_one_key": (lambda: [5, SPLIT, 20_000], (("tenant_id", "asc"),)),
    "value_only": (lambda: [5, None, 0], (("tenant_id", "desc"),)),
    "lt_two_keys": (lambda: [4, 1_600_200_000_000_000, "split-z", 0],
                    (("tenant_id", "asc"), ("timestamp", "desc"))),
    "le_two_keys": (lambda: [4, 1_600_200_000_000_000, "split-a", 0],
                    (("tenant_id", "asc"), ("timestamp", "desc"))),
    "lt_tie_two_keys": (lambda: [4, 1_600_200_000_000_000, SPLIT, 30_000],
                        (("tenant_id", "asc"), ("timestamp", "desc"))),
    "string_present": (lambda: ["INFO", SPLIT, 10_000],
                       (("severity_text", "desc"),)),
    "string_absent": (lambda: ["HELLO", "split-z", 0],
                      (("severity_text", "asc"),)),
    "score_lt_tie": (lambda: [4.0, SPLIT, 1000], ()),
    "doc_sort": (lambda: [25_000, SPLIT, 25_000], (("_doc", "asc"),)),
}


@pytest.mark.parametrize("name", list(SEARCH_AFTER))
def test_search_after_relations_match_jax(hdfs, name):
    marker, sort = SEARCH_AFTER[name]
    query = SHAPES["should_only_or"][0] if name != "score_lt_tie" \
        else c2_query
    plan, resp = both(hdfs, query, max_hits=30, sort=sort,
                      search_after=marker())
    assert plan.search_after_relation != "none"
    assert resp.partial_hits


# --- two-key sorts ---------------------------------------------------------------

TWO_KEY = {
    # posting space: a single ERROR term, every score equal
    "posting_score_then_timestamp": (
        lambda Q: Q.Term("severity_text", "ERROR"),
        (("_score", "desc"), ("timestamp", "asc")), True),
    "posting_tenant_then_score": (
        lambda Q: Q.Term("severity_text", "WARN"),
        (("tenant_id", "asc"), ("_score", "desc")), True),
    "doc_space_timestamp_then_tenant": (
        c2_query, (("timestamp", "desc"), ("tenant_id", "asc")), False),
    "doc_space_tenant_then_score": (
        c2_query, (("tenant_id", "desc"), ("_score", "desc")), False),
}


@pytest.mark.parametrize("name", list(TWO_KEY))
def test_two_key_sort_matches_jax(hdfs, name):
    query, sort, posting = TWO_KEY[name]
    plan, resp = both(hdfs, query, max_hits=100, sort=sort)
    assert t_executor._posting_space_eligible(plan) == posting
    assert plan.sort.by2 != "none" and len(resp.partial_hits) == 100


# --- threshold pushdown ---------------------------------------------------------

THRESHOLDS = {
    # name: (query, sort, k, hit whose sort value is the threshold)
    "doc_space_score": (c2_query, (), 100, 99),
    "doc_space_two_keys": (c2_query, (("timestamp", "desc"),
                                      ("tenant_id", "asc")), 100, 49),
    "posting_block_max": (lambda Q: Q.Term("body", body_term(3)), (), 10, 9),
    "posting_two_keys": (lambda Q: Q.Term("severity_text", "ERROR"),
                         (("_score", "desc"), ("timestamp", "asc")), 50, 20),
    "posting_by_timestamp": (lambda Q: Q.Term("severity_text", "WARN"),
                             (("timestamp", "asc"),), 30, 29),
}


@pytest.mark.parametrize("name", list(THRESHOLDS))
def test_threshold_pushdown_matches_jax_and_unthresholded(hdfs, name):
    query, sort, k, at = THRESHOLDS[name]
    _, full = both(hdfs, query, max_hits=k, sort=sort)
    threshold = full.partial_hits[at].sort_value
    plan, cut = both(hdfs, query, threshold=threshold, max_hits=k,
                     sort=sort)
    assert plan.threshold_slot >= 0
    assert cut.num_hits == full.num_hits
    assert hits(cut) == hits(full)[:len(hits(cut))]
    assert len(cut.partial_hits) >= at + 1
    if name == "posting_block_max":
        assert plan.root.impact_bmax_slot >= 0
        assert plan.count_override is not None


# --- mask fill and mask_override ------------------------------------------------

def test_packed_mask_equals_jax_and_serves_either_engine(hdfs):
    j_eng, t_eng = hdfs
    j_plan = j_lower(c2_query(JQ), J_HDFS_MAPPER, j_eng.reader, [])
    t_plan = t_lower(c2_query(TQ), T_HDFS_MAPPER, t_eng.reader, [])
    j_host, _ = j_executor.compute_packed_mask(
        j_plan, [jnp.asarray(a) for a in j_plan.arrays])
    t_arrays = [torch.from_numpy(np.array(a)) for a in t_plan.arrays]
    t_host, t_dev = t_executor.compute_packed_mask(t_plan, t_arrays,
                                                   device="cpu")
    assert t_host.dtype == np.uint8 and t_dev.dtype == torch.uint8
    np.testing.assert_array_equal(t_host, j_host)
    np.testing.assert_array_equal(t_dev.numpy(), t_host)
    # the bytes are np.packbits of the predicate's doc set
    mask, _ = t_executor._node_evaluator(t_plan.num_docs_padded, "cpu")(
        t_plan.root, t_arrays, tuple(t_plan.scalars))
    docs = mask.numpy() & (np.arange(t_plan.num_docs_padded)
                           < t_plan.num_docs)
    np.testing.assert_array_equal(t_host, np.packbits(docs))
    assert (t_executor.mask_fill_cache_key(t_plan)
            == j_executor.mask_fill_cache_key(j_plan))

    sort = (("timestamp", "desc"),)
    _, plain = both(hdfs, c2_query, max_hits=100, sort=sort)
    for masks in ((j_host, t_host), (t_host, j_host)):
        plan, served = both(hdfs, c2_query, masks=masks, max_hits=100,
                            sort=sort)
        assert type(plan.root).__name__ == "PMaskRef"
        assert served.num_hits == plain.num_hits
        assert hits(served) == hits(plain)


@pytest.mark.parametrize("n", [1, 8, 13, 1024, 3000])
def test_pack_mask_is_packbits_order(n):
    rng = np.random.RandomState(n)
    bools = rng.rand(n) < 0.4
    packed = t_executor._pack_mask(torch.from_numpy(bools), n)
    np.testing.assert_array_equal(packed.numpy(), np.packbits(bools))
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(j_executor._pack_mask(jnp.asarray(bools), n)))
    assert torch.equal(t_executor._unpack_mask(packed, n),
                       torch.from_numpy(bools))


# --- unit cases against the JAX functions ----------------------------------------

def _strong(value, dtype):
    """A strongly typed scalar, as the plan's scalars reach both programs."""
    return np.asarray(value, dtype=dtype)


RANGE_CASES = {
    # name: (values dtype, bound dtype, bound range)
    "i64_vs_i64": (np.int64, np.int64, (-1000, 1000)),
    "i32_vs_i32": (np.int32, np.int32, (-1000, 1000)),
    "f64_vs_f64": (np.float64, np.float64, (-1000, 1000)),
    "i64_vs_u64": (np.int64, np.uint64, (0, 1000)),
    "u64_vs_u64": (np.uint64, np.uint64, (0, 1000)),
    "i32_vs_i64": (np.int32, np.int64, (-1000, 1000)),
}


@pytest.mark.parametrize("zonemaps", [False, True])
@pytest.mark.parametrize("name", list(RANGE_CASES))
def test_range_mask_matches_jax(name, zonemaps):
    vdt, bdt, (lo, hi) = RANGE_CASES[name]
    rng = np.random.RandomState(len(name))
    n = 4096
    values = rng.randint(lo, hi, n).astype(vdt)
    present = (rng.rand(n) < 0.9).astype(np.uint8)
    present[1024:1536] = 0                  # a block with no present docs
    zm = _column_zonemaps(values, present) if zonemaps else (None, None)
    for lower, upper in ((lo // 2, hi // 2), (hi // 3, hi // 3),
                         (hi * 2, hi * 3)):
        for flags in ((True, True, True, True), (False, False, True, True),
                      (True, False, True, False), (False, True, False, True)):
            args = (_strong(lower, bdt), _strong(upper, bdt))
            want = np.asarray(j_masks.range_mask(
                jnp.asarray(values), jnp.asarray(present),
                *(jnp.asarray(a) for a in args), *flags,
                *(None if z is None else jnp.asarray(z) for z in zm)))
            got = t_masks.range_mask(
                torch.from_numpy(values), torch.from_numpy(present), *args,
                *flags, *(None if z is None else torch.from_numpy(z)
                          for z in zm))
            np.testing.assert_array_equal(got.numpy(), want)


def test_i64_column_against_u64_bound_compares_in_f64():
    """The JAX program compares an i64 column with a u64 bound in f64, so
    2^60 + 1 is not above 2^60 there; the port gives the same answer."""
    values = np.array([2**60 - 1, 2**60, 2**60 + 1, 2**60 + 300, 5],
                      dtype=np.int64)
    present = np.ones(5, np.uint8)
    bound = _strong(2**60, np.uint64)
    for flags in ((False, True, True, False), (True, True, True, False),
                  (True, False, False, True)):
        want = np.asarray(j_masks.range_mask(
            jnp.asarray(values), jnp.asarray(present), jnp.asarray(bound),
            jnp.asarray(bound), *flags))
        got = t_masks.range_mask(torch.from_numpy(values),
                                 torch.from_numpy(present), bound, bound,
                                 *flags)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2]


_DTYPES = [np.bool_, np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
           np.int16, np.int32, np.int64, np.float16, np.float32, np.float64]


def test_compare_dtype_is_jax_promotion():
    for a in _DTYPES:
        for b in _DTYPES:
            assert t_masks.compare_dtype(a, b) == jnp.result_type(
                np.dtype(a), np.dtype(b)), (a, b)


@pytest.mark.parametrize("min_count", [1, 2, 3])
def test_minimum_should_match_mask_matches_jax(min_count):
    rng = np.random.RandomState(min_count)
    masks = [rng.rand(2048) < p for p in (0.3, 0.5, 0.7)]
    want = np.asarray(j_masks.minimum_should_match_mask(
        [jnp.asarray(m) for m in masks], min_count))
    got = t_masks.minimum_should_match_mask(
        [torch.from_numpy(m) for m in masks], min_count)
    np.testing.assert_array_equal(got.numpy(), want)


def _special_keys(rng, n):
    keys = rng.choice([-0.0, 0.0, np.nan, -np.nan, -np.inf, np.inf, 3.0,
                       -2.5, 1e300], n)
    return np.where(rng.rand(n) < 0.3, rng.randint(-3, 3, n) * 0.5, keys)


@pytest.mark.parametrize("n", [700, 1024, 2048, 2500, 5120])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_exact_topk_2key_matches_jax(n, k):
    rng = np.random.RandomState(n + k)
    key1, key2 = _special_keys(rng, n), _special_keys(rng, n)
    ja, jb, ji = jax.jit(j_topk.exact_topk_2key, static_argnums=2)(
        jnp.asarray(key1), jnp.asarray(key2), k)
    ta, tb, ti = t_topk.exact_topk_2key(torch.from_numpy(key1),
                                        torch.from_numpy(key2), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for got, want in ((ta, ja), (tb, jb)):
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      np.asarray(want).view(np.int64))


@pytest.mark.parametrize("threshold", [-np.inf, 0.5, 2.0, 9.0])
def test_block_max_threshold_mask_matches_jax(threshold):
    rng = np.random.RandomState(3)
    keyed = np.where(rng.rand(128 * 8) < 0.8, rng.rand(128 * 8) * 8,
                     -np.inf)
    bmax = rng.randint(0, 255, 8).astype(np.uint8)
    scale = np.float64(8.0 / 255)
    from quickwit_tpu.ops.bm25 import dequantize_block_bounds as j_deq
    from quickwit_tpu_torch.ops.bm25 import dequantize_block_bounds as t_deq
    j_bounds = j_deq(jnp.asarray(bmax), scale)
    t_bounds = t_deq(torch.from_numpy(bmax), scale)
    np.testing.assert_array_equal(t_bounds.numpy(), np.asarray(j_bounds))
    thr = np.float64(threshold)
    want = j_topk.block_max_threshold_mask(
        j_topk.apply_threshold_mask(jnp.asarray(keyed), thr), j_bounds, thr)
    got = t_topk.block_max_threshold_mask(
        t_topk.apply_threshold_mask(torch.from_numpy(keyed), thr), t_bounds,
        thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_propagate_dead_lanes_matches_jax():
    keyed = np.array([1.0, -np.inf, 3.0, -np.inf])
    keyed2 = np.array([5.0, 6.0, -np.inf, np.nan])
    want = j_masks.propagate_dead_lanes(jnp.asarray(keyed),
                                        jnp.asarray(keyed2))
    got = t_masks.propagate_dead_lanes(torch.from_numpy(keyed),
                                       torch.from_numpy(keyed2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scoring", [False, True])
def test_posting_scatter_drops_pad_ids(scoring):
    padded = 2048
    ids = np.array([5, 17, 2047, 900, padded, padded], dtype=np.int32)
    values = np.array([1.5, -0.0, 2.25, 0.0, 7.0, 9.0], dtype=np.float32)
    if scoring:
        want = np.asarray(j_masks.dense_from_postings(
            jnp.asarray(ids), jnp.asarray(values), padded))
        got = t_masks.dense_from_postings(torch.from_numpy(ids),
                                          torch.from_numpy(values), padded)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    else:
        want = np.asarray(j_masks.mask_from_postings(jnp.asarray(ids),
                                                     padded))
        got = t_masks.mask_from_postings(torch.from_numpy(ids), padded)
        np.testing.assert_array_equal(got.numpy(), want)
