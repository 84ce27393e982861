"""The port's multi-split batch (quickwit_tpu_torch/parallel/fanout.py)
against the JAX package's `execute_batch(batch, request, mesh=None)` and
against the port's own per-split route merged by its collector.

Both packages read the same split bytes (written by the JAX writer, its
native text builder off). A merged response must equal the JAX batch's
exactly (hits with their sort values and raw values, counts, every
intermediate aggregation state with its dtype, f64 sums to rtol 1e-12) and
the per-split merge (the same, integer states compared by value: the
batch's on-device merge widens int32 sums to int64 as the JAX `jnp.sum`
does). The cases are the single-device cases of `tests/test_parallel.py`
and `tests/test_packed_columns.py`, then what the port's lane design meets
first: lanes of unequal posting length, a k past a split's posting list,
signed zeros and NaN across splits, and the small top-k and segment ops.

Posting-space lanes are also held against the JAX batch with `QW_PALLAS=1`
(its Pallas kernel in interpret mode). Its batch program cache is keyed
without that switch, so those cases swap in a fresh cache.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index import writer as j_writer
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.writer import SplitWriter as JSplitWriter
from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.ops import topk as j_topk
from quickwit_tpu.parallel import fanout as j_fanout
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import models as j_models
from quickwit_tpu.search.plan import PlanError as JPlanError
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability.metrics import (
    SEARCH_KERNEL_LAUNCHES_TOTAL, STAGING_BYTES_TOTAL,
)
from quickwit_tpu_torch.ops import topk as t_topk
from quickwit_tpu_torch.parallel import fanout as t_fanout
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import models as t_models
from quickwit_tpu_torch.search.collector import IncrementalCollector
from quickwit_tpu_torch.search.leaf import leaf_search_single_split
from quickwit_tpu_torch.search.plan import PlanError as TPlanError
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage

from test_torch_residency import _hits, assert_same_response, \
    assert_states_close

J = SimpleNamespace(Q=JQ, M=j_models, dm=jdm)
T = SimpleNamespace(Q=TQ, M=t_models, dm=tdm)


class Splits:
    """Split bytes (split id -> bytes) with a reader of each package."""

    def __init__(self, name: str, blobs: dict, mapper):
        self.ids = list(blobs)
        self.mapper = mapper     # builder over a doc_mapper module
        j_storage = JRamStorage(JUri.parse(f"ram:///jfan-{name}"))
        t_storage = TRamStorage(TUri.parse(f"ram:///tfan-{name}"))
        for split_id, data in blobs.items():
            j_storage.put(f"{split_id}.split", data)
            t_storage.put(f"{split_id}.split", data)
        self.j = [JSplitReader(j_storage, f"{s}.split") for s in self.ids]
        self.t = [TSplitReader(t_storage, f"{s}.split") for s in self.ids]


def write_splits(name: str, mapper, docs_by_split: dict, env=None) -> Splits:
    """Each split written by the JAX writer (native text builder off)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_writer, "_native_capable", lambda fm: None)
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        blobs = {}
        for split_id, docs in docs_by_split.items():
            writer = JSplitWriter(mapper(jdm))
            for doc in docs:
                writer.add_json_doc(doc)
            blobs[split_id] = writer.finish()
    return Splits(name, blobs, mapper)


def _widen_ints(tree):
    """Integer arrays as int64: the batch merges int32 counts into int64
    (as the JAX batch does), the collector keeps int32."""
    if isinstance(tree, dict):
        return {k: _widen_ints(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_widen_ints(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "iu":
        return tree.astype(np.int64)
    return tree


def per_split_collector(splits: Splits, req) -> IncrementalCollector:
    """The port's per-split route: one leaf call per split on the CPU,
    merged by the collector."""
    collector = IncrementalCollector(max_hits=req.max_hits,
                                     start_offset=req.start_offset)
    for split_id, reader in zip(splits.ids, splits.t):
        collector.add_leaf_response(leaf_search_single_split(
            req, splits.mapper(tdm), reader, split_id, device="cpu"))
    return collector


def assert_equals_per_split(got, req, splits: Splits) -> None:
    want = per_split_collector(splits, req)
    merged = IncrementalCollector(max_hits=req.max_hits,
                                  start_offset=req.start_offset)
    merged.add_leaf_response(got)
    assert merged.num_hits == want.num_hits
    assert merged.num_successful_splits == want.num_successful_splits
    assert _hits(SimpleNamespace(partial_hits=merged.partial_hits())) == \
        _hits(SimpleNamespace(partial_hits=want.partial_hits()))
    assert_states_close(_widen_ints(want.aggregation_states()),
                        _widen_ints(merged.aggregation_states()))


def run_batch(splits: Splits, build, pad_to=None, exact=False,
              per_split=True):
    """The port's batch on the CPU against the JAX batch and (unless
    `per_split` is False) the port's per-split merge; returns the port's
    response and request."""
    j_req, t_req = build(J), build(T)
    j_batch = j_fanout.build_batch(j_req, splits.mapper(jdm), splits.j,
                                   splits.ids, pad_to_splits=pad_to)
    want = j_fanout.execute_batch(j_batch, j_req, mesh=None, exact=exact)
    t_batch = t_fanout.build_batch(t_req, splits.mapper(tdm), splits.t,
                                   splits.ids, pad_to_splits=pad_to)
    got = t_fanout.execute_batch(t_batch, t_req, device="cpu")
    assert_same_response(got, want)
    assert (got.num_attempted_splits, got.num_successful_splits) == \
        (want.num_attempted_splits, want.num_successful_splits)
    if per_split:
        assert_equals_per_split(got, t_req, splits)
    return got, t_req


# --- the corpus of tests/test_parallel.py ------------------------------------

SEVERITIES = ["DEBUG", "INFO", "WARN", "ERROR"]


def parallel_mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("timestamp", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("severity_text", dm.FieldType.TEXT,
                            tokenizer="raw", fast=True),
            dm.FieldMapping("tenant_id", dm.FieldType.U64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT),
            dm.FieldMapping("latency", dm.FieldType.F64, fast=True),
        ],
        timestamp_field="timestamp",
        default_search_fields=("body",),
    )


def parallel_docs(split: int, n: int = 300):
    rng = np.random.RandomState(split)
    return [{
        "timestamp": 1_600_000_000 + split * 50_000 + i * 60,
        "severity_text": SEVERITIES[int(rng.randint(0, 4))],
        "tenant_id": int(rng.randint(0, 4)),
        "body": " ".join(["alpha"] * int(rng.randint(1, 3))
                         + ["beta"] * int(rng.randint(0, 2))),
        "latency": float(rng.gamma(2.0, 40.0)),
    } for i in range(n)]


@pytest.fixture(scope="module")
def parallel():
    return write_splits("parallel", parallel_mapper,
                        {f"split-{s}": parallel_docs(s) for s in range(4)})


def _req(P, query, **kw):
    sort = kw.pop("sort", ())
    return P.M.SearchRequest(
        index_ids=["x"], query_ast=query(P.Q),
        sort_fields=tuple(P.M.SortField(*s) for s in sort), **kw)


REQUESTS = {
    "body_beta_top12": lambda P: _req(
        P, lambda Q: Q.FullText("body", "beta", "or"), max_hits=12),
    "error_by_timestamp": lambda P: _req(
        P, lambda Q: Q.Term("severity_text", "ERROR"), max_hits=7,
        sort=[("timestamp", "desc")]),
    "match_all_by_latency_asc": lambda P: _req(
        P, lambda Q: Q.MatchAll(), max_hits=5, sort=[("latency", "asc")]),
    "bool_filter_with_aggs": lambda P: _req(
        P, lambda Q: Q.Bool(
            must=(Q.FullText("body", "alpha", "or"),),
            filter=(Q.Range("tenant_id", Q.RangeBound(1, True),
                            Q.RangeBound(2, True)),)),
        max_hits=10,
        aggs={"sev": {"terms": {"field": "severity_text", "size": 10}},
              "over_time": {"date_histogram": {"field": "timestamp",
                                               "fixed_interval": "1h"}},
              "lat": {"stats": {"field": "latency"}}}),
    "count_and_terms_only": lambda P: _req(
        P, lambda Q: Q.FullText("body", "beta", "or"), max_hits=0,
        aggs={"sev": {"terms": {"field": "severity_text"}}}),
    "two_keys_tenant_timestamp": lambda P: _req(
        P, lambda Q: Q.MatchAll(), max_hits=8,
        sort=[("tenant_id", "asc"), ("timestamp", "desc")]),
    "error_by_timestamp_latency": lambda P: _req(
        P, lambda Q: Q.Term("severity_text", "ERROR"), max_hits=6,
        sort=[("timestamp", "desc"), ("latency", "asc")]),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_batch_matches_jax_and_per_split(parallel, name):
    got, _ = run_batch(parallel, REQUESTS[name])
    assert got.num_hits > 0


@pytest.fixture
def pallas(monkeypatch):
    """The JAX batch with its Pallas kernel (interpret mode) in the
    posting-space program, compiled afresh."""
    monkeypatch.setenv("QW_PALLAS", "1")
    monkeypatch.setattr(j_fanout, "_BATCH_JIT_CACHE", {})


def _spy_lanes(monkeypatch):
    calls = []
    real = t_fanout.score_topk_lanes

    def spy(lanes, k):
        calls.append(([int(lane[0].shape[0]) for lane in lanes], k))
        return real(lanes, k)

    monkeypatch.setattr(t_fanout, "score_topk_lanes", spy)
    return calls


POSTING_REQUESTS = {
    "body_beta_top12": REQUESTS["body_beta_top12"],
    "error_by_score": lambda P: _req(
        P, lambda Q: Q.Term("severity_text", "ERROR"), max_hits=9),
}


@pytest.mark.parametrize("name", list(POSTING_REQUESTS))
def test_posting_lanes_match_the_pallas_batch(parallel, pallas, monkeypatch,
                                              name):
    """The fused step: one lane-kernel call for the batch's four splits
    (its plain version on the CPU), against the JAX batch running its
    Pallas kernel."""
    build = POSTING_REQUESTS[name]
    got, req = run_batch(parallel, build)
    assert got.num_hits > 0
    calls = _spy_lanes(monkeypatch)
    batch = t_fanout.build_batch(req, parallel_mapper(tdm), parallel.t,
                                 parallel.ids)
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    assert _hits(t_fanout.execute_batch(batch, req, device="cpu")) == \
        _hits(got)
    # one dispatch for the batch, as one JAX program
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert len(calls) == 1 and len(calls[0][0]) == 4


def test_batch_with_padding_splits(parallel):
    """A batch padded to 6 splits: the pad splits run nothing and add no
    hit or count."""
    got, _ = run_batch(parallel, REQUESTS["body_beta_top12"], pad_to=6)
    assert all(h.split_id for h in got.partial_hits)
    assert got.num_attempted_splits == 4


def test_pad_to_fewer_splits_is_rejected(parallel):
    req = REQUESTS["body_beta_top12"](T)
    with pytest.raises(ValueError, match="pad_to_splits"):
        t_fanout.build_batch(req, parallel_mapper(tdm), parallel.t,
                             parallel.ids, pad_to_splits=3)


def test_batch_term_missing_in_some_splits(parallel):
    run_batch(parallel, lambda P: _req(
        P, lambda Q: Q.FullText("body", "beta", "or"), max_hits=50))


def test_batch_rejects_nonuniform_queries(parallel):
    """A wildcard expands per split: both packages refuse the batch (or,
    where every split expands alike, both answer the same)."""
    build = (lambda P: _req(P, lambda Q: Q.Wildcard("body", "alp*"),
                            max_hits=5))
    outcomes = []
    for pkg, fanout, mapper, readers in (
            (J, j_fanout, parallel_mapper(jdm), parallel.j),
            (T, t_fanout, parallel_mapper(tdm), parallel.t)):
        try:
            fanout.build_batch(build(pkg), mapper, readers, parallel.ids)
            outcomes.append("built")
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]
    if outcomes[0] == "built":
        run_batch(parallel, build)


def _values_mapper(dm):
    return dm.DocMapper(field_mappings=[
        dm.FieldMapping("v", dm.FieldType.F64, fast=True)])


def test_batch_numeric_histogram_origin_alignment():
    """A plain histogram takes the batch-global origin: both splits' 50-wide
    buckets line up before the on-device sum."""
    splits = write_splits("histalign", _values_mapper, {
        "a": [{"v": v} for v in (0, 10, 49)],
        "b": [{"v": v} for v in (50, 60, 99)]})
    got, _ = run_batch(splits, lambda P: _req(
        P, lambda Q: Q.MatchAll(), max_hits=0,
        aggs={"h": {"histogram": {"field": "v", "interval": 50}}}))
    state = got.intermediate_aggs["h"]
    assert state["origin"] == 0.0
    assert list(state["counts"]) == [3, 3]


def test_batch_histogram_bucket_limit(parallel):
    def build(P):
        return _req(P, lambda Q: Q.MatchAll(), max_hits=0,
                    aggs={"h": {"date_histogram": {
                        "field": "timestamp", "fixed_interval": "1s"}}})
    with pytest.raises(JPlanError, match="buckets"):
        j_fanout.build_batch(build(J), parallel_mapper(jdm), parallel.j,
                             parallel.ids)
    with pytest.raises(TPlanError, match="buckets"):
        t_fanout.build_batch(build(T), parallel_mapper(tdm), parallel.t,
                             parallel.ids)


def _phrase_mapper(dm):
    return dm.DocMapper(field_mappings=[
        dm.FieldMapping("body", dm.FieldType.TEXT, record="position")],
        default_search_fields=("body",))


def test_batch_phrase_with_term_missing_in_one_split():
    splits = write_splits("phrasebatch", _phrase_mapper, {
        "a": [{"body": "hello world x"}, {"body": "other text"}],
        "b": [{"body": "hello there"}, {"body": "no match"}]})
    got, _ = run_batch(splits, lambda P: _req(
        P, lambda Q: Q.FullText("body", "hello world", "phrase"),
        max_hits=10))
    assert got.num_hits == 1 and got.partial_hits[0].split_id == "a"


def test_batch_nested_aggregation_parity(parallel):
    run_batch(parallel, lambda P: _req(
        P, lambda Q: Q.MatchAll(), max_hits=0,
        aggs={"sev": {"terms": {"field": "severity_text"},
                      "aggs": {"ot": {"date_histogram": {
                          "field": "timestamp", "fixed_interval": "1h"}}}}}))


def test_batch_nested_histogram_name_collision(parallel):
    """A nested date_histogram named like a top-level one keeps its own
    batch-global bucket space (overrides key by parent>child)."""
    got, _ = run_batch(parallel, lambda P: _req(
        P, lambda Q: Q.MatchAll(), max_hits=0,
        aggs={
            "h": {"date_histogram": {"field": "timestamp",
                                     "fixed_interval": "1h"}},
            "t": {"terms": {"field": "severity_text"},
                  "aggs": {"h": {"date_histogram": {
                      "field": "timestamp", "fixed_interval": "1d"}}}},
        }))
    assert got.intermediate_aggs["h"]["interval"] != \
        got.intermediate_aggs["t"]["subs"][0]["interval"]


def _dynamic_mapper(dm):
    return dm.DocMapper(field_mappings=[
        dm.FieldMapping("title", dm.FieldType.TEXT)], mode="dynamic")


def test_batch_dynamic_field_absent_from_one_split():
    """A dynamic path one split never ingested contributes no hit from it
    (its fieldnorm lowers to the zeros stand-in)."""
    splits = write_splits("dynbatch", _dynamic_mapper, {
        "a": [{"title": "a", "service": "gw"}], "b": [{"title": "b"}]})
    got, _ = run_batch(splits, lambda P: _req(
        P, lambda Q: Q.Term(field="service", value="gw"), max_hits=10))
    assert got.num_hits == 1 and got.partial_hits[0].split_id == "a"


# --- packed columns (tests/test_packed_columns.py) ---------------------------

def _packed_mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("timestamp", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("tenant_id", dm.FieldType.U64, fast=True),
            dm.FieldMapping("severity_text", dm.FieldType.TEXT,
                            tokenizer="raw", fast=True),
            dm.FieldMapping("latency", dm.FieldType.F64, fast=True),
            dm.FieldMapping("shard", dm.FieldType.I64, fast=True),
            dm.FieldMapping("code", dm.FieldType.I64, fast=True),
        ],
        timestamp_field="timestamp")


P_T0 = 1_600_000_000


def _packed_docs():
    rng = np.random.RandomState(11)
    docs = []
    for i in range(1300):
        doc = {"timestamp": P_T0 + i * 60,
               "tenant_id": int(rng.randint(0, 7)),
               "severity_text": ["INFO", "WARN", "ERROR"][i % 3],
               "latency": float(rng.gamma(2.0, 50.0)), "shard": 42}
        if i % 13 != 0:
            doc["code"] = int(rng.randint(-500, 500))
        docs.append(doc)
    return docs


def _c2_style(Q):
    return Q.Bool(
        must=(Q.Term("severity_text", "ERROR"),),
        filter=(Q.Range("timestamp",
                        lower=Q.RangeBound((P_T0 + 60 * 60) * 10**6, True),
                        upper=Q.RangeBound((P_T0 + 1200 * 60) * 10**6,
                                           False)),
                Q.Range("tenant_id", lower=Q.RangeBound(1, True),
                        upper=Q.RangeBound(6, False))))


def test_batch_over_packed_splits():
    """Two FOR-packed splits of one corpus: their winners interleave
    pairwise with equal sort values."""
    docs = _packed_docs()
    splits = write_splits("packed", _packed_mapper, {"s1": docs, "s2": docs})
    got, _ = run_batch(splits, lambda P: _req(
        P, _c2_style, max_hits=40, sort=[("timestamp", "desc")]))
    raws = [h.raw_sort_value for h in got.partial_hits]
    assert raws[0::2] == raws[1::2]
    assert [h.split_id for h in got.partial_hits[:2]] == ["s1", "s2"]


def test_batch_rejects_mixed_packings():
    docs = _packed_docs()
    packed = write_splits("mixed-p", _packed_mapper, {"s1": docs})
    raw = write_splits("mixed-r", _packed_mapper, {"s2": docs},
                       env={"QW_DISABLE_PACKED": "1"})
    errors = []
    for fanout, pkg, readers in (
            (j_fanout, J, packed.j + raw.j), (t_fanout, T, packed.t + raw.t)):
        req = _req(pkg, _c2_style, max_hits=10)
        with pytest.raises(ValueError) as info:
            fanout.build_batch(req, _packed_mapper(pkg.dm), readers,
                               ["s1", "s2"])
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# --- lanes of unequal posting length -----------------------------------------

def _gamma_docs(count: int, n: int = 300):
    return [{"timestamp": 1_600_000_000 + i, "severity_text": "INFO",
             "tenant_id": i % 4,
             "body": "gamma alpha" if i < count else "alpha",
             "latency": float(i)} for i in range(n)]


@pytest.fixture(scope="module")
def uneven():
    """`gamma` absent from split a (the first lane: the 128-posting
    stand-in) and in 300, 150 and 40 docs of b, c and d."""
    return write_splits("uneven", parallel_mapper, {
        "a": _gamma_docs(0), "b": _gamma_docs(300), "c": _gamma_docs(150),
        "d": _gamma_docs(40)})


def _gamma(max_hits):
    return lambda P: _req(P, lambda Q: Q.Term("body", "gamma"),
                          max_hits=max_hits)


@pytest.mark.parametrize("jax_kernel", ["plain", "pallas"])
def test_unequal_posting_lanes_at_k64(uneven, monkeypatch, jax_kernel):
    """Lane 0 is the shortest, the absent-term stand-in: the fused step's
    one k (64) still fits every lane, since every posting list pads to at
    least 128."""
    if jax_kernel == "pallas":
        monkeypatch.setenv("QW_PALLAS", "1")
        monkeypatch.setattr(j_fanout, "_BATCH_JIT_CACHE", {})
    calls = _spy_lanes(monkeypatch)
    got, _ = run_batch(uneven, _gamma(64))
    assert calls == [([128, 384, 256, 128], 64)]
    assert got.num_hits == 490 and len(got.partial_hits) == 64
    assert {h.split_id for h in got.partial_hits} <= {"b", "c", "d"}


def test_k_past_one_posting_list(uneven):
    """k = 200 exceeds lanes a and d (128 postings) but not b: every lane
    selects over the batch's longest list (384), as the JAX stacked
    program does."""
    got, _ = run_batch(uneven, _gamma(200))
    assert len(got.partial_hits) == 200


def test_k_past_every_posting_list_attributes_each_split(uneven):
    """k = 600 exceeds every posting list (384 at most). A lane then holds
    384 winners, and the port divides merge positions by that width. The
    JAX batch divides by k (`fanout.batch_fn`: `pos // k`) and attributes
    hits to the wrong split (ROADMAP §3); the port equals the per-split
    merge."""
    j_req, t_req = _gamma(600)(J), _gamma(600)(T)
    got = t_fanout.execute_batch(
        t_fanout.build_batch(t_req, parallel_mapper(tdm), uneven.t,
                             uneven.ids), t_req, device="cpu")
    assert_equals_per_split(got, t_req, uneven)
    want = j_fanout.execute_batch(
        j_fanout.build_batch(j_req, parallel_mapper(jdm), uneven.j,
                             uneven.ids), j_req)
    assert want.num_hits == got.num_hits == 490
    assert [h.doc_id for h in want.partial_hits] == \
        [h.doc_id for h in got.partial_hits]
    assert [h.split_id for h in want.partial_hits] != \
        [h.split_id for h in got.partial_hits]


# --- signed zeros and NaN across splits --------------------------------------

def _gain_mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("timestamp", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("gain", dm.FieldType.F64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT, record="position"),
        ],
        timestamp_field="timestamp")


def _gain_docs(gain_of, n: int):
    return [{"timestamp": 1_600_000_000 + i, "body": "alpha",
             "gain": gain_of(i)} for i in range(n)]


@pytest.fixture(scope="module")
def zeros():
    """Split a: -0.0 on every doc but 1.0 on 6; split b: +0.0 on 20 docs
    and -1.0 elsewhere. A single-key top-100 ranks b's +0.0 docs above a's
    -0.0 docs (`lax.top_k`'s total order) and cuts among a's -0.0 docs."""
    return write_splits("zeros", _gain_mapper, {
        "a": _gain_docs(lambda i: 1.0 if i % 97 == 0 else -0.0, 500),
        "b": _gain_docs(lambda i: 0.0 if i % 25 == 0 else -1.0, 500)})


@pytest.fixture(scope="module")
def nans():
    return write_splits("nans", _gain_mapper, {
        "a": _gain_docs(lambda i: float(i % 7), 500),
        "b": _gain_docs(lambda i: float("nan") if i in (150, 450)
                        else float(i % 5), 500)})


def _bits(values):
    return np.asarray(values, dtype=np.float64).view(np.int64)


def _by_gain(query, max_hits, order="desc"):
    return lambda P: _req(P, query, max_hits=max_hits,
                          sort=[("gain", order)])


@pytest.mark.parametrize("query", ["match_all", "term"])
def test_signed_zeros_across_splits(zeros, query):
    """Held against the JAX batch's EXACT top-k (`exact=True`: its guided
    top-k drops +0.0 lanes, ROADMAP §3), bit for bit. The collector ranks
    the two zeros equal (a Python float order), so the per-split route is
    compared where no cut falls between them: a page holding every doc
    (the batch's page is at most its padded doc count, 1024 here, as in
    the JAX batch)."""
    build_q = (lambda Q: Q.MatchAll()) if query == "match_all" else \
        (lambda Q: Q.Term("body", "alpha"))
    j_req, t_req = _by_gain(build_q, 100)(J), _by_gain(build_q, 100)(T)
    want = j_fanout.execute_batch(j_fanout.build_batch(
        j_req, _gain_mapper(jdm), zeros.j, zeros.ids), j_req, exact=True)
    got = t_fanout.execute_batch(t_fanout.build_batch(
        t_req, _gain_mapper(tdm), zeros.t, zeros.ids), t_req, device="cpu")
    assert_same_response(got, want)
    np.testing.assert_array_equal(
        _bits([h.sort_value for h in got.partial_hits]),
        _bits([h.sort_value for h in want.partial_hits]))
    zero_hits = [h for h in got.partial_hits if h.sort_value == 0.0]
    assert [h.split_id for h in zero_hits[:20]] == ["b"] * 20
    assert [np.signbit(h.sort_value) for h in zero_hits] == \
        [False] * 20 + [True] * (len(zero_hits) - 20)
    every = _by_gain(build_q, 1000)(T)
    whole = t_fanout.execute_batch(t_fanout.build_batch(
        every, _gain_mapper(tdm), zeros.t, zeros.ids), every, device="cpu")
    per = per_split_collector(zeros, every)
    assert whole.num_hits == per.num_hits

    def bag(hits):
        return sorted((h.split_id, h.doc_id, int(_bits([h.sort_value])[0]))
                      for h in hits)
    assert bag(whole.partial_hits) == bag(per.partial_hits())


@pytest.mark.parametrize("order", ["desc", "asc"])
def test_nan_sort_values_across_splits(nans, order):
    """NaN gains in split b: ranked as `lax.top_k` ranks them, bit for bit
    against the JAX batch; against the per-split route over a page that
    holds every doc (the collector cannot order NaN)."""
    build = _by_gain(lambda Q: Q.MatchAll(), 10, order)
    j_req, t_req = build(J), build(T)
    want = j_fanout.execute_batch(j_fanout.build_batch(
        j_req, _gain_mapper(jdm), nans.j, nans.ids), j_req, exact=True)
    got = t_fanout.execute_batch(t_fanout.build_batch(
        t_req, _gain_mapper(tdm), nans.t, nans.ids), t_req, device="cpu")
    assert [(h.split_id, h.doc_id) for h in got.partial_hits] == \
        [(h.split_id, h.doc_id) for h in want.partial_hits]
    np.testing.assert_array_equal(
        _bits([h.sort_value for h in got.partial_hits]),
        _bits([h.sort_value for h in want.partial_hits]))
    if order == "desc":
        assert [h.doc_id for h in got.partial_hits[:2]] == [150, 450]
    every = _by_gain(lambda Q: Q.MatchAll(), 1000, order)(T)
    whole = t_fanout.execute_batch(t_fanout.build_batch(
        every, _gain_mapper(tdm), nans.t, nans.ids), every, device="cpu")
    per = per_split_collector(nans, every)
    assert sorted((h.split_id, h.doc_id) for h in whole.partial_hits) == \
        sorted((h.split_id, h.doc_id) for h in per.partial_hits())


# --- staging -----------------------------------------------------------------

def test_a_repeat_of_the_batch_stages_nothing(parallel):
    req = REQUESTS["bool_filter_with_aggs"](T)
    batch = t_fanout.build_batch(req, parallel_mapper(tdm), parallel.t,
                                 parallel.ids)
    before = STAGING_BYTES_TOTAL.get()
    first = t_fanout.execute_batch(batch, req, device="cpu")
    staged = STAGING_BYTES_TOTAL.get() - before
    assert staged == t_fanout.per_device_bytes(batch) > 0
    again = t_fanout.execute_batch(batch, req, device="cpu")
    assert STAGING_BYTES_TOTAL.get() - before == staged
    assert _hits(again) == _hits(first)


def test_terms_ordinals_key_names_the_batch_dictionary(parallel):
    """The batch-global terms column depends on the whole split set: its
    array key carries the dictionary's digest, so a split's resident copy
    lowered for one set never serves another."""
    narrow = write_splits("narrowsev", parallel_mapper, {
        "x": [dict(d, severity_text="INFO") for d in parallel_docs(0, 50)],
        "y": [dict(d, severity_text="WARN") for d in parallel_docs(1, 50)]})
    req = REQUESTS["count_and_terms_only"](T)

    def ordinals_key(readers, ids):
        batch = t_fanout.build_batch(req, parallel_mapper(tdm), readers, ids)
        return [k for k in batch.plans[0].array_keys
                if "ordinals_global" in k]

    small = ordinals_key(narrow.t, ["x", "y"])
    wide = ordinals_key([narrow.t[0], parallel.t[0]], ["x", "split-0"])
    assert len(small) == len(wide) == 1 and small != wide
    assert ordinals_key(narrow.t, ["x", "y"]) == small


# --- the program key and the small ops ---------------------------------------

@pytest.mark.parametrize("name", ["body_beta_top12", "bool_filter_with_aggs",
                                  "two_keys_tenant_timestamp"])
def test_batch_cache_key_mirrors_jax(parallel, name):
    j_req, t_req = REQUESTS[name](J), REQUESTS[name](T)
    j_batch = j_fanout.build_batch(j_req, parallel_mapper(jdm), parallel.j,
                                   parallel.ids, pad_to_splits=5)
    t_batch = t_fanout.build_batch(t_req, parallel_mapper(tdm), parallel.t,
                                   parallel.ids, pad_to_splits=5)
    for k in (0, 10, 10**9):
        assert t_fanout.batch_cache_key(t_batch, k) == \
            j_fanout.batch_cache_key(j_batch, k, None)
    assert t_batch.n_splits == j_batch.n_splits == 5
    assert t_batch.split_ids == j_batch.split_ids


def _key_matrix(seed, q=3, n=2500):
    rng = np.random.RandomState(seed)
    x = rng.choice(np.array([-0.0, 0.0, np.nan, -np.nan, 1.0, -1.0,
                             -np.inf, 2.5]), size=(q, n))
    return x, rng.randint(0, 4, size=(q, n)).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_topk_matches_jax(seed):
    x, x2 = _key_matrix(seed)
    for k in (1, 10, 300):
        jv, jp = j_topk.batched_topk(jnp.asarray(x), k)
        tv, tp = t_topk.batched_topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(_bits(np.asarray(jv)), _bits(tv))
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        jv, jv2, jp = j_topk.batched_topk_2key(jnp.asarray(x2),
                                               jnp.asarray(x), k)
        tv, tv2, tp = t_topk.batched_topk_2key(torch.from_numpy(x2),
                                               torch.from_numpy(x), k)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(_bits(np.asarray(jv)), _bits(tv))
        np.testing.assert_array_equal(_bits(np.asarray(jv2)), _bits(tv2))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32,
                                   np.int64])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_merge_by_query_matches_jax(dtype, op):
    """Segments fold their rows in ascending row order (exact f64 sums
    against the JAX `segment_sum`); an empty segment holds the op's
    identity; NaN propagates through min and max."""
    rng = np.random.RandomState(3)
    values = (rng.normal(size=(40, 3)) * 1e6).astype(dtype)
    if dtype == np.float64:
        values[5, 1] = np.nan
    ids = rng.randint(0, 6, size=40).astype(np.int32)
    ids[ids == 4] = 5        # segment 4 stays empty
    want = np.asarray(j_topk.segment_merge_by_query(
        jnp.asarray(values), jnp.asarray(ids), 6, op))
    got = t_topk.segment_merge_by_query(torch.from_numpy(values),
                                        torch.from_numpy(ids), 6, op).numpy()
    assert want.dtype == got.dtype
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))
    else:
        np.testing.assert_array_equal(want, got)
    with pytest.raises(ValueError):
        t_topk.segment_merge_by_query(torch.from_numpy(values),
                                      torch.from_numpy(ids), 6, "mean")
