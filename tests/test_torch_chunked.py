"""The port's resumable chunked leaf scan (search/chunkexec.py) against the
JAX package's.

Both packages read the same split bytes (written by the JAX package:
1100 docs, formats v3, v2 and v1), lower each request with their own
lowering and run it three ways: the JAX chunked scan, the port's chunked
scan and the port's fused program (`device="cpu"`). The port's chunked
result must equal its fused result and the JAX chunked result: ids,
counts, sort values, scores and integer aggregates exactly, f64 sums to
rtol 1e-12 (the tolerance of tests/test_torch_agg_program.py). On top of
that sit the behaviours the chunk boundaries buy, as the JAX package's
tests/test_chunked_execution.py states them: cancellation with partial
results, preemption with parked state, early termination, threshold
tightening, and the leaf and service wiring.

One case differs from the JAX package on purpose: a single-key sort over
an f64 field holding both zeros. The port's cross-chunk merge ranks them as
its fused top-k does (+0.0 first); the JAX merge ranks them equal and
keeps chunk order (ROADMAP §3).
"""

import threading
import time

import numpy as np
import pytest
import torch

from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.writer import SplitWriter as JSplitWriter
from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.query import aggregations as j_aggs
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import chunkexec as jc
from quickwit_tpu.search import executor as j_executor
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.search.pruning import ThresholdBox as JThresholdBox
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common.deadline import (
    CancellationToken, CancelledQuery, cancel_scope,
)
from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.format import DOC_PAD, POSTING_PAD
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability import metrics as t_metrics
from quickwit_tpu_torch.ops import topk as t_topk
from quickwit_tpu_torch.query import aggregations as t_aggs
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import chunkexec as tc
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search.cancel import QueryCancelRegistry
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.search.pruning import ThresholdBox as TThresholdBox
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage
from quickwit_tpu_torch.tenancy.context import TenantContext, tenant_scope
from quickwit_tpu_torch.tenancy.overload import OVERLOAD

SEVERITIES = ["DEBUG", "INFO", "WARN", "ERROR"]
BIG_DOCS = 1100   # pads to 2048 docs -> two DOC_PAD dense chunks
T0 = 1_700_000_000
SUM_KEYS = ("sum", "sum_sq")


def _mapper(dm):
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


J_MAPPER, T_MAPPER = _mapper(jdm), _mapper(tdm)


def _docs(n, seed):
    rng = np.random.RandomState(seed)
    return [{
        "timestamp": T0 + i * 60,
        "severity_text": SEVERITIES[int(rng.randint(0, 4))],
        "tenant_id": int(rng.randint(0, 4)),
        "body": " ".join(["alpha"] * int(rng.randint(1, 3))
                         + ["beta"] * int(rng.randint(0, 2))),
        "latency": float(rng.gamma(2.0, 40.0)),
    } for i in range(n)]


def _readers(data: bytes, name: str):
    """(JAX reader, port reader) over the same bytes."""
    js = JRamStorage(JUri.parse(f"ram:///chunked-{name}"))
    js.put("s.split", data)
    ts = TRamStorage(TUri.parse(f"ram:///chunked-{name}"))
    ts.put("s.split", data)
    return JSplitReader(js, "s.split"), TSplitReader(ts, "s.split")


@pytest.fixture(scope="module")
def splits():
    """format -> (JAX reader, port reader): v3 (impact-ordered), v2
    (QW_DISABLE_IMPACT) and v1 (QW_DISABLE_PACKED), from one corpus."""
    out = {}
    docs = _docs(BIG_DOCS, seed=5)
    for fmt, env in (("v3", {}), ("v2", {"QW_DISABLE_IMPACT": "1"}),
                     ("v1", {"QW_DISABLE_PACKED": "1"})):
        with pytest.MonkeyPatch.context() as mp:
            for key, value in env.items():
                mp.setenv(key, value)
            writer = JSplitWriter(J_MAPPER)
            for doc in docs:
                writer.add_json_doc(doc)
            out[fmt] = _readers(writer.finish(), fmt)
    return out


@pytest.fixture(autouse=True)
def fresh_chunking(monkeypatch):
    """Each test starts from the default knobs and a sizer that has learnt
    nothing, in both packages; a learnt rate would chunk later plans of
    other test files in this worker. The overload ladder is calmed and the
    preempt gate must end empty."""
    for mod in (jc, tc):
        monkeypatch.setattr(mod, "CHUNKING", mod.ChunkConfig())
        monkeypatch.setattr(mod, "CHUNK_SIZER", mod._ChunkSizer())
    yield
    OVERLOAD.reset()
    OVERLOAD.configure(enabled=False, target_wait_secs=0.5)
    assert not tc.PREEMPT_GATE._active
    assert tc.PARKED_STATES.parked_bytes() == 0


def _t_arrays(plan):
    return [torch.from_numpy(np.array(a)) for a in plan.arrays]


def _lower(readers, ast, aggs=None, **kw):
    """(JAX plan, port plan) of one request."""
    j_reader, t_reader = readers
    j_specs = j_aggs.parse_aggs(aggs) if aggs else []
    t_specs = t_aggs.parse_aggs(aggs) if aggs else []
    return (j_lower(ast(JQ), J_MAPPER, j_reader, j_specs, **kw),
            t_lower(ast(TQ), T_MAPPER, t_reader, t_specs, **kw))


def _bits(values):
    return None if values is None else np.asarray(values).view(np.int64)


def assert_same_result(want, got, label=""):
    """Two result dicts: count, both sort keys and the ids exactly (the
    keys bitwise), f32 scores bitwise, agg states exactly but f64 sums
    (and a stats state's sum and sum of squares) to rtol 1e-12."""
    assert got is not None and want is not None, label
    assert int(got["count"]) == int(want["count"]), label
    for key in ("sort_values", "sort_values2"):
        w, g = want[key], got[key]
        assert (w is None) == (g is None), f"{label} {key}"
        if w is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{label} {key}")
    np.testing.assert_array_equal(np.asarray(got["doc_ids"]),
                                  np.asarray(want["doc_ids"]),
                                  err_msg=f"{label} doc_ids")
    np.testing.assert_array_equal(
        np.asarray(got["scores"], np.float32).view(np.int32),
        np.asarray(want["scores"], np.float32).view(np.int32),
        err_msg=f"{label} scores")
    _assert_states(list(want["aggs"]), list(got["aggs"]), f"{label} aggs")


def _assert_states(want, got, path):
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            _assert_states(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_states(w, g, f"{path}[{i}]")
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), path
        close = np.zeros(w.shape, dtype=bool)
        if key in SUM_KEYS:
            close[...] = True
        elif key == "stats":          # [count, sum, sum_sq, min, max]
            close[1:3] = True
        if w.dtype.kind == "f":
            exact = (w == g) | (np.isnan(w) & np.isnan(g))
            near = np.isclose(g, w, rtol=1e-12, atol=0, equal_nan=True)
            ok = np.where(close, near, exact)
        else:
            ok = w == g
        assert np.all(ok), f"{path}: {w} vs {g}"


def _run_three(plans, k, span, j_box=None, t_box=None):
    """(JAX chunked, port chunked, port fused) of one lowered request."""
    j_plan, t_plan = plans
    j_chunked = jc.execute_plan_chunked(j_plan, k, list(j_plan.arrays),
                                        span=span, threshold_box=j_box)
    arrays = _t_arrays(t_plan)
    t_chunked = tc.execute_plan_chunked(t_plan, k, arrays, "cpu", span=span,
                                        threshold_box=t_box)
    t_fused = t_executor.execute_plan(t_plan, k, arrays, device="cpu")
    return j_chunked, t_chunked, t_fused


def _aggs():
    return {
        "per_hour": {"date_histogram": {
            "field": "timestamp", "fixed_interval": "1h"},
            "aggs": {"lat_avg": {"avg": {"field": "latency"}}}},
        "lat_stats": {"stats": {"field": "latency"}},
    }


def _rich_aggs():
    """Every mergeable leaf kind: bucket sums/min/max, sketches, HLL
    registers (top-level and per bucket), extended stats, range buckets."""
    return {
        "by_sev": {"terms": {"field": "severity_text", "size": 10},
                   "aggs": {"lat_max": {"max": {"field": "latency"}},
                            "lat_min": {"min": {"field": "latency"}},
                            "lat_pct": {"percentiles": {"field": "latency"}},
                            "tenants": {"cardinality": {
                                "field": "tenant_id"}}}},
        "lat_ext": {"extended_stats": {"field": "latency"}},
        "lat_pct": {"percentiles": {"field": "latency"}},
        "sevs": {"cardinality": {"field": "severity_text"}},
        "lat_ranges": {"range": {"field": "latency", "ranges": [
            {"to": 50.0}, {"from": 25.0, "to": 120.0}, {"from": 100.0}]},
            "aggs": {"t": {"sum": {"field": "tenant_id"}}}},
        "lat_hist": {"histogram": {"field": "latency", "interval": 25.0}},
    }


def _bool_range(Q):
    return Q.Bool(
        must=(Q.Term("severity_text", "ERROR"),),
        filter=(Q.Range("timestamp",
                        lower=Q.RangeBound((T0 + 600) * 10**6, True),
                        upper=Q.RangeBound((T0 + 60 * BIG_DOCS) * 10**6,
                                           False)),
                Q.Range("tenant_id", lower=Q.RangeBound(1, True),
                        upper=Q.RangeBound(3, False))))


# name -> (format, ast, aggs, lowering kwargs, k, span, expected mode)
CASES = {
    "posting_term_span1": ("v3", lambda Q: Q.Term("body", "alpha"), None,
                           {}, 10, POSTING_PAD, "posting"),
    "posting_term_span7": ("v3", lambda Q: Q.Term("body", "alpha"), None,
                           {}, 10, 7 * POSTING_PAD, "posting"),
    "posting_k0_count_only": ("v3", lambda Q: Q.Term("body", "alpha"), None,
                              {}, 0, POSTING_PAD, "posting"),
    # k above one chunk's postings: each chunk returns fewer lanes, the
    # merge must still pad and order like the fused program
    "posting_k_exceeds_chunk": ("v3", lambda Q: Q.Term("body", "beta"),
                                None, {}, 64, POSTING_PAD, "posting"),
    "posting_term_aggs": ("v3", lambda Q: Q.Term("body", "beta"), _aggs(),
                          {}, 10, POSTING_PAD, "posting"),
    "dense_sort_asc": ("v3", lambda Q: Q.MatchAll(), None,
                       {"sort_field": "latency", "sort_order": "asc"}, 10,
                       DOC_PAD, "dense"),
    "dense_sort_desc": ("v3", lambda Q: Q.MatchAll(), None,
                        {"sort_field": "latency", "sort_order": "desc"}, 10,
                        DOC_PAD, "dense"),
    "dense_bool_range": ("v3", _bool_range, None,
                         {"sort_field": "timestamp", "sort_order": "desc"},
                         10, DOC_PAD, "dense"),
    "dense_bool_range_by_score": ("v3", _bool_range, None, {}, 10, DOC_PAD,
                                  "dense"),
    "dense_two_key": ("v3", lambda Q: Q.MatchAll(), None,
                      {"sort_field": "tenant_id", "sort_order": "desc",
                       "sort2_field": "timestamp", "sort2_order": "asc"},
                      15, DOC_PAD, "dense"),
    "dense_search_after": ("v3", lambda Q: Q.MatchAll(), None,
                           {"sort_field": "latency", "sort_order": "desc",
                            "search_after": (123.5, None, "lt_tie", 7)},
                           10, DOC_PAD, "dense"),
    "dense_search_after_doc_tie": ("v3", lambda Q: Q.MatchAll(), None,
                                   {"sort_field": "tenant_id",
                                    "sort_order": "desc",
                                    "search_after": (2.0, None, "lt_tie",
                                                     1500)},
                                   10, DOC_PAD, "dense"),
    "dense_aggs": ("v3", lambda Q: Q.MatchAll(), _aggs(), {}, 0, DOC_PAD,
                   "dense"),
    "dense_aggs_with_hits": ("v3", lambda Q: Q.MatchAll(), _aggs(),
                             {"sort_field": "timestamp",
                              "sort_order": "desc"}, 10, DOC_PAD, "dense"),
    "dense_every_agg_kind": ("v3", _bool_range, _rich_aggs(),
                             {"sort_field": "latency"}, 10, DOC_PAD,
                             "dense"),
    # v2: no impact side arrays, posting chunks slice ids/tfs only
    "v2_posting": ("v2", lambda Q: Q.Term("body", "alpha"), None, {}, 10,
                   POSTING_PAD, "posting"),
    "v2_dense": ("v2", lambda Q: Q.MatchAll(), None,
                 {"sort_field": "latency", "sort_order": "desc"}, 10,
                 DOC_PAD, "dense"),
    # v1: no packed lanes, dense chunks slice plain doc-space arrays
    "v1_posting": ("v1", lambda Q: Q.Term("body", "alpha"), None, {}, 10,
                   POSTING_PAD, "posting"),
    "v1_dense": ("v1", lambda Q: Q.MatchAll(), None,
                 {"sort_field": "latency", "sort_order": "desc"}, 10,
                 DOC_PAD, "dense"),
    "v1_dense_bool_range_aggs": ("v1", _bool_range, _aggs(),
                                 {"sort_field": "timestamp"}, 10, DOC_PAD,
                                 "dense"),
}


# --- chunked == fused == the JAX chunked scan --------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_chunked_equals_fused_and_jax(splits, case):
    fmt, ast, aggs, kw, k, span, mode = CASES[case]
    plans = _lower(splits[fmt], ast, aggs, **kw)
    t_mode = tc.chunk_mode(plans[1])
    assert t_mode is not None and t_mode[0] == mode
    assert t_mode == jc.chunk_mode(plans[0])
    assert len(tc.chunk_spans(t_mode[1], span, t_mode[2])) >= 2
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    j_chunked, t_chunked, t_fused = _run_three(plans, k, span)
    assert t_chunked is not None and "partial" not in t_chunked
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches >= 2
    assert_same_result(t_fused, t_chunked, f"{case}: chunked vs fused")
    assert_same_result(j_chunked, t_chunked, f"{case}: vs JAX chunked")


def test_threshold_pushdown_boundary_tightening(splits):
    """A shared ThresholdBox above the plan's threshold (but below the true
    10th value) tightens each later chunk's pushed threshold; the >= mask
    keeps every final top-K row, so the hits equal the fused program's,
    and the JAX scan's with the same box."""
    plans = _lower(splits["v3"], lambda Q: Q.MatchAll(),
                   sort_field="latency", sort_order="desc",
                   sort_value_threshold=10.0)
    assert plans[1].threshold_slot >= 0
    fused = t_executor.execute_plan(plans[1], 10, _t_arrays(plans[1]),
                                    device="cpu")
    tenth = float(fused["sort_values"][9]) - 1e-6
    j_box, t_box = JThresholdBox(), TThresholdBox()
    j_box.update(tenth)
    t_box.update(tenth)
    j_chunked, t_chunked, _ = _run_three(plans, 10, DOC_PAD, j_box, t_box)
    for key in ("sort_values", "doc_ids"):
        np.testing.assert_array_equal(t_chunked[key], fused[key])
        np.testing.assert_array_equal(t_chunked[key], j_chunked[key])
    assert t_chunked["count"] == fused["count"] == j_chunked["count"]


@pytest.mark.parametrize("reason", ["single_chunk", "disabled", "composite"])
def test_plans_that_do_not_chunk(splits, reason):
    """A span covering everything, chunking switched off, and composite
    aggregations each leave the fused program to the caller (None)."""
    aggs = None
    ast = lambda Q: Q.Term("body", "alpha")   # noqa: E731
    kw, span = {}, POSTING_PAD
    if reason == "single_chunk":
        ast = lambda Q: Q.MatchAll()   # noqa: E731
        kw, span = {"sort_field": "latency", "sort_order": "desc"}, \
            4 * DOC_PAD
    elif reason == "disabled":
        tc.CHUNKING.set(enabled=False)
    else:
        aggs = {"by_sev": {"composite": {"size": 8, "sources": [
            {"sev": {"terms": {"field": "severity_text"}}}]}}}
        ast = lambda Q: Q.MatchAll()   # noqa: E731
    _, t_plan = _lower(splits["v3"], ast, aggs, **kw)
    if reason == "composite":
        assert tc.chunk_mode(t_plan) is None
    assert tc.execute_plan_chunked(t_plan, 10, _t_arrays(t_plan), "cpu",
                                   span=span) is None


def test_unknown_knob_is_refused():
    with pytest.raises(AttributeError):
        tc.CHUNKING.set(posting_spam=128)


# --- signed zeros: the port's merge ranks them as its fused top-k ----------

def _zeros_mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("timestamp", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("gain", dm.FieldType.F64, fast=True),
            # positions keep the postings in doc order, so a field sort
            # over one term stays in posting space
            dm.FieldMapping("body", dm.FieldType.TEXT, record="position"),
        ],
        timestamp_field="timestamp")


@pytest.fixture(scope="module")
def zeros_split():
    """2,500 docs (three dense chunks): 1.0 on 26 docs, -0.0 on the rest
    of the first chunk, +0.0 on 40 docs of the second, -1.0 elsewhere; so
    a fused single-key top-300 ranks the later +0.0 docs above the earlier
    -0.0 ones and cuts among the -0.0."""
    writer = JSplitWriter(_zeros_mapper(jdm))
    for i in range(2500):
        gain = 1.0 if i % 97 == 0 else (
            -0.0 if i < 1024 else
            (0.0 if i < 2048 and i % 25 == 0 else -1.0))
        writer.add_json_doc({"timestamp": 1_600_000_000 + i,
                             "body": "alpha" if i % 3 else "beta",
                             "gain": gain})
    return _readers(writer.finish(), "zeros")


@pytest.mark.parametrize("query,span", [("match_all", DOC_PAD),
                                        ("term", 4 * POSTING_PAD)])
def test_signed_zeros_chunked_equals_fused(zeros_split, query, span):
    """Held against the port's fused program and the JAX program's EXACT
    fused top-k (`exact=True`): the 40 +0.0 docs of chunk 2 rank above
    the -0.0 docs of chunk 1 in both."""
    from quickwit_tpu.search.plan import lower_request as jl
    j_reader, t_reader = zeros_split

    def ast(Q):
        return Q.MatchAll() if query == "match_all" else \
            Q.Term("body", "alpha")

    j_plan = jl(ast(JQ), _zeros_mapper(jdm), j_reader, [], sort_field="gain")
    t_plan = t_lower(ast(TQ), _zeros_mapper(tdm), t_reader, [],
                     sort_field="gain")
    assert tc.chunk_mode(t_plan)[0] == ("dense" if query == "match_all"
                                        else "posting")
    arrays = _t_arrays(t_plan)
    k = 300
    chunked = tc.execute_plan_chunked(t_plan, k, arrays, "cpu", span=span)
    fused = t_executor.execute_plan(t_plan, k, arrays, device="cpu")
    import jax.numpy as jnp
    exact = j_executor.readback_plan_result(j_executor.dispatch_plan(
        j_plan, k, [jnp.asarray(a) for a in j_plan.arrays], exact=True))
    assert_same_result(fused, chunked, "chunked vs fused")
    np.testing.assert_array_equal(chunked["doc_ids"], exact["doc_ids"])
    np.testing.assert_array_equal(_bits(chunked["sort_values"]),
                                  _bits(exact["sort_values"]))
    zeros = chunked["sort_values"][chunked["sort_values"] == 0.0]
    signs = list(np.signbit(zeros))
    assert signs == sorted(signs) and any(signs) and not all(signs)


@pytest.fixture(scope="module")
def nan_split():
    """2,500 docs with NaN gains on docs 1500 and 1600 (the second dense
    chunk) and small integers elsewhere."""
    writer = JSplitWriter(_zeros_mapper(jdm))
    for i in range(2500):
        writer.add_json_doc({
            "timestamp": 1_600_000_000 + i, "body": "alpha",
            "gain": float("nan") if i in (1500, 1600) else float(i % 7)})
    return _readers(writer.finish(), "nan")


def test_nan_sort_values_chunked_equals_fused(nan_split):
    """A single-key sort ranks +NaN first (`lax.top_k`'s order); the
    chunked scan keeps both NaN docs on top, under their GLOBAL doc ids,
    as the fused program does. (The JAX merge sorts NaN last and drops
    both: ROADMAP §3.)"""
    _, t_reader = nan_split
    t_plan = t_lower(TQ.MatchAll(), _zeros_mapper(tdm), t_reader, [],
                     sort_field="gain")
    arrays = _t_arrays(t_plan)
    chunked = tc.execute_plan_chunked(t_plan, 10, arrays, "cpu",
                                      span=DOC_PAD)
    fused = t_executor.execute_plan(t_plan, 10, arrays, device="cpu")
    assert_same_result(fused, chunked)
    assert list(chunked["doc_ids"][:2]) == [1500, 1600]
    assert np.isnan(chunked["sort_values"][:2]).all()


def test_merge_ranks_like_the_device_selections():
    """`merge_topk_chunks` over chunks of one key vector equals
    `exact_topk` of the whole vector (IEEE total order), and of two keys
    equals `exact_topk_2key` (`lax.sort`'s order)."""
    rng = np.random.RandomState(3)
    pool = np.array([-0.0, 0.0, np.nan, -np.nan, 1.0, -1.0, -np.inf, 2.5])
    vals = pool[rng.randint(0, len(pool), 512)]
    vals2 = pool[rng.randint(0, len(pool), 512)]
    ids = np.arange(512, dtype=np.int32)
    chunks1, chunks2 = [], []
    for lo in range(0, 512, 128):
        sl = slice(lo, lo + 128)
        v, pos = t_topk.exact_topk(torch.from_numpy(vals[sl]), 40)
        chunks1.append((v.numpy(), None, ids[sl][pos.numpy()],
                        np.zeros(40, np.float32)))
        a, b, pos = t_topk.exact_topk_2key(torch.from_numpy(vals[sl]),
                                           torch.from_numpy(vals2[sl]), 40)
        chunks2.append((a.numpy(), b.numpy(), ids[sl][pos.numpy()],
                        np.zeros(40, np.float32)))
    _, pos = t_topk.exact_topk(torch.from_numpy(vals), 40)
    np.testing.assert_array_equal(t_topk.merge_topk_chunks(chunks1, 40)[2],
                                  pos.numpy())
    _, _, pos = t_topk.exact_topk_2key(torch.from_numpy(vals),
                                       torch.from_numpy(vals2), 40)
    np.testing.assert_array_equal(t_topk.merge_topk_chunks(chunks2, 40)[2],
                                  pos.numpy())


# --- dense mode: the device rebase ------------------------------------------

def test_dense_device_rebase_matches_host_chunk_plan(splits):
    """Each dense chunk's device operands equal `dense_chunk_plan`'s host
    arrays: posting ids rebased into the window on the device (sentinel
    `span` outside it), every other sliced slot a view of the staged
    tensor, not a copy."""
    _, t_plan = _lower(splits["v3"], _bool_range,
                       sort_field="timestamp", sort_order="desc")
    slots = tc.chunk_slot_plan(t_plan)
    ids_slots = {ids for ids, _ in slots.posting_pairs}
    assert ids_slots and slots.zone_slots and slots.doc_slots
    arrays = _t_arrays(t_plan)
    for lo, hi in tc.chunk_spans(t_plan.num_docs_padded, DOC_PAD, DOC_PAD):
        chunk = tc.dense_chunk_plan(t_plan, lo, hi - lo)
        dev = tc._chunk_device_arrays(t_plan, chunk, arrays,
                                      (lo, hi - lo, ids_slots))
        for slot, (host, got) in enumerate(zip(chunk.arrays, dev)):
            np.testing.assert_array_equal(got.numpy(), host,
                                          err_msg=f"slot {slot}")
            assert got.dtype == arrays[slot].dtype
            if slot not in ids_slots:
                assert (got.untyped_storage().data_ptr()
                        == arrays[slot].untyped_storage().data_ptr())
        for slot in ids_slots:
            assert (chunk.arrays[slot] == hi - lo).any()


# --- early termination --------------------------------------------------------

def test_early_termination_skips_cold_chunks(splits):
    """A threshold pushdown on an impact-ordered term cuts the posting tail
    host-side (count_override = df); the scan stops as soon as no
    remaining chunk's block-max bound can beat the current Kth score,
    with the fused program's top-K and the exact df as its count."""
    plans = _lower(splits["v3"], lambda Q: Q.Term("body", "alpha"),
                   sort_value_threshold=0.0005)
    t_plan = plans[1]
    assert t_plan.count_override is not None, "prefix cutoff did not engage"
    _, total, _ = tc.chunk_mode(t_plan)
    n_chunks = len(tc.chunk_spans(total, POSTING_PAD, POSTING_PAD))
    assert n_chunks >= 3
    assert tc._early_term_eligible(t_plan, 10, "posting")
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    early = t_metrics.CHUNK_EARLY_TERMINATIONS_TOTAL.get()
    j_chunked, t_chunked, t_fused = _run_three(plans, 10, POSTING_PAD)
    for key in ("sort_values", "doc_ids", "scores"):
        np.testing.assert_array_equal(t_chunked[key], t_fused[key])
        np.testing.assert_array_equal(t_chunked[key], j_chunked[key])
    assert t_metrics.CHUNK_EARLY_TERMINATIONS_TOTAL.get() == early + 1
    assert (t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches) < n_chunks
    assert int(t_chunked["count"]) == t_plan.count_override \
        == int(j_chunked["count"])


# --- cancellation --------------------------------------------------------------

class _CancelAtBoundary:
    """Chaos shim: flips the token the first time the scan reaches a chunk
    boundary (the cancel is then observed at the NEXT boundary)."""

    def __init__(self, token):
        self.token = token
        self.fired = False

    def perturb(self, operation):
        if operation == "kernel.chunk_yield" and not self.fired:
            self.fired = True
            self.token.cancel("test cancel")


def test_cancelled_query_stops_within_one_boundary(splits):
    """Cancelled at boundary 1, observed at boundary 2: exactly two chunks
    ran, and the result is their honest partial merge."""
    _, t_plan = _lower(splits["v3"], lambda Q: Q.Term("body", "alpha"))
    _, total, _ = tc.chunk_mode(t_plan)
    assert len(tc.chunk_spans(total, POSTING_PAD, POSTING_PAD)) >= 3
    arrays = _t_arrays(t_plan)
    token = CancellationToken()
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    with cancel_scope(token):
        result = tc.execute_plan_chunked(
            t_plan, 10, arrays, "cpu", span=POSTING_PAD,
            fault_injector=_CancelAtBoundary(token))
    assert result.get("partial") is True
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches == 2
    two = tc.execute_plan_chunked(
        tc.posting_chunk_plan(t_plan, 0, 2 * POSTING_PAD), 10,
        [a[:2 * POSTING_PAD] if slot in (t_plan.root.ids_slot,
                                         t_plan.root.tfs_slot) else a
         for slot, a in enumerate(arrays)], "cpu", span=POSTING_PAD)
    assert_same_result(two, {k: v for k, v in result.items()
                             if k != "partial"})
    full = t_executor.execute_plan(t_plan, 10, arrays, device="cpu")
    assert 0 < int(result["count"]) < int(full["count"])
    assert np.asarray(result["sort_values"]).shape[0] <= 10


def test_cancel_before_any_chunk_raises(splits):
    """Boundary checks run from the SECOND chunk on: chunk one executes,
    boundary two observes the cancel; with partials off that is a typed
    CancelledQuery."""
    _, t_plan = _lower(splits["v3"], lambda Q: Q.Term("body", "alpha"))
    token = CancellationToken()
    token.cancel("early")
    tc.CHUNKING.set(partial_on_cancel=False)
    with cancel_scope(token):
        with pytest.raises(CancelledQuery):
            tc.execute_plan_chunked(t_plan, 10, _t_arrays(t_plan), "cpu",
                                    span=POSTING_PAD)


# --- preemption ----------------------------------------------------------------

def _trip_overload():
    OVERLOAD.configure(enabled=True, target_wait_secs=0.01)
    for _ in range(20):
        OVERLOAD.note_wait(1.0)
    assert OVERLOAD.shed_floor() > 0


def test_preempt_gate_yields_only_under_ladder_and_higher_class():
    gate = tc.PREEMPT_GATE
    assert not gate.should_yield(0)  # calm ladder: never yield
    _trip_overload()
    assert not gate.should_yield(0)  # nobody higher running
    with gate.running(2):
        assert gate.should_yield(0)
        assert gate.should_yield(1)
        assert not gate.should_yield(2)  # own class: no yield
    assert not gate.should_yield(0)


def test_background_scan_parks_while_interactive_runs(splits):
    """A background chunked scan under a tripped ladder parks at its
    boundary while an interactive query is active, resumes when it
    finishes, and still returns the exact fused result."""
    _, t_plan = _lower(splits["v3"], lambda Q: Q.Term("body", "alpha"))
    arrays = _t_arrays(t_plan)
    fused = t_executor.execute_plan(t_plan, 10, arrays, device="cpu")
    preempts = t_metrics.PREEMPT_TOTAL.get()
    _trip_overload()
    release = threading.Event()

    def interactive():
        with tc.PREEMPT_GATE.running(2):
            release.wait(5.0)

    thread = threading.Thread(target=interactive, daemon=True)
    thread.start()
    try:
        while not tc.PREEMPT_GATE.should_yield(0):
            time.sleep(0.005)
        threading.Timer(0.15, release.set).start()
        with tenant_scope(TenantContext.for_class("bg", "background")):
            result = tc.execute_plan_chunked(t_plan, 10, arrays, "cpu",
                                             span=POSTING_PAD)
    finally:
        release.set()
        thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert_same_result(fused, result)
    assert t_metrics.PREEMPT_TOTAL.get() > preempts


def test_parked_state_registry_caps_and_evicts():
    registry = tc.ParkedStateRegistry(tenant_cap_bytes=1000)
    first = registry.park("t1", 600)
    second = registry.park("t1", 600)   # over the tenant cap: evicts first
    assert first.evicted and not second.evicted
    assert registry.parked_bytes() == 600
    registry.release(second)
    assert registry.parked_bytes() == 0
    registry.release(first)  # releasing an evicted ticket is a no-op
    assert registry.parked_bytes() == 0


# --- adaptive sizing and spans --------------------------------------------------

def test_chunk_sizer_targets_boundary_interval():
    sizer = tc._ChunkSizer()
    assert sizer.span_for("dense", DOC_PAD) is None  # cold: fused path
    # 1ms per 1024 docs -> ~10ms target wants ~10240 docs, DOC_PAD aligned
    sizer.observe("dense", 1024, 0.001)
    span = sizer.span_for("dense", DOC_PAD)
    assert span is not None and span % DOC_PAD == 0
    assert 4 * DOC_PAD <= span <= 16 * DOC_PAD
    # slower observations shrink the span toward the target
    for _ in range(32):
        sizer.observe("dense", 1024, 0.1)
    assert sizer.span_for("dense", DOC_PAD) == DOC_PAD


def test_learnt_rate_chunks_a_plan_without_a_span(splits):
    """After one observed chunk rate the sizer chunks an eligible plan with
    no explicit span: the process-wide hazard the fixture resets."""
    _, t_plan = _lower(splits["v3"], lambda Q: Q.MatchAll(),
                       sort_field="latency")
    arrays = _t_arrays(t_plan)
    assert tc.maybe_execute_chunked(t_plan, 10, arrays, "cpu") is None
    tc.CHUNK_SIZER.observe("dense", DOC_PAD, 0.01)
    chunked = tc.maybe_execute_chunked(t_plan, 10, arrays, "cpu")
    assert_same_result(t_executor.execute_plan(t_plan, 10, arrays,
                                               device="cpu"), chunked)


def test_chunk_spans_alignment():
    assert tc.chunk_spans(2048, 1024, 1024) == [(0, 1024), (1024, 2048)]
    assert tc.chunk_spans(1100, 128, 128) == [
        (lo, min(lo + 128, 1100)) for lo in range(0, 1100, 128)]
    # sub-align spans clamp up to one alignment unit
    assert tc.chunk_spans(256, 1, 128) == [(0, 128), (128, 256)]
    for total, span, align in ((2048, 1024, 1024), (1100, 128, 128),
                               (256, 1, 128), (999_552, 131_072, 128)):
        assert tc.chunk_spans(total, span, align) == \
            jc.chunk_spans(total, span, align)


# --- the cancel registry ----------------------------------------------------------

def test_cancel_registry_flips_only_a_live_token():
    registry = QueryCancelRegistry()
    first, retry = CancellationToken(), CancellationToken()
    registry.register("q1", first)
    registry.register("q1", retry)          # a retry replaces the token
    registry.unregister("q1", first)        # the stale cleanup is a no-op
    assert registry.get("q1") is retry and len(registry) == 1
    before = t_metrics.SEARCH_CANCEL_TOTAL.get()
    assert registry.cancel("q1", "user gave up")
    assert retry.cancelled and retry.reason == "user gave up"
    assert not first.cancelled
    assert not registry.cancel("unknown")
    # the registry counts nothing, as the JAX registry: the REST DELETE
    # handler counts each request once (test_torch_rest_api.py)
    assert t_metrics.SEARCH_CANCEL_TOTAL.get() == before
    registry.unregister("q1", retry)
    assert len(registry) == 0


# --- the leaf hook and the node's service -------------------------------------

SERVICE_DOCS = 2100   # pads to 3072 docs: three dense chunks per split


def _hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def assert_same_leaf_response(got, want):
    """Hits, counts, failed splits and aggregation states (f64 sums to
    rtol 1e-12), whichever package answered."""
    from test_torch_residency import assert_states_close
    assert got.num_hits == want.num_hits
    assert _hits(got) == _hits(want)
    assert ([(f.split_id, f.error, f.retryable) for f in got.failed_splits]
            == [(f.split_id, f.error, f.retryable)
                for f in want.failed_splits])
    assert got.num_successful_splits == want.num_successful_splits
    assert_states_close(want.intermediate_aggs, got.intermediate_aggs)


@pytest.fixture(scope="module")
def service_engines():
    """(jax, torch) `Engine`s of tests/test_torch_residency.py, each over
    its own copy of a two-split corpus of SERVICE_DOCS docs per split
    (bytes asserted equal; each package's writer on its Python path)."""
    from test_torch_indexing import force_python_paths
    from test_torch_residency import Engine
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        for name in ("jax", "torch"):
            engine = Engine(name)
            uri = "ram:///chunked-service"
            storage = engine._storage_mod.RamStorage(engine.uri.Uri.parse(uri))
            rng = np.random.RandomState(7)
            engine.blobs, engine.offsets = [], []
            for n in range(2):
                writer = engine._writer_cls(engine.mapper)
                for i in range(SERVICE_DOCS):
                    writer.add_json_doc({
                        "body": f"log entry {i} "
                                f"{'error' if i % 5 == 0 else 'ok'}",
                        "ts": 1_700_000_000 + n * 3600 * 24 + i * 7,
                        "severity": ["INFO", "WARN", "ERROR"][i % 3],
                        "latency": float(rng.gamma(2.0, 50.0)),
                    })
                data = writer.finish()
                storage.put(f"s{n}.split", data)
                engine.blobs.append(data)
                engine.offsets.append(engine.models.SplitIdAndFooter(
                    split_id=f"s{n}", storage_uri=uri, file_len=len(data),
                    num_docs=SERVICE_DOCS))
            engine.resolver = engine._storage_mod.StorageResolver()
            engine.resolver.register(engine.uri.Protocol.RAM,
                                     lambda _uri, s=storage: s)
            out[name] = engine
    assert out["jax"].blobs == out["torch"].blobs
    return out["jax"], out["torch"]


def _set_spans(**kw):
    for mod in (jc, tc):
        mod.CHUNKING.set(**kw)


SERVICE_REQUESTS = {
    # posting mode: 420 impact-ordered postings per split, 4 chunks
    "by_score": dict(sort=(), aggs=None),
    # dense mode: sorted by a column, with aggregations, 3 chunks
    "by_ts_aggs": dict(sort=(("ts", "desc"),)),
    "two_key": dict(sort=(("latency", "desc"), ("ts", "asc")),
                    aggs=None, max_hits=7),
}


@pytest.mark.parametrize("name", list(SERVICE_REQUESTS))
def test_service_with_spans_matches_fused_and_jax(service_engines, name):
    """`SearchService.leaf_search` with spans set equals the same call
    with chunking off, and the JAX service with the same spans; the scan
    ran (chunk dispatches rose) and restarted nowhere."""
    jax_engine, torch_engine = service_engines
    kw = SERVICE_REQUESTS[name]
    _set_spans(posting_span=POSTING_PAD, doc_span=DOC_PAD)
    t_svc, _ = torch_engine.cold_service(torch_engine.resolver)
    j_svc, _ = jax_engine.cold_service(jax_engine.resolver)
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    restarts = t_metrics.CHUNK_RESTARTS_TOTAL.get()
    got = torch_engine.run(t_svc, torch_engine.offsets,
                           torch_engine.request(**kw))
    assert got.num_hits > 0 and not got.failed_splits
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches >= 6
    assert t_metrics.CHUNK_RESTARTS_TOTAL.get() == restarts
    assert_same_leaf_response(got, jax_engine.run(
        j_svc, jax_engine.offsets, jax_engine.request(**kw)))
    tc.CHUNKING.set(enabled=False)
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    fused = torch_engine.run(t_svc, torch_engine.offsets,
                             torch_engine.request(**kw))
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() == dispatches
    assert_same_leaf_response(got, fused)


def test_service_cancelled_mid_split(service_engines):
    """Cancelled at the first boundary of split s0 (observed at the next):
    s0 answers with its two merged chunks and a non-retryable cancel
    failure, s1 never runs; the same answer as the JAX service. A repeat
    of the request then answers in full: the port keeps no tier of a
    partial split (the JAX service would serve the partial from its leaf
    cache, ROADMAP §3)."""
    from quickwit_tpu.common import deadline as j_deadline
    jax_engine, torch_engine = service_engines
    _set_spans(posting_span=POSTING_PAD, doc_span=DOC_PAD)
    answers = {}
    for engine, scope in ((torch_engine, cancel_scope),
                          (jax_engine, j_deadline.cancel_scope)):
        token = (CancellationToken() if engine is torch_engine
                 else j_deadline.CancellationToken())
        svc, _ = engine.service(engine.resolver,
                                fault_injector=_CancelAtBoundary(token))
        with scope(token):
            answers[engine.name] = engine.run(svc, engine.offsets,
                                              engine.request(sort=()))
        if engine is torch_engine:
            repeat = engine.run(svc, engine.offsets, engine.request(sort=()))
    got = answers["torch"]
    assert [f.split_id for f in got.failed_splits] == ["s0", "s1"]
    assert not any(f.retryable for f in got.failed_splits)
    assert got.failed_splits[0].error.startswith(
        "query cancelled: progressive partial results")
    assert_same_leaf_response(got, answers["jax"])
    full_svc, _ = torch_engine.cold_service(torch_engine.resolver)
    full = torch_engine.run(full_svc, torch_engine.offsets,
                            torch_engine.request(sort=()))
    assert 0 < got.num_hits < full.num_hits
    assert_same_leaf_response(repeat, full)


def test_leaf_cancelled_scan_reports_partial_split(splits):
    """`execute_prepared_split` turns a cancelled scan's partial result into
    a successful split plus the non-retryable cancel failure, as the JAX
    leaf does."""
    from quickwit_tpu.common import deadline as j_deadline
    from quickwit_tpu.search import leaf as j_leaf
    from quickwit_tpu.search import models as j_models
    from quickwit_tpu_torch.search import leaf as t_leaf
    from quickwit_tpu_torch.search import models as t_models
    _set_spans(posting_span=POSTING_PAD)
    out = {}
    for name, leaf, models, reader, mapper, Q, dl in (
            ("jax", j_leaf, j_models, splits["v3"][0], J_MAPPER, JQ,
             j_deadline),
            ("torch", t_leaf, t_models, splits["v3"][1], T_MAPPER, TQ,
             None)):
        req = models.SearchRequest(index_ids=["c"],
                                   query_ast=Q.Term("body", "alpha"),
                                   max_hits=10)
        plan = leaf.prepare_plan_only(req, mapper, reader, "c0")
        token = (dl.CancellationToken() if dl else CancellationToken())
        with (dl.cancel_scope if dl else cancel_scope)(token):
            if name == "jax":
                arrays = leaf.warmup_device_arrays(reader, plan)[0]
                out[name] = leaf.execute_prepared_split(
                    req, mapper, reader, "c0", plan, arrays,
                    fault_injector=_CancelAtBoundary(token))
            else:
                arrays = leaf.warmup_device_arrays(reader, plan,
                                                   device="cpu")[0]
                out[name] = leaf.execute_prepared_split(
                    req, mapper, reader, "c0", plan, arrays, "cpu",
                    fault_injector=_CancelAtBoundary(token))
    got = out["torch"]
    assert got.num_successful_splits == 1 and len(got.failed_splits) == 1
    assert not got.failed_splits[0].retryable
    assert_same_leaf_response(got, out["jax"])
