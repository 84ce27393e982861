"""The port's chunked query-group scan (search/chunkexec.py's
`execute_group_chunked`) against solo runs of the port and of the JAX
package.

A stacked group composed with chunked execution runs one stacked dispatch
per chunk over its live lanes, with one carried state per lane. Each lane
must equal its solo fused run and its solo chunked run of the port, and
the JAX package's solo fused run (f64 sums to rtol 1e-12, all else
exactly), in posting mode (v3 impact order, and v2) and dense mode, with
lanes masked on entry, cancelled mid-scan and expired. The splits and
helpers are `tests/test_torch_chunked.py`'s, and so is the fixture that
swaps in fresh chunking knobs and sizer in both packages for every test.

The signed-zero and NaN inputs of that file run here as a group and are
held against the JAX package's EXACT fused top-k, not its group scan,
which merges through the lexsort that ranks the zeros equal and drops the
NaN hits (`test_nan_group_rebases_every_lane` shows the latter).
"""

import numpy as np
import pytest

from quickwit_tpu.search import chunkexec as jc
from quickwit_tpu.search import executor as j_executor

from quickwit_tpu_torch.common.deadline import (
    CancellationToken, CancelledQuery, Deadline, DeadlineExceeded,
)
from quickwit_tpu_torch.index.format import DOC_PAD, POSTING_PAD
from quickwit_tpu_torch.observability import metrics as t_metrics
from quickwit_tpu_torch.search import chunkexec as tc
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search.batcher import QueryBatcher

from test_torch_chunked import (  # noqa: F401 - fixtures used by name
    J_MAPPER, SEVERITIES, T0, JSplitWriter, _aggs, _bits, _docs, _lower,
    _readers, _t_arrays, _zeros_mapper, assert_same_result, fresh_chunking,
    nan_split, splits, zeros_split,
)

GROUP_DOCS = 1800   # each severity's postings pad to 512: 4 posting chunks


@pytest.fixture(scope="module")
def group_splits():
    """format -> (JAX reader, port reader) of a corpus whose four severity
    terms pad to one posting length (so they stack), v3 and v2."""
    out = {}
    for fmt, env in (("v3", {}), ("v2", {"QW_DISABLE_IMPACT": "1"})):
        with pytest.MonkeyPatch.context() as mp:
            for key, value in env.items():
                mp.setenv(key, value)
            writer = JSplitWriter(J_MAPPER)
            for doc in _docs(GROUP_DOCS, seed=5):
                writer.add_json_doc(doc)
            out[fmt] = _readers(writer.finish(), f"group-{fmt}")
    return out


class Lane:
    """One request of a group, lowered by both packages; the port's arrays
    on the CPU."""

    def __init__(self, readers, ast, aggs=None, **kw):
        self.j_plan, self.plan = _lower(readers, ast, aggs, **kw)
        self.arrays = _t_arrays(self.plan)

    def fused(self, k):
        return t_executor.execute_plan(self.plan, k, self.arrays,
                                       device="cpu")

    def chunked(self, k, span):
        return tc.execute_plan_chunked(self.plan, k, self.arrays, "cpu",
                                       span=span)

    def jax_fused(self, k):
        return j_executor.execute_plan(self.j_plan, k,
                                       list(self.j_plan.arrays))


def group(lanes, k, span, **kw):
    return tc.execute_group_chunked([lane.plan for lane in lanes], k,
                                    [lane.arrays for lane in lanes],
                                    span=span, device="cpu", **kw)


def assert_lane_exact(got, lane, k, span, label):
    assert_same_result(lane.fused(k), got, f"{label} vs port fused")
    assert_same_result(lane.chunked(k, span), got, f"{label} vs port chunked")
    assert_same_result(lane.jax_fused(k), got, f"{label} vs jax fused")


def term(sev):
    return lambda Q: Q.Term("severity_text", sev)


def window_bool(lo_min, hi_min):
    return lambda Q: Q.Bool(
        must=(Q.Term("severity_text", "ERROR"),),
        filter=(Q.Range("timestamp",
                        lower=Q.RangeBound((T0 + 60 * lo_min) * 10**6, True),
                        upper=Q.RangeBound((T0 + 60 * hi_min) * 10**6,
                                           False)),))


def _term_lanes(readers, sevs=SEVERITIES, **kw):
    lanes = [Lane(readers, term(s), **kw) for s in sevs]
    assert len({lane.plan.structure_digest(10) for lane in lanes}) == 1
    return lanes


# name -> (split set and format, lanes builder, k, span, mode)
CASES = {
    "posting_v3": ("group_v3", lambda r: _term_lanes(r), 10, POSTING_PAD,
                   "posting"),
    "posting_v3_k64": ("group_v3", lambda r: _term_lanes(r), 64, POSTING_PAD,
                       "posting"),
    "posting_v2": ("group_v2", lambda r: _term_lanes(r), 10, POSTING_PAD,
                   "posting"),
    "posting_aggs": ("group_v3", lambda r: _term_lanes(r, aggs=_aggs()), 10,
                     POSTING_PAD, "posting"),
    "dense_windows_by_ts": ("v3", lambda r: [
        Lane(r, window_bool(60 * d, 60 * d + 600), sort_field="timestamp",
             sort_order="desc") for d in range(4)], 10, DOC_PAD, "dense"),
    "dense_windows_by_score_aggs": ("v3", lambda r: [
        Lane(r, window_bool(60 * d, 60 * d + 600), _aggs())
        for d in range(4)], 10, DOC_PAD, "dense"),
    "dense_v1_windows": ("v1", lambda r: [
        Lane(r, window_bool(60 * d, 60 * d + 600), sort_field="timestamp")
        for d in range(3)], 10, DOC_PAD, "dense"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_group_chunked_equals_solo_runs(splits, group_splits, case):
    fmt, build, k, span, mode = CASES[case]
    lanes = build(group_splits[fmt[6:]] if fmt.startswith("group_")
                  else splits[fmt])
    assert tc.chunk_mode(lanes[0].plan)[0] == mode
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    results = group(lanes, k, span)
    assert results is not None and len(results) == len(lanes)
    chunks = len(tc.chunk_spans(tc.chunk_mode(lanes[0].plan)[1], span,
                                tc.chunk_mode(lanes[0].plan)[2]))
    assert chunks >= 2
    # one stacked dispatch per chunk for the whole group
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches == chunks
    for i, (got, lane) in enumerate(zip(results, lanes)):
        assert_lane_exact(got, lane, k, span, f"{case} lane {i}")


def test_posting_group_is_one_lane_call_per_chunk(group_splits, monkeypatch):
    lanes = _term_lanes(group_splits["v3"])
    calls = []
    real = t_executor.score_topk_lanes
    monkeypatch.setattr(t_executor, "score_topk_lanes",
                        lambda ls, k: calls.append(len(ls)) or real(ls, k))
    group(lanes, 10, POSTING_PAD)
    chunks = len(tc.chunk_spans(tc.chunk_mode(lanes[0].plan)[1],
                                POSTING_PAD, POSTING_PAD))
    assert calls == [len(lanes)] * chunks


def test_group_does_not_chunk_when_the_structure_does_not(group_splits):
    lanes = _term_lanes(group_splits["v3"])
    assert group(lanes, 10, 4 * POSTING_PAD) is None      # one chunk
    tc.CHUNKING.set(enabled=False)
    assert group(lanes, 10, POSTING_PAD) is None


class _CancelAt:
    """Cancels `token` at the scan's first chunk boundary (observed at the
    next one)."""

    def __init__(self, token):
        self.token = token

    def perturb(self, operation):
        if operation == "kernel.chunk_yield" and not self.token.cancelled:
            self.token.cancel("lane cancelled mid-scan")


def test_group_masks_cancels_and_expires_lanes(group_splits):
    lanes = _term_lanes(group_splits["v3"])
    spans = tc.chunk_spans(tc.chunk_mode(lanes[0].plan)[1], POSTING_PAD,
                           POSTING_PAD)
    assert len(spans) >= 3
    mid = CancellationToken()
    results = group(lanes, 10, POSTING_PAD,
                    valid=[True, False, True, True],
                    cancels=[mid, None, None, None],
                    deadlines=[None, None, Deadline.after(0.0), None],
                    fault_injector=_CancelAt(mid))
    assert results[1] is None                            # masked on entry
    assert isinstance(results[2], DeadlineExceeded)      # expired
    # cancelled at boundary 1, observed at boundary 2: two chunks merged
    partial = results[0]
    assert partial["partial"] is True
    two = tc.execute_plan_chunked(
        tc.posting_chunk_plan(lanes[0].plan, 0, 2 * POSTING_PAD), 10,
        [a[:2 * POSTING_PAD] if s in (lanes[0].plan.root.ids_slot,
                                      lanes[0].plan.root.tfs_slot) else a
         for s, a in enumerate(lanes[0].arrays)], "cpu", span=POSTING_PAD)
    assert_same_result(two, {k: v for k, v in partial.items()
                             if k != "partial"})
    assert_lane_exact(results[3], lanes[3], 10, POSTING_PAD, "survivor")


def test_group_with_every_lane_masked_runs_nothing(group_splits):
    lanes = _term_lanes(group_splits["v3"])
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    assert group(lanes, 10, POSTING_PAD, valid=[False] * 4) == [None] * 4
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() == dispatches


def test_group_lane_cancelled_before_any_chunk(group_splits):
    lanes = _term_lanes(group_splits["v3"])
    dead = CancellationToken()
    dead.cancel("lane cancelled before the scan")
    results = group(lanes, 10, POSTING_PAD, cancels=[dead, None, None, None])
    assert isinstance(results[0], CancelledQuery) or results[0]["partial"]
    for i in (1, 2, 3):
        assert_lane_exact(results[i], lanes[i], 10, POSTING_PAD, f"lane {i}")


def test_group_equals_the_jax_group_scan(group_splits):
    """On inputs without signed zeros or NaN the two group scans agree."""
    lanes = _term_lanes(group_splits["v3"])
    got = group(lanes, 10, POSTING_PAD)
    want = jc.execute_group_chunked([lane.j_plan for lane in lanes], 10,
                                    [list(lane.j_plan.arrays)
                                     for lane in lanes], span=POSTING_PAD)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_result(w, g, f"lane {i}")


def test_batcher_group_runs_the_chunked_scan(group_splits):
    """A group formed in the batcher with spans set runs the group scan:
    one chunk dispatch per chunk, each rider equal to its solo run."""
    from test_torch_query_batcher import run_group

    class _Q:
        def __init__(self, lane):
            self.plan, self.arrays, self.lane = lane.plan, lane.arrays, lane

        def solo(self, k):
            return self.lane.fused(k)

    lanes = _term_lanes(group_splits["v3"])
    tc.CHUNKING.set(posting_span=POSTING_PAD)
    chunks = len(tc.chunk_spans(tc.chunk_mode(lanes[0].plan)[1],
                                POSTING_PAD, POSTING_PAD))
    dispatches = t_metrics.CHUNK_DISPATCHES_TOTAL.get()
    results = run_group(QueryBatcher(), [_Q(lane) for lane in lanes], 10)
    assert t_metrics.CHUNK_DISPATCHES_TOTAL.get() - dispatches == chunks
    for i, (got, lane) in enumerate(zip(results, lanes)):
        assert_lane_exact(got, lane, 10, POSTING_PAD, f"rider {i}")


# --- signed zeros and NaN, as a group ----------------------------------------

def _gain_window(lo, hi):
    return lambda Q: Q.Range("timestamp",
                             lower=Q.RangeBound((1_600_000_000 + lo) * 10**6,
                                                True),
                             upper=Q.RangeBound((1_600_000_000 + hi) * 10**6,
                                                False))


def _jax_exact(lane, k):
    import jax.numpy as jnp
    return j_executor.readback_plan_result(j_executor.dispatch_plan(
        lane.j_plan, k, [jnp.asarray(a) for a in lane.j_plan.arrays],
        exact=True))


def _gain_lanes(readers, windows):
    from quickwit_tpu.models import doc_mapper as jdm
    from quickwit_tpu_torch.models import doc_mapper as tdm
    from quickwit_tpu.query import ast as JQ
    from quickwit_tpu.search.plan import lower_request as j_lower
    from quickwit_tpu_torch.query import ast as TQ
    from quickwit_tpu_torch.search.plan import lower_request as t_lower
    j_reader, t_reader = readers
    lanes = []
    for lo, hi in windows:
        lane = Lane.__new__(Lane)
        build = _gain_window(lo, hi)
        lane.j_plan = j_lower(build(JQ), _zeros_mapper(jdm), j_reader, [],
                              sort_field="gain")
        lane.plan = t_lower(build(TQ), _zeros_mapper(tdm), t_reader, [],
                            sort_field="gain")
        lane.arrays = _t_arrays(lane.plan)
        lanes.append(lane)
    assert len({lane.plan.structure_digest(300) for lane in lanes}) == 1
    return lanes


def test_signed_zero_group_equals_exact_fused(zeros_split):
    """Two windows sorted by gain, top-300, three dense chunks: each lane
    ranks +0.0 above -0.0 as the fused top-k does, equal to the JAX
    package's EXACT fused top-k."""
    lanes = _gain_lanes(zeros_split, [(0, 2500), (500, 2400)])
    results = group(lanes, 300, DOC_PAD)
    for i, (got, lane) in enumerate(zip(results, lanes)):
        assert_same_result(lane.fused(300), got, f"lane {i} vs fused")
        exact = _jax_exact(lane, 300)
        np.testing.assert_array_equal(got["doc_ids"], exact["doc_ids"])
        np.testing.assert_array_equal(_bits(got["sort_values"]),
                                      _bits(exact["sort_values"]))
        zeros = got["sort_values"][got["sort_values"] == 0.0]
        signs = list(np.signbit(zeros))
        assert signs == sorted(signs) and any(signs) and not all(signs)


def test_nan_group_rebases_every_lane(nan_split):
    """NaN gains on docs 1500 and 1600 (the second dense chunk), every doc
    in the top-k: each port lane keeps both NaN hits on top under their
    GLOBAL doc ids (the dense scan rebases every lane's doc id), as the
    fused top-k does. The JAX group scan returns neither NaN hit."""
    lanes = _gain_lanes(nan_split, [(0, 2500), (1000, 2500)])
    k = 2500
    results = group(lanes, k, DOC_PAD)
    for i, (got, lane) in enumerate(zip(results, lanes)):
        assert_same_result(lane.fused(k), got, f"lane {i} vs fused")
        exact = _jax_exact(lane, k)
        np.testing.assert_array_equal(got["doc_ids"], exact["doc_ids"])
        assert list(got["doc_ids"][:2]) == [1500, 1600]
        assert np.isnan(got["sort_values"][:2]).all()
    j_results = jc.execute_group_chunked(
        [lane.j_plan for lane in lanes], k,
        [list(lane.j_plan.arrays) for lane in lanes], span=DOC_PAD)
    for got, j_got in zip(results, j_results):
        live = int(got["count"])
        assert len(set(got["doc_ids"][:live])) == live
        j_ids = list(np.asarray(j_got["doc_ids"])[:live])
        assert 1500 not in j_ids and 1600 not in j_ids
