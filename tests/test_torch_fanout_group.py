"""The port's query group over a split set (parallel/fanout.py's
`dispatch_query_group` / `readback_query_group` / `execute_query_group`,
without a mesh) against each query's solo batch, the JAX package's group
(`execute_query_group(batches, request, mesh=None)`, the case of
`tests/test_query_batching.py:602`) and the JAX solo batches.

A group is Q batches of one template signature over one split set, run
as Q x n lanes in one dispatch: each query's merged response must equal
its solo batch's bit for bit, and the JAX group's exactly (f64 sums to
rtol 1e-12). A query masked after the group formed reads back as None and
runs nothing; the fused steps of every live lane share `score_topk_lanes`
launches of at most 16 lanes.
"""

import numpy as np
import pytest

from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.parallel import fanout as j_fanout

from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability.metrics import (
    QBATCH_MASKED_RIDERS_TOTAL, QBATCH_SHARED_BYTES_AVOIDED_TOTAL,
    SEARCH_KERNEL_LAUNCHES_TOTAL,
)
from quickwit_tpu_torch.parallel import fanout as t_fanout

from test_torch_fanout import (
    SEVERITIES, J, T, _req, _spy_lanes, parallel_docs, parallel_mapper,
    write_splits,
)
from test_torch_residency import _hits, assert_same_response

T0 = 1_600_000_000


@pytest.fixture(scope="module")
def five():
    """Five splits of tests/test_parallel.py's corpus: 4 severity queries
    make 20 lanes, two lane-kernel launches."""
    return write_splits("group5", parallel_mapper,
                        {f"g{s}": parallel_docs(s) for s in range(5)})


def _sev(sev, **kw):
    return lambda P: _req(P, lambda Q: Q.Term("severity_text", sev), **kw)


def _window(i, **kw):
    lo = (T0 + 600 * i) * 10**6
    return lambda P: _req(P, lambda Q: Q.Bool(
        must=(Q.FullText("body", "alpha", "or"),),
        filter=(Q.Range("timestamp", Q.RangeBound(lo, True),
                        Q.RangeBound(lo + 40_000 * 10**6, False)),)), **kw)


AGGS = {"lat": {"stats": {"field": "latency"}},
        "sev": {"terms": {"field": "severity_text"}},
        "per_hour": {"date_histogram": {"field": "timestamp",
                                        "fixed_interval": "1h"}}}

GROUPS = {
    "score_top8": [_sev(s, max_hits=8) for s in SEVERITIES],
    "timestamp_with_aggs": [
        _sev(s, max_hits=8, aggs=AGGS, sort=[("timestamp", "desc")])
        for s in SEVERITIES[:3]],
    "windows_two_keys": [
        _window(i, max_hits=20, aggs=AGGS,
                sort=[("tenant_id", "asc"), ("timestamp", "desc")])
        for i in range(3)],
    "count_only": [_window(i, max_hits=0, aggs=AGGS) for i in range(3)],
}


def _batches(splits, pkg, fanout, builds):
    mapper = parallel_mapper(jdm if pkg is J else tdm)
    readers = splits.j if pkg is J else splits.t
    reqs = [build(pkg) for build in builds]
    return [fanout.build_batch(req, mapper, readers, splits.ids)
            for req in reqs], reqs


def run_group(splits, builds, valid=None):
    """(port group, port solo batches), each query held against the JAX
    group and the JAX solo batch."""
    j_batches, j_reqs = _batches(splits, J, j_fanout, builds)
    t_batches, t_reqs = _batches(splits, T, t_fanout, builds)
    got = t_fanout.execute_query_group(t_batches, t_reqs[0], device="cpu",
                                       valid=valid)
    want = j_fanout.execute_query_group(j_batches, j_reqs[0], mesh=None,
                                        valid=valid)
    solos = [t_fanout.execute_batch(b, t_reqs[0], device="cpu")
             for b in t_batches]
    assert len(got) == len(builds)
    for q, (g, w, solo) in enumerate(zip(got, want, solos)):
        if valid is not None and not valid[q]:
            assert g is None and w is None
            continue
        assert_same_response(g, solo)
        assert_same_response(g, w)
        assert_same_response(g, j_fanout.execute_batch(
            j_batches[q], j_reqs[0], mesh=None))
    return got, t_batches, t_reqs


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_matches_solo_batches_and_jax(five, name):
    got, _, _ = run_group(five, GROUPS[name])
    assert any(r.num_hits > 0 for r in got)


def test_group_fused_steps_share_lane_launches(five, monkeypatch):
    """4 queries x 5 splits = 20 fused lanes: two lane-kernel calls (16 +
    4, the plain version on the CPU), one dispatch."""
    _, t_batches, t_reqs = run_group(five, GROUPS["score_top8"])
    calls = _spy_lanes(monkeypatch)
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    t_fanout.execute_query_group(t_batches, t_reqs[0], device="cpu")
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 1
    assert [len(lengths) for lengths, _ in calls] == [16, 4]
    assert {k for _, k in calls} == {8}


@pytest.mark.parametrize("valid", [[True, False, True],
                                   [False, True, True]],
                         ids=["middle", "first"])
def test_group_masked_queries(five, valid):
    masked = QBATCH_MASKED_RIDERS_TOTAL.get()
    got, _, _ = run_group(five, GROUPS["timestamp_with_aggs"], valid=valid)
    assert [r is None for r in got] == [not v for v in valid]
    assert QBATCH_MASKED_RIDERS_TOTAL.get() - masked == 1


def test_group_serves_column_slots_from_query_zero(five):
    """Column-family slots of equal keys come from query 0's staged
    tensors: the other queries stage only their own slots."""
    avoided = QBATCH_SHARED_BYTES_AVOIDED_TOTAL.get()
    run_group(five, GROUPS["windows_two_keys"])
    assert QBATCH_SHARED_BYTES_AVOIDED_TOTAL.get() - avoided > 0


def test_group_rejects_other_split_sets_and_structures(five):
    builds = GROUPS["score_top8"][:2]
    for pkg, fanout in ((J, j_fanout), (T, t_fanout)):
        mapper = parallel_mapper(jdm if pkg is J else tdm)
        readers = five.j if pkg is J else five.t
        reqs = [build(pkg) for build in builds]
        whole = fanout.build_batch(reqs[0], mapper, readers, five.ids)
        part = fanout.build_batch(reqs[1], mapper, readers[:4],
                                  five.ids[:4])
        other = fanout.build_batch(GROUPS["timestamp_with_aggs"][0](pkg),
                                   mapper, readers, five.ids)
        kw = {"mesh": None} if pkg is J else {"device": "cpu"}
        with pytest.raises(ValueError, match="different split sets"):
            fanout.execute_query_group([whole, part], reqs[0], **kw)
        with pytest.raises(ValueError, match="not shape-compatible"):
            fanout.execute_query_group([whole, other], reqs[0], **kw)


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_cache_key_mirrors_jax(five, name):
    j_batches, _ = _batches(five, J, j_fanout, GROUPS[name])
    t_batches, _ = _batches(five, T, t_fanout, GROUPS[name])
    assert t_fanout.group_slot_split(t_batches) == \
        j_fanout.group_slot_split(j_batches)
    for k in (0, 8, 10**9):
        assert t_fanout.group_cache_key(t_batches, k) == \
            j_fanout.group_cache_key(j_batches, k, None)


def test_group_readback_is_one_copy_of_q_rows(five):
    """The dispatch holds one [Q, W] host buffer; masked rows stay 0."""
    t_batches, t_reqs = _batches(five, T, t_fanout,
                                 GROUPS["timestamp_with_aggs"])
    dispatched = t_fanout.dispatch_query_group(
        t_batches, t_reqs[0], device="cpu", valid=[True, False, True])
    rows = dispatched.host.numpy()
    assert rows.shape[0] == 3 and not rows[1].any()
    out = t_fanout.readback_query_group(dispatched)
    assert out[1] is None
    assert _hits(out[0]) == _hits(t_fanout.execute_batch(
        t_batches[0], t_reqs[0], device="cpu"))
    assert np.isfinite(rows[0]).any()
