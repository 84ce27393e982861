"""The port's query group over a device mesh (parallel/fanout.py's
`execute_query_group(..., mesh=)` / `group_mesh_fn`) against each query's
solo batch and the JAX package's group on its mesh, the cases of
`tests/test_query_batching.py:580-660`.

The query axis stays lanes, not a mesh axis: each mesh row's fused steps
cover its splits of every live query, one threshold exchange carries all
Q queries, and each query keeps its own gather and reduce. The port's
mesh is a grid of one CPU device repeated; the JAX group runs on the
forced host devices. Latencies are integral, so aggregation states are
compared exactly.
"""

import numpy as np
import pytest
import torch

from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.observability import metrics as j_metrics
from quickwit_tpu.parallel import fanout as j_fanout

from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability import metrics as t_metrics
from quickwit_tpu_torch.parallel import fanout as t_fanout
from quickwit_tpu_torch.parallel import mesh as t_mesh

import test_query_batching as qb
from test_torch_fanout import J, T, _spy_lanes, write_splits
from test_torch_mesh import assert_identical

CPU = torch.device("cpu")


def qb_mapper(dm):
    """tests/test_query_batching.py's mapping."""
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("sev", dm.FieldType.TEXT, tokenizer="raw",
                            fast=True),
            dm.FieldMapping("tenant", dm.FieldType.U64, fast=True),
            dm.FieldMapping("lat", dm.FieldType.F64, fast=True),
            dm.FieldMapping("body", dm.FieldType.TEXT),
        ],
        timestamp_field="ts", default_search_fields=("body",))


@pytest.fixture(scope="module")
def two_splits():
    return write_splits("meshgroup", qb_mapper, {
        "m1": list(qb._docs(220, 3)), "m2": list(qb._docs(220, 7))})


def _reqs(P, **kw):
    return [P.M.SearchRequest(index_ids=["t"], query_ast=P.Q.Term("sev", s),
                              **kw) for s in qb.SEVS]


def _batches(splits, reqs, fanout, dm, readers):
    return [fanout.build_batch(r, qb_mapper(dm), readers, list(splits.ids))
            for r in reqs]


def t_batches(splits, reqs):
    return _batches(splits, reqs, t_fanout, tdm, splits.t)


def j_batches(splits, reqs):
    return _batches(splits, reqs, j_fanout, jdm, splits.j)


def t_mesh_of(a, d):
    """The port's counterpart of the JAX (a, d) mesh: its a rows."""
    return t_mesh.make_mesh(a, devices=[CPU] * 8)


def _solos(splits, reqs):
    return [t_fanout.execute_batch(b, r, device="cpu")
            for b, r in zip(t_batches(splits, reqs), reqs)]


def test_query_group_no_mesh_matches_solo_batches(two_splits):
    reqs, j_reqs = _reqs(T, max_hits=8), _reqs(J, max_hits=8)
    group = t_fanout.execute_query_group(t_batches(two_splits, reqs),
                                         reqs[0], device="cpu")
    j_group = j_fanout.execute_query_group(j_batches(two_splits, j_reqs),
                                           j_reqs[0])
    assert len(group) == 3
    for got, want, jax_want in zip(group, _solos(two_splits, reqs), j_group):
        assert_identical(got, want)
        assert_identical(got, jax_want)


def test_query_group_mesh_matches_solo(two_splits):
    aggs = {"lat_stats": {"stats": {"field": "lat"}},
            "sevs": {"terms": {"field": "sev"}}}
    kw = dict(max_hits=8, aggs=aggs)
    reqs = _reqs(T, sort_fields=[T.M.SortField("ts", "desc")], **kw)
    j_reqs = _reqs(J, sort_fields=[J.M.SortField("ts", "desc")], **kw)
    mesh = t_mesh_of(2, 2)
    batches = t_batches(two_splits, reqs)
    group = t_fanout.execute_query_group(batches, reqs[0], mesh=mesh)
    j_group = j_fanout.execute_query_group(
        j_batches(two_splits, j_reqs), j_reqs[0],
        mesh=j_fanout.make_mesh(2, 2))
    for got, want, jax_want in zip(group, _solos(two_splits, reqs), j_group):
        assert_identical(got, want)
        assert_identical(got, jax_want)
    key = t_fanout.group_cache_key(batches, 8, mesh=mesh)
    j_key = j_fanout.group_cache_key(j_batches(two_splits, j_reqs), 8,
                                     mesh=j_fanout.make_mesh(2, 2))
    assert key[:5] + key[6:] == j_key[:5] + j_key[6:]
    assert key[5] == mesh
    assert key[5].shape["splits"] == j_key[5].shape["splits"]


def test_query_group_mesh_masks_lanes(two_splits):
    reqs, j_reqs = _reqs(T, max_hits=8), _reqs(J, max_hits=8)
    masked0 = t_metrics.QBATCH_MASKED_RIDERS_TOTAL.get()
    group = t_fanout.execute_query_group(
        t_batches(two_splits, reqs), reqs[0], mesh=t_mesh_of(2, 1),
        valid=[True, False, True])
    assert group[1] is None
    assert t_metrics.QBATCH_MASKED_RIDERS_TOTAL.get() - masked0 == 1
    j_group = j_fanout.execute_query_group(
        j_batches(two_splits, j_reqs), j_reqs[0],
        mesh=j_fanout.make_mesh(2, 1), valid=[True, False, True])
    solos = _solos(two_splits, reqs)
    for q in (0, 2):
        assert_identical(group[q], solos[q])
        assert_identical(group[q], j_group[q])


def test_query_group_mesh_validity_is_operand_not_key(two_splits):
    """Masking a query builds no new lane program and keeps the group's
    key: the validity mask is an operand, as in the JAX group."""
    reqs = _reqs(T, max_hits=6)
    mesh = t_mesh_of(2, 1)
    batches = t_batches(two_splits, reqs)
    t_fanout.execute_query_group(batches, reqs[0], mesh=mesh)
    programs = sum(len(v) for v in t_fanout._LANE_PROGRAMS.values())
    key = t_fanout.group_cache_key(batches, 6, mesh=mesh)
    again = t_batches(two_splits, reqs)
    out = t_fanout.execute_query_group(again, reqs[0], mesh=mesh,
                                       valid=[False, True, True])
    assert out[0] is None and out[1] is not None
    assert sum(len(v) for v in t_fanout._LANE_PROGRAMS.values()) == programs
    assert t_fanout.group_cache_key(again, 6, mesh=mesh) == key


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_scored_group_launches_per_row_and_metrics(two_splits, monkeypatch,
                                                   shape):
    """A scored group on the mesh of the JAX (2, d) mesh's rows: each
    row's one `score_topk_lanes` call covers its split of all three
    queries; one mesh dispatch, as the JAX group's. The JAX group also
    runs one exchange round for all lanes and counts its docs axis; the
    port runs no exchange and counts its two rows."""
    reqs = [T.M.SearchRequest(index_ids=["t"],
                              query_ast=T.Q.FullText("body", b, "or"),
                              max_hits=5) for b in ("m0", "m1", "m2")]
    j_reqs = [J.M.SearchRequest(index_ids=["t"],
                                query_ast=J.Q.FullText("body", b, "or"),
                                max_hits=5) for b in ("m0", "m1", "m2")]
    names = ("MESH_DISPATCHES_TOTAL", "MESH_THRESHOLD_EXCHANGE_ROUNDS_TOTAL",
             "MESH_COLLECTIVE_BYTES_TOTAL")

    def deltas(metrics, run):
        before = [getattr(metrics, n).get() for n in names]
        out = run()
        return out, [getattr(metrics, n).get() - b
                     for n, b in zip(names, before)] \
            + [metrics.MESH_DEVICES.get()]

    calls = _spy_lanes(monkeypatch)
    group, got = deltas(t_metrics, lambda: t_fanout.execute_query_group(
        t_batches(two_splits, reqs), reqs[0], mesh=t_mesh_of(*shape)))
    assert [len(lanes) for lanes, _k in calls] == [3, 3]
    j_group, want = deltas(j_metrics, lambda: j_fanout.execute_query_group(
        j_batches(two_splits, j_reqs), j_reqs[0],
        mesh=j_fanout.make_mesh(*shape)))
    assert want == [1, 1, 0, shape[0] * shape[1]]
    assert got == [1, 0, 0, shape[0]]
    for got_q, solo, jax_q in zip(group, _solos(two_splits, reqs), j_group):
        assert_identical(got_q, solo)
        assert [h.doc_id for h in got_q.partial_hits] == \
            [h.doc_id for h in jax_q.partial_hits]
        assert np.array_equal([h.sort_value for h in got_q.partial_hits],
                              [h.sort_value for h in jax_q.partial_hits])
