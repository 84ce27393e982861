"""The port's device mesh (quickwit_tpu_torch/parallel/mesh.py and the
mesh route of parallel/fanout.py) against the JAX package's on-mesh root
merge (`execute_batch(..., mesh=make_mesh(*shape))` over the forced host
devices of tests/conftest.py), the cases of tests/test_mesh_root_merge.py.

The port's mesh runs on a grid of one CPU device repeated, the
counterpart of the forced host devices. Its mesh has only the split axis:
a JAX shape (a, d) is the port's mesh of a rows. Both packages read the
same split bytes (the JAX writer on its Python path). A mesh response
must equal the JAX mesh's bit for bit (hits with the bits of their sort
values, counts, every intermediate aggregation state with its dtype: the
fixture latencies are integral, so sums are exact under any association)
and the port's own single-device batch. The `qw_mesh_*` metric deltas
must equal the JAX package's, less what the port does not run: the
docs axis and the threshold exchange.

Where the JAX mesh answers unlike its own host merge (NaN sort values,
ROADMAP §3), the port's mesh still answers as the port's batch does; the
pins below assert both.
"""

import threading

import numpy as np
import pytest
import torch

from quickwit_tpu.observability import metrics as j_metrics
from quickwit_tpu.parallel import fanout as j_fanout

from quickwit_tpu_torch.index.format import DOC_PAD
from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability import metrics as t_metrics
from quickwit_tpu_torch.parallel import fanout as t_fanout
from quickwit_tpu_torch.parallel import mesh as t_mesh
from quickwit_tpu_torch.search import chunkexec as tc
from quickwit_tpu_torch.search import models as t_models
from quickwit_tpu_torch.search.admission import HbmBudget
from quickwit_tpu_torch.search.collector import IncrementalCollector
from quickwit_tpu_torch.search.leaf import leaf_search_single_split
from quickwit_tpu_torch.search.residency import (
    RESIDENT_COLUMN_MISSES, ResidentColumnStore,
)

import test_mesh_root_merge as jm
from test_torch_fanout import (  # noqa: F401 - fixtures
    J, T, _by_gain, _gain_mapper, _gamma, parallel_mapper,
    uneven, write_splits, zeros,
)

CPU = torch.device("cpu")
MESH_SHAPES = jm.MESH_SHAPES
SHAPE_IDS = [f"{a}x{d}" for a, d in MESH_SHAPES]


def t_mesh_of(shape):
    """The port's counterpart of the JAX mesh of `shape`: its split axis."""
    return t_mesh.make_mesh(shape[0], devices=[CPU] * 8)


def j_mesh_of(shape):
    return j_fanout.make_mesh(*shape)


def t_req(j_req):
    return t_models.SearchRequest.from_dict(j_req.to_dict())


def _fbits(value):
    if isinstance(value, float):
        return ("f", int(np.float64(value).view(np.int64)))
    return value


def bit_rows(resp):
    return [(h.split_id, h.doc_id, _fbits(h.sort_value),
             _fbits(h.sort_value2), _fbits(h.raw_sort_value),
             _fbits(h.raw_sort_value2)) for h in resp.partial_hits]


def assert_states_identical(want, got, path="aggs"):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for key in want:
            assert_states_identical(want[key], got[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_states_identical(w, g, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        w, g = np.asarray(want), np.asarray(got)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), path
        assert w.tobytes() == g.tobytes(), f"{path}: {w} vs {g}"
    else:
        assert want == got, path


def assert_identical(got, want):
    assert got.num_hits == want.num_hits
    assert bit_rows(got) == bit_rows(want)
    assert_states_identical(want.intermediate_aggs, got.intermediate_aggs)
    assert (got.num_attempted_splits, got.num_successful_splits) == \
        (want.num_attempted_splits, want.num_successful_splits)


@pytest.fixture(scope="module")
def mesh_splits():
    """The 8 splits of tests/test_mesh_root_merge.py (integral latencies)."""
    return write_splits("meshmerge", parallel_mapper,
                        {f"split-{s}": jm._docs(s) for s in range(8)})


def t_batch(splits, req, ids=None, pad_to=None, mapper=parallel_mapper):
    idx = [splits.ids.index(i) for i in (ids or splits.ids)]
    return t_fanout.build_batch(req, mapper(tdm), [splits.t[i] for i in idx],
                                [splits.ids[i] for i in idx],
                                pad_to_splits=pad_to)


def j_batch(splits, req, ids=None, pad_to=None, mapper=parallel_mapper):
    from quickwit_tpu.models import doc_mapper as jdm
    idx = [splits.ids.index(i) for i in (ids or splits.ids)]
    return j_fanout.build_batch(req, mapper(jdm), [splits.j[i] for i in idx],
                                [splits.ids[i] for i in idx],
                                pad_to_splits=pad_to)


def run_all(splits, j_request, shape, ids=None, pad_to=None,
            mapper=parallel_mapper, exact=False):
    """(port mesh, port batch, JAX mesh, JAX host merge)."""
    request = t_req(j_request)
    mesh = t_fanout.execute_batch(t_batch(splits, request, ids, pad_to,
                                          mapper), request,
                                  mesh=t_mesh_of(shape))
    batch = t_fanout.execute_batch(t_batch(splits, request, ids, pad_to,
                                           mapper), request, device="cpu")
    j_mesh = j_fanout.execute_batch(
        j_batch(splits, j_request, ids, pad_to, mapper), j_request,
        mesh=j_mesh_of(shape), exact=exact)
    j_host = j_fanout.execute_batch(
        j_batch(splits, j_request, ids, pad_to, mapper), j_request,
        exact=exact)
    return mesh, batch, j_mesh, j_host


# --- the equivalence suite ---------------------------------------------------

@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("req_idx", range(len(jm.REQUESTS)))
def test_mesh_matches_jax_mesh_and_port_batch(mesh_splits, shape, req_idx):
    mesh, batch, j_mesh, _ = run_all(mesh_splits, jm.REQUESTS[req_idx],
                                     shape)
    assert_identical(mesh, j_mesh)
    assert_identical(mesh, batch)


def test_mesh_matches_sequential_collector_merge(mesh_splits):
    """Transitively: mesh ≡ the port's per-split leaf searches merged by
    its collector (the reference's merge-tree order)."""
    request = t_req(jm.REQUESTS[1])
    coll = IncrementalCollector(max_hits=request.max_hits)
    for split_id, reader in zip(mesh_splits.ids, mesh_splits.t):
        coll.add_leaf_response(leaf_search_single_split(
            request, parallel_mapper(tdm), reader, split_id, device="cpu"))
    mesh = t_fanout.execute_batch(t_batch(mesh_splits, request), request,
                                  mesh=t_mesh_of((4, 2)))
    assert mesh.num_hits == coll.num_hits
    assert [(h.split_id, h.doc_id) for h in mesh.partial_hits] == \
        [(h.split_id, h.doc_id) for h in coll.partial_hits()]


def test_all_ties_truncation(mesh_splits):
    j_request = J.M.SearchRequest(
        index_ids=["x"], query_ast=J.Q.Term("severity_text", "WARN"),
        max_hits=7, sort_fields=(J.M.SortField("tenant_id", "asc"),))
    for shape in MESH_SHAPES:
        mesh, batch, j_mesh, _ = run_all(mesh_splits, j_request, shape)
        assert_identical(mesh, j_mesh)
        assert_identical(mesh, batch)
    vals = [h.sort_value for h in batch.partial_hits]
    assert len(set(vals)) < len(vals)


def test_nondivisible_mesh_takes_single_device_path(mesh_splits):
    """3 splits over a 2-way split axis: the single-device route (no mesh
    dispatch), as the JAX routing rule has it."""
    ids = mesh_splits.ids[:3]
    t_before = t_metrics.MESH_DISPATCHES_TOTAL.get()
    j_before = j_metrics.MESH_DISPATCHES_TOTAL.get()
    mesh, batch, j_mesh, _ = run_all(mesh_splits, jm.REQUESTS[0], (2, 1),
                                     ids=ids)
    assert t_metrics.MESH_DISPATCHES_TOTAL.get() == t_before
    assert j_metrics.MESH_DISPATCHES_TOTAL.get() == j_before
    assert_identical(mesh, j_mesh)
    assert_identical(mesh, batch)


def test_padded_batch_on_mesh(mesh_splits):
    """A pad split (id "") runs nothing and offers nothing through the
    collective merge: the (4, 1) mesh's last row holds only the pad."""
    ids = mesh_splits.ids[:3]
    mesh, batch, j_mesh, _ = run_all(mesh_splits, jm.REQUESTS[0], (4, 1),
                                     ids=ids, pad_to=4)
    assert_identical(mesh, j_mesh)
    assert_identical(mesh, batch)
    assert all(h.split_id for h in mesh.partial_hits)


@pytest.mark.parametrize("env", [
    pytest.param(None, id="v3"),
    pytest.param({"QW_DISABLE_IMPACT": "1"}, id="v2-doc-ordered"),
    pytest.param({"QW_DISABLE_PACKED": "1"}, id="v1-unpacked"),
])
def test_mesh_across_split_formats(env):
    tag = "-".join(sorted(env)) if env else "v3"
    splits = write_splits(f"meshfmt-{tag}", parallel_mapper,
                          {f"s{i}": jm._docs(i, 120) for i in range(4)},
                          env=env)
    for j_request in (jm.REQUESTS[0], jm.REQUESTS[1], jm.REQUESTS[4]):
        mesh, batch, j_mesh, _ = run_all(splits, j_request, (4, 2))
        assert_identical(mesh, j_mesh)
        assert_identical(mesh, batch)


def test_chunked_per_split_equals_fused_mesh(monkeypatch):
    """The port's chunked per-split scans merged by its collector equal
    the fused mesh: resumable slabs and one whole-query dispatch agree."""
    monkeypatch.setattr(tc, "CHUNKING", tc.ChunkConfig())
    monkeypatch.setattr(tc, "CHUNK_SIZER", tc._ChunkSizer())
    splits = write_splits("meshchunk", parallel_mapper,
                          {f"big-{i}": jm._docs(i, DOC_PAD + 90)
                           for i in range(2)})
    request = T.M.SearchRequest(
        index_ids=["x"], query_ast=T.Q.Term("severity_text", "ERROR"),
        max_hits=10, sort_fields=(T.M.SortField("timestamp", "desc"),))
    tc.CHUNKING.set(doc_span=DOC_PAD)
    coll = IncrementalCollector(max_hits=request.max_hits)
    for split_id, reader in zip(splits.ids, splits.t):
        coll.add_leaf_response(leaf_search_single_split(
            request, parallel_mapper(tdm), reader, split_id, device="cpu"))
    tc.CHUNKING.set(doc_span=None)
    mesh = t_fanout.execute_batch(t_batch(splits, request), request,
                                  mesh=t_mesh_of((2, 1)))
    assert mesh.num_hits == coll.num_hits
    assert [(h.split_id, h.doc_id) for h in mesh.partial_hits] == \
        [(h.split_id, h.doc_id) for h in coll.partial_hits()]


def test_property_seeded_equivalence(mesh_splits):
    """The JAX suite's seeded sweep: random sorts, filters, aggs and k on
    a (4, 2) mesh, each draw bit-identical to the JAX mesh and the port's
    batch."""
    rng = np.random.RandomState(1234)
    sortable = ["timestamp", "tenant_id", "latency"]
    Q = J.Q
    queries = [Q.MatchAll(), Q.FullText("body", "beta", "or"),
               Q.Term("severity_text", "INFO"),
               Q.Bool(must=(Q.MatchAll(),),
                      filter=(Q.Range("tenant_id", Q.RangeBound(0, True),
                                      Q.RangeBound(2, False)),))]
    for _ in range(6):
        q = queries[int(rng.randint(0, len(queries)))]
        k = int(rng.randint(0, 16))
        n_sort = int(rng.randint(0, 3))
        fields = list(rng.choice(sortable, size=n_sort, replace=False))
        sorts = tuple(J.M.SortField(f, ["asc", "desc"][int(rng.randint(0, 2))])
                      for f in fields)
        aggs = None
        if k == 0 or rng.randint(0, 2):
            aggs = {"sev": {"terms": {"field": "severity_text"}},
                    "lat": {"stats": {"field": "latency"}}}
        j_request = J.M.SearchRequest(index_ids=["x"], query_ast=q,
                                      max_hits=k, sort_fields=sorts,
                                      aggs=aggs)
        mesh, batch, j_mesh, _ = run_all(mesh_splits, j_request, (4, 2))
        assert_identical(mesh, j_mesh)
        assert_identical(mesh, batch)


# --- accounting: bytes and metrics -------------------------------------------

@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("req_idx", [0, 3, 4])
def test_mesh_stages_per_device_bytes(mesh_splits, shape, req_idx):
    """A cold mesh batch stages each split's arrays once, on its row's
    device: `per_device_bytes` in all, and a repeat stages nothing."""
    request = t_req(jm.REQUESTS[req_idx])
    batch = t_batch(mesh_splits, request)
    mesh = t_mesh_of(shape)
    before = t_metrics.STAGING_BYTES_TOTAL.get()
    lanes = t_fanout.stage_device_inputs(batch, mesh=mesh)
    assert t_metrics.STAGING_BYTES_TOTAL.get() - before == \
        t_fanout.per_device_bytes(batch) > 0
    assert len(lanes) == 8
    again = t_metrics.STAGING_BYTES_TOTAL.get()
    assert t_fanout.stage_device_inputs(batch, mesh=mesh) is lanes
    assert t_metrics.STAGING_BYTES_TOTAL.get() == again


MESH_METRICS = ("MESH_DISPATCHES_TOTAL", "MESH_COLLECTIVE_BYTES_TOTAL",
                "MESH_THRESHOLD_EXCHANGE_ROUNDS_TOTAL")


def _deltas(metrics, run):
    before = [getattr(metrics, name).get() for name in MESH_METRICS]
    run()
    return [getattr(metrics, name).get() - b
            for name, b in zip(MESH_METRICS, before)] \
        + [metrics.MESH_DEVICES.get()]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("req_idx", range(len(jm.REQUESTS)))
def test_mesh_metric_deltas_match_jax(mesh_splits, shape, req_idx):
    """One dispatch each. The collective bytes are the JAX program's less
    its 8-byte threshold exchange (a scored request's only); the port
    runs no exchange round, and its mesh counts only its split axis."""
    j_request = jm.REQUESTS[req_idx]
    request = t_req(j_request)
    got = _deltas(t_metrics, lambda: t_fanout.execute_batch(
        t_batch(mesh_splits, request), request, mesh=t_mesh_of(shape)))
    want = _deltas(j_metrics, lambda: j_fanout.execute_batch(
        j_batch(mesh_splits, j_request), j_request, mesh=j_mesh_of(shape)))
    scored = int(request.max_hits > 0)
    assert want[0] == got[0] == 1
    assert got[1] == want[1] - 8 * scored > 0
    assert (want[2], got[2]) == (scored, 0)
    assert (want[3], got[3]) == (shape[0] * shape[1], shape[0])


def test_warm_stack_zero_column_upload(mesh_splits):
    """A second query over the same split set on the same mesh serves
    every column from residency: no column is uploaded to any device.
    On a grid that repeats the store's device the mesh keeps its lanes
    under each split's own resident owner (the per-split route's copy),
    so the full-hit counter moves once per split."""
    store = ResidentColumnStore()
    budget = HbmBudget()
    mesh = t_mesh_of((4, 1))
    request = T.M.SearchRequest(
        index_ids=["x"], query_ast=T.Q.MatchAll(), max_hits=6,
        sort_fields=(T.M.SortField("latency", "asc"),))

    def run_once():
        batch = t_batch(mesh_splits, request)
        t_fanout.stage_device_inputs(batch, "cpu", budget=budget,
                                     store=store, mesh=mesh)
        resp = t_fanout.execute_batch(batch, request, device="cpu",
                                      mesh=mesh)
        t_fanout.release_stack_pin(batch, budget)
        return resp

    cold = run_once()
    misses = RESIDENT_COLUMN_MISSES.get()
    full = t_metrics.RESIDENT_STAGING_CACHE_HITS.get()
    warm = run_once()
    assert RESIDENT_COLUMN_MISSES.get() == misses
    assert t_metrics.RESIDENT_STAGING_CACHE_HITS.get() == full + 8
    assert_identical(warm, cold)
    stats = store.stats()
    assert sorted(stats["by_split"]) == mesh_splits.ids
    assert stats["bytes"] == sum(stats["by_split"].values()) > 0


def test_mesh_on_other_devices_keys_copies_by_stack_id(mesh_splits):
    """Rows on a device other than the store's keep their resident copies
    under the mesh's stack id, never under the split id the per-split
    route uses; a warm repeat uploads nothing. (`cpu:0` names a device
    other than the context's `cpu`, the way a second card would.)"""
    store = ResidentColumnStore()
    budget = HbmBudget()
    other = t_mesh.make_mesh(2, devices=[torch.device("cpu", 0)] * 2)
    request = t_req(jm.REQUESTS[3])
    ids = mesh_splits.ids[:4]

    def run_once():
        batch = t_batch(mesh_splits, request, ids)
        t_fanout.stage_device_inputs(batch, "cpu", budget=budget,
                                     store=store, mesh=other)
        resp = t_fanout.execute_batch(batch, request, device="cpu",
                                      mesh=other)
        t_fanout.release_stack_pin(batch, budget)
        return resp

    cold = run_once()
    misses = RESIDENT_COLUMN_MISSES.get()
    warm = run_once()
    assert RESIDENT_COLUMN_MISSES.get() == misses
    assert_identical(warm, cold)
    stack_id = t_fanout.mesh_stack_id(ids, cold_padded(mesh_splits, request,
                                                       ids), other)
    assert sorted(store.stats()["by_split"]) == \
        sorted(f"{stack_id}/{s}" for s in ids)
    assert_identical(cold, t_fanout.execute_batch(
        t_batch(mesh_splits, request, ids), request, device="cpu"))


def cold_padded(splits, request, ids):
    return t_batch(splits, request, ids).num_docs_padded


def test_mesh_stack_id_matches_jax(mesh_splits):
    """The JAX identity and digest, over a one-axis JAX mesh of as many
    devices (the port's mesh has only the split axis)."""
    import jax
    from jax.sharding import Mesh as JMesh

    from quickwit_tpu.search.residency import mesh_stack_id as j_stack_id
    for rows in (2, 4, 8):
        j_mesh = JMesh(np.array(jax.devices()[:rows]), ("splits",))
        assert t_fanout.mesh_stack_id(mesh_splits.ids, 2048,
                                      t_mesh_of((rows, 1))) == \
            j_stack_id(mesh_splits.ids, 2048, j_mesh)
    assert t_fanout.mesh_stack_id(mesh_splits.ids, 2048,
                                  t_mesh_of((2, 1))) != \
        t_fanout.mesh_stack_id(mesh_splits.ids, 2048, t_mesh_of((4, 1)))


@pytest.mark.parametrize("budget_bytes", ["between", "total"])
def test_budget_holds_every_row_device(mesh_splits, budget_bytes):
    """Rows on two devices (`cpu` and `cpu:0`) admit into the context's
    one budget. A cold batch whose new bytes fit each device's share but
    not their total raises at once (the service then searches it per
    split) instead of waiting on its own pins; at the total it stages."""
    request = t_req(jm.REQUESTS[3])
    ids = mesh_splits.ids[:4]
    mesh = t_mesh.make_mesh(2, devices=[CPU, torch.device("cpu", 0)])
    need = t_fanout.per_device_bytes(t_batch(mesh_splits, request, ids))
    rows = [t_fanout.per_device_bytes(t_batch(mesh_splits, request, part))
            for part in (ids[:2], ids[2:])]
    assert max(rows) < need == sum(rows)
    budget = HbmBudget(budget_bytes=(max(rows) + need) // 2
                       if budget_bytes == "between" else need)
    store = ResidentColumnStore()
    batch = t_batch(mesh_splits, request, ids)
    if budget_bytes == "between":
        with pytest.raises(ValueError, match="budget"):
            t_fanout.stage_device_inputs(batch, "cpu", budget=budget,
                                         store=store, mesh=mesh)
        assert budget.stats()["pinned"] == 0
        return
    t_fanout.stage_device_inputs(batch, "cpu", budget=budget, store=store,
                                 mesh=mesh)
    assert_identical(t_fanout.execute_batch(batch, request, device="cpu",
                                            mesh=mesh),
                     t_fanout.execute_batch(t_batch(mesh_splits, request,
                                                    ids), request,
                                            device="cpu"))
    t_fanout.release_stack_pin(batch, budget)


def test_abandoned_dispatch_leaves_next_free(mesh_splits):
    """The port's mesh dispatch holds no guard: after an abandoned one, 8
    threads each run a mesh dispatch to the end, with the same answer."""
    request = t_req(jm.REQUESTS[0])
    mesh = t_mesh_of((4, 1))
    want = t_fanout.execute_batch(t_batch(mesh_splits, request), request,
                                  device="cpu")
    t_fanout.abandon_dispatch(t_fanout.dispatch_batch(
        t_batch(mesh_splits, request), request, mesh=mesh))
    done, errors = [], []

    def next_query():
        try:
            done.append(t_fanout.execute_batch(
                t_batch(mesh_splits, request), request, mesh=mesh))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=next_query) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(done) == 8
    for got in done:
        assert_identical(got, want)


# --- reference faults, pinned ------------------------------------------------

@pytest.fixture(scope="module")
def nan_splits():
    """Four splits; split-1 holds 12 NaN latencies."""
    docs = {f"split-{s}": jm._docs(s, 60) for s in range(4)}
    for i in range(12):
        docs["split-1"][i * 5]["latency"] = float("nan")
    return write_splits("meshnan", parallel_mapper, docs)


def test_nan_threshold_exchange(nan_splits):
    """Sorted by latency desc with k = 5. The JAX host merge ranks
    split-1's NaN hits first (as `lax.top_k` does); the JAX mesh's `>=`
    threshold mask drops them and answers five finite hits (ROADMAP §3).
    The port's mesh runs no threshold exchange and answers as the port's
    batch, which equals the JAX host merge."""
    j_request = J.M.SearchRequest(
        index_ids=["x"], query_ast=J.Q.MatchAll(), max_hits=5,
        sort_fields=(J.M.SortField("latency", "desc"),))
    mesh, batch, j_mesh, j_host = run_all(nan_splits, j_request, (4, 1),
                                          exact=True)
    assert_identical(mesh, batch)
    assert bit_rows(batch) == bit_rows(j_host)
    assert [h.split_id for h in batch.partial_hits] == ["split-1"] * 5
    assert all(np.isnan(h.sort_value) for h in batch.partial_hits)
    # the reference fault
    assert not any(np.isnan(h.sort_value) for h in j_mesh.partial_hits)
    assert "split-1" not in {h.split_id for h in j_mesh.partial_hits}


@pytest.mark.parametrize("order", ["desc", "asc"])
def test_nan_second_key_and_ascending(nan_splits, order):
    """NaN on either key of a two-key sort, and an ascending NaN sort: the
    port's mesh equals the port's batch."""
    for sorts in ((("latency", order),),
                  (("tenant_id", "asc"), ("latency", order)),
                  (("latency", order), ("timestamp", "desc"))):
        request = T.M.SearchRequest(
            index_ids=["x"], query_ast=T.Q.MatchAll(), max_hits=9,
            sort_fields=tuple(T.M.SortField(*s) for s in sorts))
        for shape in ((2, 1), (4, 1)):
            assert_identical(
                t_fanout.execute_batch(t_batch(nan_splits, request),
                                       request, mesh=t_mesh_of(shape)),
                t_fanout.execute_batch(t_batch(nan_splits, request),
                                       request, device="cpu"))


def test_signed_zeros_across_shards(zeros):
    """+0.0 in shard b, -0.0 in shard a, the cut among a's -0.0 docs: the
    port's mesh equals its batch bit for bit. The JAX mesh equals the JAX
    EXACT host merge here (its `>=` keeps both zeros)."""
    build = _by_gain(lambda Q: Q.MatchAll(), 100)
    j_request, request = build(J), build(T)
    mesh = t_fanout.execute_batch(
        t_batch(zeros, request, mapper=_gain_mapper), request,
        mesh=t_mesh_of((2, 1)))
    batch = t_fanout.execute_batch(
        t_batch(zeros, request, mapper=_gain_mapper), request, device="cpu")
    j_mesh = j_fanout.execute_batch(
        j_batch(zeros, j_request, mapper=_gain_mapper), j_request,
        mesh=j_mesh_of((2, 1)), exact=True)
    j_host = j_fanout.execute_batch(
        j_batch(zeros, j_request, mapper=_gain_mapper), j_request,
        exact=True)
    assert_identical(mesh, batch)
    assert bit_rows(mesh) == bit_rows(j_host)
    assert bit_rows(j_mesh) == bit_rows(j_host)
    zero_hits = [h for h in mesh.partial_hits if h.sort_value == 0.0]
    assert [np.signbit(h.sort_value) for h in zero_hits][:21] == \
        [False] * 20 + [True]


def test_k_past_every_posting_list(uneven):
    """k = 600 exceeds every posting list: the port's mesh attributes each
    hit to its split, as the port's batch does; the JAX mesh divides
    merge positions by k (`pos // k`, the same fault as its host merge)."""
    j_request, request = _gamma(600)(J), _gamma(600)(T)
    mesh = t_fanout.execute_batch(t_batch(uneven, request), request,
                                  mesh=t_mesh_of((2, 1)))
    batch = t_fanout.execute_batch(t_batch(uneven, request), request,
                                   device="cpu")
    assert_identical(mesh, batch)
    j_mesh = j_fanout.execute_batch(j_batch(uneven, j_request), j_request,
                                    mesh=j_mesh_of((2, 1)))
    assert j_mesh.num_hits == mesh.num_hits == 490
    assert [h.split_id for h in j_mesh.partial_hits] != \
        [h.split_id for h in mesh.partial_hits]


def test_ascending_key_negation_flips_nan_sign():
    """An ascending sort negates its keys by flipping the sign bit, as the
    JAX CPU program's negation does, NaN included: a CUDA negation may
    return +NaN, which ranks a NaN first instead of last (chip_smoke phase
    17 holds the card's ascending NaN order against the CPU's)."""
    import jax.numpy as jnp

    from quickwit_tpu_torch.search.executor import _negated
    x = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -np.inf, np.inf])
    want = np.asarray(-jnp.asarray(x)).view(np.int64)
    assert _negated(torch.from_numpy(x)).numpy().view(np.int64).tolist() \
        == want.tolist()


# --- the mesh and its collectives --------------------------------------------

def test_make_mesh_shapes_and_identity():
    mesh = t_mesh.make_mesh(4, devices=[CPU] * 8)
    assert mesh.shape == {"splits": 4}
    assert mesh.size == 4 and mesh.axis_names == ("splits",)
    assert mesh.devices.shape == (4,) and mesh.lead == CPU
    assert mesh.row_devices() == [CPU] * 4
    other = t_mesh.make_mesh(4, devices=[CPU, torch.device("cpu", 0)] * 2)
    assert other.row_devices()[1] == torch.device("cpu", 0)
    assert mesh == t_mesh.make_mesh(4, devices=[CPU] * 4) and mesh != other
    assert len({mesh, t_mesh_of((4, 2)), t_mesh_of((8, 1))}) == 2
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        t_mesh.make_mesh(8, devices=[CPU] * 4)
    assert t_mesh.visible_devices("cpu") == [CPU]


def test_collectives_match_lax_on_cpu():
    """pmax / pmin / psum / all_gather against the JAX collectives on the
    CPU backend, NaN and signed zeros included, for every pair of shards."""
    import itertools

    import jax
    from jax import lax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh, PartitionSpec as P

    vals = [np.nan, 0.0, -0.0, 1.0, -np.inf, 2.5]
    for n in (2, 3):
        combos = np.array(list(itertools.product(vals, repeat=n))).T.copy()
        j_mesh = JMesh(np.array(jax.devices()[:n]), ("s",))
        parts = [torch.from_numpy(row.copy()) for row in combos]
        for name in ("pmax", "pmin", "psum"):
            fn = shard_map(lambda a, op=getattr(lax, name): op(a, "s"),
                           mesh=j_mesh, in_specs=P("s"), out_specs=P(),
                           check_rep=False)
            want = np.asarray(fn(combos))[0]
            got = getattr(t_mesh, name)(parts, CPU).numpy()
            assert got.tobytes() == want.tobytes(), name
        ints = [torch.tensor([3, -1, 7], dtype=torch.int64)[:n - 1].repeat(2)
                for _ in range(n)]
        assert t_mesh.pmax(ints, CPU).tolist() == \
            torch.stack(ints).amax(0).tolist()
    gathered = t_mesh.all_gather([torch.arange(3), torch.arange(3, 5)], CPU)
    assert gathered.tolist() == [0, 1, 2, 3, 4]
