"""The node service's batch route (quickwit_tpu_torch/search/service.py's
`_prepare_group` / `_execute_group` batch branch over parallel/fanout.py)
against the JAX service as it runs and against the port's own per-split
route (`batch_size=1`).

Each package writes the same six-split corpus with its own `SplitWriter`
(the harness of `tests/test_torch_residency.py`: bytes asserted equal).
Responses are compared exactly: hits, counts and every intermediate
aggregation state, f64 sums to rtol 1e-12 (the per-split route's integer
states by value: the batch widens int32 sums to int64 as the JAX batch
does). On the CPU the JAX service takes its mesh route (eight fake host
devices), which its own tests hold bit-identical to `mesh=None`.

Also here: the routing rule (`_split_caches_route_per_split`), the
deadline shed between dispatch and readback, a prefetched batch dropped
by the deadline (`_discard_prepared`), the pipelined loop's overlap shown
by the order of its stages, and a planted kernel fault, which must reach
the caller with nothing rerun per split.
"""

import threading

import pytest
import torch


from quickwit_tpu_torch.common import deadline as deadline_mod
from quickwit_tpu_torch.observability import flight
from quickwit_tpu_torch.observability.metrics import (
    MASK_CACHE_HITS_TOTAL, PREDICATE_STAGED_BYTES_TOTAL,
    RESIDENT_READBACKS_SHED, RESIDENT_STAGING_CACHE_HITS,
    SEARCH_KERNEL_LAUNCHES_TOTAL, SEARCH_KERNEL_THRESHOLD_TOTAL,
    STAGING_BYTES_TOTAL,
)
from quickwit_tpu_torch.ops.kernels.build import KernelError
from quickwit_tpu_torch.parallel import fanout as t_fanout
from quickwit_tpu_torch.search import leaf as t_leaf
from quickwit_tpu_torch.search import service as t_service

from test_torch_fanout import _widen_ints
from test_torch_indexing import force_python_paths
from test_torch_residency import (
    Engine, _hits, assert_same_response, assert_states_close,
)

NUM_SPLITS = 6
JOIN_TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        out = []
        for name in ("jax", "torch"):
            engine = Engine(name)
            engine.resolver, engine.blobs, engine.offsets = \
                engine.write_corpus("fanout-service", num_splits=NUM_SPLITS)
            out.append(engine)
        assert out[0].blobs == out[1].blobs
        yield out


NO_TIERS = {"enable_mask_cache": False, "enable_agg_cache": False}


def assert_equals_per_split(got, want) -> None:
    """The batch route's response against the per-split route's."""
    assert got.num_hits == want.num_hits
    assert not got.failed_splits and not want.failed_splits
    assert _hits(got) == _hits(want)
    assert_states_close(_widen_ints(want.intermediate_aggs),
                        _widen_ints(got.intermediate_aggs))


class BatchSpy:
    """Counts the service's batch dispatches and per-split executions."""

    def __init__(self, monkeypatch):
        self.batches = []
        self.per_split = 0
        real_dispatch = t_service.dispatch_batch
        real_execute = t_leaf.execute_prepared_split

        def dispatch(batch, request, device=None, mesh=None):
            self.batches.append(list(batch.split_ids))
            return real_dispatch(batch, request, device, mesh)

        def execute(*args, **kw):
            self.per_split += 1
            return real_execute(*args, **kw)

        monkeypatch.setattr(t_service, "dispatch_batch", dispatch)
        monkeypatch.setattr(t_service, "execute_prepared_split", execute)


CASES = {
    # scored sorts keep the batch route with the tiers on
    "score_tiers_on": ({}, dict(query="body:error", sort=())),
    "timestamp_aggs": (NO_TIERS, {}),
    "agg_only": (NO_TIERS, dict(max_hits=0, sort=())),
    "two_keys": (NO_TIERS, dict(query="severity:WARN",
                                sort=(("latency", "asc"), ("ts", "desc")))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_batch_route_matches_jax_service_and_per_split(engines, monkeypatch,
                                                       name):
    jax_engine, torch_engine = engines
    context_kw, request_kw = CASES[name]
    spy = BatchSpy(monkeypatch)
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=4,
                                  prefetch=True, **context_kw)
    j_svc, _ = jax_engine.service(jax_engine.resolver, batch_size=4,
                                  prefetch=True, **context_kw)
    per_split, _ = torch_engine.service(torch_engine.resolver, **context_kw)
    t_req = torch_engine.request(**request_kw)
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    got = torch_engine.run(svc, torch_engine.offsets, t_req)
    # six splits in groups of four: two batches, one dispatch each
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches == 2
    assert [len(ids) for ids in spy.batches] == [4, 2]
    assert spy.per_split == 0
    assert got.num_hits > 0
    assert_same_response(got, jax_engine.run(
        j_svc, jax_engine.offsets, jax_engine.request(**request_kw)))
    assert_equals_per_split(got, torch_engine.run(
        per_split, torch_engine.offsets, t_req))


def test_batch_dispatches_are_flight_events(engines):
    """`dispatch.launch` with path "batch" and the split count, as the JAX
    package emits it; `dispatch.readback` after it."""
    _, torch_engine = engines
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=8,
                                  **NO_TIERS)
    flight.FLIGHT.begin_run()
    torch_engine.run(svc, torch_engine.offsets)
    events = flight.FLIGHT.events()
    launches = [e for e in events if e["kind"] == "dispatch.launch"]
    assert [e["attrs"]["path"] for e in launches] == ["batch"]
    assert launches[0]["attrs"]["splits"] == NUM_SPLITS
    assert any(e["kind"] == "dispatch.readback"
               and e["attrs"]["path"] == "batch" for e in events)
    assert any(e["kind"] == "staging.upload" for e in events)


def test_multi_split_batch_equivalence(engines):
    """`tests/test_resident_engine.py:287`: resident and cold batches answer
    alike, warm repeats included; a warm repeat stages 0 bytes and hits
    every split's resident copy."""
    jax_engine, torch_engine = engines
    resident, ctx = torch_engine.service(torch_engine.resolver,
                                         resident_columns=True, batch_size=8)
    cold, _ = torch_engine.service(torch_engine.resolver,
                                   resident_columns=False, batch_size=8)
    j_resident, _ = jax_engine.service(jax_engine.resolver,
                                       resident_columns=True, batch_size=8)
    request = torch_engine.request("body:error", sort=())
    first = torch_engine.run(resident, torch_engine.offsets, request)
    assert_same_response(first, torch_engine.run(cold, torch_engine.offsets,
                                                 request))
    assert_same_response(first, jax_engine.run(
        j_resident, jax_engine.offsets,
        jax_engine.request("body:error", sort=())))
    staged = STAGING_BYTES_TOTAL.get()
    hits = RESIDENT_STAGING_CACHE_HITS.get()
    assert_same_response(first, torch_engine.run(resident,
                                                 torch_engine.offsets,
                                                 request))
    assert STAGING_BYTES_TOTAL.get() - staged == 0
    assert RESIDENT_STAGING_CACHE_HITS.get() - hits == NUM_SPLITS
    # one resident copy per split, the budget's bytes the store's
    assert ctx.hbm_budget.stats()["resident"] == \
        ctx.resident_store.stats()["bytes"] > 0
    assert ctx.hbm_budget.stats()["pinned"] == 0


def test_batch_and_per_split_routes_share_one_resident_copy(engines):
    """What the batch staged serves the per-split route: no byte is staged
    again. (A terms aggregation is the exception by content: the batch's
    ordinals index the batch's dictionary, under their own key.)"""
    _, torch_engine = engines
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=8)
    request = torch_engine.request("body:error", sort=(), max_hits=9,
                                   aggs={"lat": {"stats": {
                                       "field": "latency"}}})
    batched = torch_engine.run(svc, torch_engine.offsets, request)
    held = ctx.resident_store.stats()["bytes"]
    ctx.batch_size = 1
    staged = STAGING_BYTES_TOTAL.get()
    again = torch_engine.run(svc, torch_engine.offsets, torch_engine.request(
        "body:error", sort=(), max_hits=8,
        aggs={"lat": {"stats": {"field": "latency"}}}))
    assert STAGING_BYTES_TOTAL.get() - staged == 0
    assert ctx.resident_store.stats()["bytes"] == held
    assert _hits(again) == _hits(batched)[:8]


def test_default_batched_config_serves_and_fills_caches(engines):
    """`tests/test_hierarchical_cache.py:452`: a stock node (batch_size >
    1, prefetch on) still warms and serves Tier A: cache-applicable
    requests route per split; scoring sorts keep the batch route."""
    jax_engine, torch_engine = engines
    batched, context = torch_engine.service(torch_engine.resolver,
                                            batch_size=16, prefetch=True)
    cold, _ = torch_engine.cold_service(torch_engine.resolver,
                                        batch_size=16, prefetch=True)
    j_batched, _ = jax_engine.service(jax_engine.resolver, batch_size=16,
                                      prefetch=True)
    first = torch_engine.run(batched, torch_engine.offsets)
    assert context.mask_cache.stats["size_bytes"] > 0
    warm_request = torch_engine.request(max_hits=7)
    hits_before = MASK_CACHE_HITS_TOTAL.get()
    pred_before = PREDICATE_STAGED_BYTES_TOTAL.get()
    warm = torch_engine.run(batched, torch_engine.offsets, warm_request)
    assert MASK_CACHE_HITS_TOTAL.get() - hits_before == NUM_SPLITS
    assert PREDICATE_STAGED_BYTES_TOTAL.get() - pred_before == 0
    assert_same_response(first, torch_engine.run(cold, torch_engine.offsets))
    assert_same_response(warm, torch_engine.run(cold, torch_engine.offsets,
                                                warm_request))
    assert_same_response(first, jax_engine.run(j_batched,
                                               jax_engine.offsets))


ROUTING = [
    dict(sort=()),                                   # score, hits
    dict(sort=(), max_hits=0),                       # score, agg-only
    dict(sort=(), max_hits=0, aggs=None),            # pure count
    dict(),                                          # timestamp sort
    dict(max_hits=0),                                # agg-only by ts
    dict(sort=(("_score", "desc"), ("ts", "desc"))),
]


@pytest.mark.parametrize("tiers", [
    {}, {"enable_mask_cache": False}, {"enable_agg_cache": False},
    NO_TIERS], ids=["both", "agg_only", "mask_only", "none"])
def test_routing_rule_mirrors_jax(engines, tiers):
    jax_engine, torch_engine = engines
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=8,
                                  **tiers)
    j_svc, _ = jax_engine.service(jax_engine.resolver, batch_size=8,
                                  **tiers)
    for kw in ROUTING:
        assert svc._split_caches_route_per_split(
            torch_engine.request(**kw)) == \
            j_svc._split_caches_route_per_split(jax_engine.request(**kw)), kw


def test_batched_path_accepts_threshold(engines):
    """`tests/test_threshold_pruning.py:257`: a wire-seeded threshold below
    every doc rides into every lane of the batch (counted per real lane)
    and changes no hit."""
    jax_engine, torch_engine = engines
    seed = float(1_700_000_000 * 1_000_000)
    req = torch_engine.request(max_hits=5, count_hits_exact=False,
                               aggs=None)
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=8,
                                  **NO_TIERS)
    before = SEARCH_KERNEL_THRESHOLD_TOTAL.get()
    got = torch_engine.run(svc, torch_engine.offsets, req, threshold=seed)
    assert SEARCH_KERNEL_THRESHOLD_TOTAL.get() - before == NUM_SPLITS
    baseline, _ = torch_engine.service(
        torch_engine.resolver, batch_size=8,
        enable_threshold_pruning=False, **NO_TIERS)
    assert _hits(got)[:5] == _hits(torch_engine.run(
        baseline, torch_engine.offsets, req))[:5]
    j_svc, _ = jax_engine.service(jax_engine.resolver, batch_size=8,
                                  **NO_TIERS)
    assert_same_response(got, jax_engine.run(
        j_svc, jax_engine.offsets,
        jax_engine.request(max_hits=5, count_hits_exact=False, aggs=None),
        threshold=seed))


def _expire_ambient_deadline():
    deadline = deadline_mod.current_deadline()
    deadline._expires_at = float("-inf")


def test_deadline_sheds_between_dispatch_and_readback(engines, monkeypatch):
    """The programs were dispatched, but the deadline passed before the
    readback: the dispatch is abandoned, `qw_resident_readbacks_shed_total`
    rises by one, every real split fails retryably, and every pin goes."""
    _, torch_engine = engines
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=8,
                                    **NO_TIERS)
    real_dispatch = t_service.dispatch_batch
    abandoned = []
    real_abandon = t_service.abandon_dispatch

    def dispatch(batch, request, device=None, mesh=None):
        out = real_dispatch(batch, request, device, mesh)
        _expire_ambient_deadline()
        return out

    def abandon(dispatched):
        abandoned.append(dispatched)
        real_abandon(dispatched)

    monkeypatch.setattr(t_service, "dispatch_batch", dispatch)
    monkeypatch.setattr(t_service, "abandon_dispatch", abandon)
    shed = RESIDENT_READBACKS_SHED.get()
    request = torch_engine.models.LeafSearchRequest(
        search_request=torch_engine.request(), index_uid="res:0",
        doc_mapping=torch_engine.mapper.to_dict(),
        splits=list(torch_engine.offsets), deadline_millis=600_000)
    response = svc.leaf_search(request)
    assert len(abandoned) == 1
    assert RESIDENT_READBACKS_SHED.get() - shed == 1
    assert sorted(f.split_id for f in response.failed_splits) == \
        sorted(s.split_id for s in torch_engine.offsets)
    assert all(f.retryable for f in response.failed_splits)
    assert response.num_hits == 0
    assert ctx.hbm_budget.stats()["pinned"] == 0


def test_deadline_drops_a_prefetched_batch(engines, monkeypatch):
    """Three groups of two, pipelined: the deadline passes while group 0
    executes, so the loop drops the batch group prefetched meanwhile
    (`_discard_prepared`) and fails its splits and the rest retryably."""
    _, torch_engine = engines
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=2,
                                    prefetch=True, **NO_TIERS)
    discarded = []
    real_execute, real_discard = svc._execute_group, svc._discard_prepared

    def execute(prepared, *args):
        real_execute(prepared, *args)
        _expire_ambient_deadline()

    def discard(prepared):
        discarded.append(prepared[0])
        real_discard(prepared)

    monkeypatch.setattr(svc, "_execute_group", execute)
    monkeypatch.setattr(svc, "_discard_prepared", discard)
    request = torch_engine.models.LeafSearchRequest(
        search_request=torch_engine.request(), index_uid="res:0",
        doc_mapping=torch_engine.mapper.to_dict(),
        splits=list(torch_engine.offsets), deadline_millis=600_000)
    response = svc.leaf_search(request)
    assert discarded == ["batch"]
    assert len(response.failed_splits) == NUM_SPLITS - 2
    assert all(f.retryable for f in response.failed_splits)
    assert ctx.hbm_budget.stats()["pinned"] == 0


def test_pipelined_loop_lowers_the_next_batch_during_execution(
        engines, monkeypatch):
    """`tests/test_pipelining.py`, shown by the order of the stages: group
    0's execute stage waits until group 1's lowering has started on the
    prefetch worker (which can only happen if the loop overlaps them); the
    response equals the unpipelined one."""
    _, torch_engine = engines
    request = torch_engine.request("body:error", sort=(), max_hits=12)
    sequential, _ = torch_engine.service(torch_engine.resolver, batch_size=2,
                                         prefetch=False, **NO_TIERS)
    want = torch_engine.run(sequential, torch_engine.offsets, request)
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=2,
                                  prefetch=True, **NO_TIERS)
    order = []
    lock = threading.Lock()
    second_prepare = threading.Event()
    real_prepare, real_execute = svc._prepare_group, svc._execute_group

    def note(event):
        with lock:
            order.append(event)

    def prepare(group, *args):
        index = len([e for e in order if e[0] == "prepare"])
        note(("prepare", index, threading.current_thread().name))
        if index == 1:
            second_prepare.set()
        return real_prepare(group, *args)

    def execute(prepared, *args):
        index = len([e for e in order if e[0] == "execute"])
        note(("execute", index, prepared[0]))
        if index == 0:
            assert second_prepare.wait(JOIN_TIMEOUT_S), \
                "group 1 was not lowered while group 0 executed"
        real_execute(prepared, *args)
        note(("executed", index, prepared[0]))

    monkeypatch.setattr(svc, "_prepare_group", prepare)
    monkeypatch.setattr(svc, "_execute_group", execute)
    got = torch_engine.run(svc, torch_engine.offsets, request)
    assert_same_response(got, want)
    stages = [(kind, index) for kind, index, _ in order]
    assert stages.index(("prepare", 1)) < stages.index(("executed", 0))
    assert all(name.startswith("leaf-prefetch")
               for kind, _, name in order if kind == "prepare")
    assert [kind for kind, _, kind_of in order if kind == "execute"] == \
        ["execute"] * 3
    assert {e[2] for e in order if e[0] == "execute"} == {"batch"}


@pytest.mark.parametrize("fault", [
    KernelError("score_topk_lanes launch failed: CUDA error 700"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["launch", "oom", "cuda"])
def test_a_device_fault_reaches_the_caller(engines, monkeypatch, fault):
    """A fault planted in the lane kernel's wrapper is raised through the
    service; no split is rerun per split."""
    _, torch_engine = engines
    spy = BatchSpy(monkeypatch)

    def broken(lanes, k):
        raise fault

    monkeypatch.setattr(t_fanout, "score_topk_lanes", broken)
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=8)
    with pytest.raises(type(fault)):
        torch_engine.run(svc, torch_engine.offsets,
                         torch_engine.request("body:error", sort=()))
    assert len(spy.batches) == 1
    assert spy.per_split == 0
    assert ctx.hbm_budget.stats()["pinned"] == 0


def test_a_query_that_does_not_batch_runs_per_split(engines, monkeypatch):
    """The fallback the JAX service keeps: a group whose batch build
    refuses (plans that differ in structure across splits, mixed column
    packings) runs split by split and answers as the per-split route
    does."""
    _, torch_engine = engines
    spy = BatchSpy(monkeypatch)

    def refuse(*args, **kw):
        raise ValueError("query does not lower to a uniform structure "
                         "across splits")

    monkeypatch.setattr(t_service, "build_batch", refuse)
    svc, _ = torch_engine.service(torch_engine.resolver, batch_size=8)
    per_split, _ = torch_engine.service(torch_engine.resolver)
    request = torch_engine.request("body:error", sort=())
    got = torch_engine.run(svc, torch_engine.offsets, request)
    assert spy.batches == [] and spy.per_split == NUM_SPLITS
    assert_same_response(got, torch_engine.run(
        per_split, torch_engine.offsets, request))


def test_a_batch_over_the_budget_runs_per_split(engines, monkeypatch):
    """A batch whose new bytes exceed the whole budget would wait on its
    own pins: it runs per split (each split admitted alone), with the same
    answer."""
    _, torch_engine = engines
    probe, probe_ctx = torch_engine.service(torch_engine.resolver)
    request = torch_engine.request("body:error", sort=())
    want = torch_engine.run(probe, torch_engine.offsets, request)
    per_split_bytes = probe_ctx.hbm_budget.stats()["resident"] // NUM_SPLITS
    spy = BatchSpy(monkeypatch)
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=8)
    ctx.hbm_budget.budget = 2 * per_split_bytes
    got = torch_engine.run(svc, torch_engine.offsets, request)
    assert spy.per_split == NUM_SPLITS
    assert_same_response(got, want)
    assert ctx.hbm_budget.stats()["pinned"] == 0


def test_the_batch_route_fills_no_cache(engines):
    """The route's response covers several splits: no leaf-cache entry and
    no tier entry is made from it."""
    _, torch_engine = engines
    svc, ctx = torch_engine.service(torch_engine.resolver, batch_size=8)
    torch_engine.run(svc, torch_engine.offsets,
                     torch_engine.request("body:error", sort=()))
    assert ctx.leaf_cache.stats["size_bytes"] == 0
    assert ctx.agg_cache.stats["size_bytes"] == 0
    assert ctx.mask_cache.stats["size_bytes"] == 0
    spy_before = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    torch_engine.run(svc, torch_engine.offsets,
                     torch_engine.request("body:error", sort=()))
    # a repeat is not a leaf-cache hit: the batch runs again
    assert SEARCH_KERNEL_LAUNCHES_TOTAL.get() - spy_before == 1
