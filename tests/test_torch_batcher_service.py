"""`SearchService.leaf_search` through the context's query batcher, against
the JAX service on the CPU.

Every `SearcherContext` owns a `QueryBatcher`, and every split of a request
goes through it (search/service.py → leaf.execute_prepared_split(batcher=)),
as in the JAX package. Sequential calls are lone riders; a threaded round
over one split, with the first leader held at the batcher's
`batcher.dispatch` fault point until every rider has entered, forms a
stacked group. Each response must equal the JAX service's response to the
same request and the port's own answer with stacking off (hits, counts and
aggregation states, f64 sums to rtol 1e-12). The harness (`Engine`, the
three-split corpus written by both packages, `assert_same_response`) is
`tests/test_torch_residency.py`'s. Requests are distinct per rider: a
repeated request is a leaf-cache hit and never reaches the batcher.
"""

import threading
import time

import pytest

from quickwit_tpu_torch.observability.metrics import (
    QBATCH_GROUPS_TOTAL, SEARCH_BATCHER_QUERIES_TOTAL,
)

from test_torch_residency import (
    QUERIES, assert_same_response, corpus_engines,
)

JOIN_SECS = 60.0
T0 = 1_700_000_000


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        yield corpus_engines(mp, "batcher-service")


def window(lo_s, hi_s):
    return lambda Q: Q.Range("ts", lower=Q.RangeBound(lo_s * 10**6, True),
                             upper=Q.RangeBound(hi_s * 10**6, False))


def _both(engines, **kw):
    jax_engine, torch_engine = engines
    t_svc, t_ctx = torch_engine.service(torch_engine.resolver, **kw)
    j_svc, _ = jax_engine.service(jax_engine.resolver, **kw)
    return t_svc, t_ctx, j_svc


@pytest.mark.parametrize("query", list(QUERIES))
def test_sequential_calls_ride_the_batcher_and_match_jax(engines, query,
                                                         monkeypatch):
    jax_engine, torch_engine = engines
    t_svc, t_ctx, j_svc = _both(engines)
    queries = SEARCH_BATCHER_QUERIES_TOTAL.get()
    for max_hits in (10, 3):
        got = torch_engine.run(t_svc, torch_engine.offsets,
                               torch_engine.request(query, max_hits=max_hits))
        assert got.num_hits > 0
        assert_same_response(got, jax_engine.run(
            j_svc, jax_engine.offsets,
            jax_engine.request(query, max_hits=max_hits)))
    # one rider per split per call
    assert t_ctx.query_batcher.num_queries == 2 * len(torch_engine.offsets)
    assert SEARCH_BATCHER_QUERIES_TOTAL.get() - queries == \
        2 * len(torch_engine.offsets)
    monkeypatch.setenv("QW_DISABLE_QBATCH", "1")
    off_svc, _ = torch_engine.service(torch_engine.resolver)
    assert_same_response(got, torch_engine.run(
        off_svc, torch_engine.offsets,
        torch_engine.request(query, max_hits=3)))


class HoldFirstLeader:
    """Holds the first dispatching leader at `batcher.dispatch` until
    `riders` queries have entered the batcher (polled, with a timeout)."""

    def __init__(self, riders: int):
        self.riders = riders
        self.batcher = None
        self.held = threading.Event()
        self.timed_out = False

    def perturb(self, operation):
        if operation != "batcher.dispatch" or self.held.is_set():
            return
        self.held.set()
        deadline = time.monotonic() + 10.0
        while (self.batcher.num_queries < self.riders
               and time.monotonic() < deadline):
            time.sleep(0.005)
        self.timed_out = self.batcher.num_queries < self.riders


@pytest.mark.parametrize("aggs", [True, False], ids=["aggs", "hits_only"])
def test_threaded_round_with_a_held_leader_forms_a_group(engines, aggs):
    """Five riders over one split, each a distinct time window sorted by
    ts: the first leader is held until all have entered, so the others
    stack behind the second leader; every response equals the JAX
    service's and the port's answer with stacking off."""
    jax_engine, torch_engine = engines
    riders = 5
    t_svc, t_ctx, j_svc = _both(engines)
    hold = HoldFirstLeader(riders)
    hold.batcher = t_ctx.query_batcher
    t_ctx.query_batcher.fault_injector = hold
    split = torch_engine.offsets[:1]
    extra = {} if aggs else {"aggs": None}
    builds = [window(T0 + 60 * i, T0 + 1500 + 60 * i) for i in range(riders)]
    results = [None] * riders

    def rider(i):
        try:
            results[i] = torch_engine.run(
                t_svc, split, torch_engine.request(builds[i], **extra))
        except Exception as exc:  # noqa: BLE001 - recorded for asserts
            results[i] = exc

    groups = QBATCH_GROUPS_TOTAL.get()
    threads = [threading.Thread(target=rider, args=(i,), daemon=True)
               for i in range(riders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_SECS)
    assert not any(t.is_alive() for t in threads)
    assert hold.held.is_set() and not hold.timed_out
    assert QBATCH_GROUPS_TOTAL.get() - groups >= 1
    assert t_ctx.query_batcher.num_dispatches < riders
    for i, got in enumerate(results):
        assert not isinstance(got, Exception), got
        assert got.num_hits > 0
        assert_same_response(got, jax_engine.run(
            j_svc, jax_engine.offsets[:1],
            jax_engine.request(builds[i], **extra)))
        solo_svc, _ = torch_engine.service(torch_engine.resolver)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("QW_DISABLE_QBATCH", "1")
            assert_same_response(got, torch_engine.run(
                solo_svc, split, torch_engine.request(builds[i], **extra)))
