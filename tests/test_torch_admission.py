"""Byte-exact HBM admission (reference: SearchPermitProvider,
search_permit_provider.rs:43) in the port, against the JAX package.

Over-budget work queues instead of materializing; residency evicts LRU;
the bytes admitted are the bytes staged. Each budget case runs on both
packages' `HbmBudget` (the pattern is the JAX package's
`tests/test_admission.py`), and the service cases hold the port's
`SearchService` on `device="cpu"` against the JAX one.
"""

import importlib
import threading
import time

import numpy as np
import pytest

from test_torch_residency import Engine, assert_same_response, corpus_engines

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def _budget_cls(package):
    return importlib.import_module(f"{package}.search.admission").HbmBudget


class _FakeReader:
    def __init__(self):
        self._device_array_cache = {"k": object()}


@pytest.mark.parametrize("package", PACKAGES)
def test_budget_blocks_until_release(package):
    budget = _budget_cls(package)(budget_bytes=1000)
    r1, r2 = _FakeReader(), _FakeReader()
    assert budget.admit(r1, 700) == 700
    order = []

    def second():
        budget.admit(r2, 700, timeout_secs=10)
        order.append("admitted")

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert order == []  # queued: 700 + 700 > 1000
    order.append("released")
    budget.release(r1, 700)
    t.join(timeout=5)
    assert order == ["released", "admitted"]
    budget.release(r2, 700)
    assert budget.stats()["pinned"] == 0


@pytest.mark.parametrize("package", PACKAGES)
def test_admission_evicts_lru_residency(package):
    budget = _budget_cls(package)(budget_bytes=1000)
    r1, r2, r3 = _FakeReader(), _FakeReader(), _FakeReader()
    budget.admit(r1, 300)
    budget.release(r1, 300)
    budget.admit(r2, 400)
    budget.release(r2, 400)  # r1 then r2 resident, 700 bytes
    assert budget.stats()["resident"] == 700
    budget.admit(r3, 500)  # must evict the least recently used: r1
    assert r1._device_array_cache == {}
    assert r2._device_array_cache != {}
    assert budget.stats()["resident"] == 400
    budget.release(r3, 500)


@pytest.mark.parametrize("package", PACKAGES)
def test_pinned_owner_is_never_evicted(package):
    """A zero-byte admission (a fully resident warmup) pins its owner: a
    query in flight keeps its arrays under pressure."""
    budget = _budget_cls(package)(budget_bytes=1000)
    r1, r2 = _FakeReader(), _FakeReader()
    budget.admit(r1, 800)
    budget.release(r1, 800)
    assert budget.admit(r1, 0) == 0   # warm query in flight on r1
    budget.admit(r2, 600)
    assert r1._device_array_cache != {}
    budget.release(r1, 0)
    budget.release(r2, 600)


@pytest.mark.parametrize("package", PACKAGES)
def test_oversized_query_admitted_alone(package):
    budget = _budget_cls(package)(budget_bytes=100)
    reader = _FakeReader()
    assert budget.admit(reader, 5000) == 5000  # pinned==0: goes through
    budget.release(reader, 5000)


@pytest.mark.parametrize("package", PACKAGES)
def test_admission_timeout_is_loud(package):
    budget = _budget_cls(package)(budget_bytes=100)
    r1, r2 = _FakeReader(), _FakeReader()
    budget.admit(r1, 90)
    with pytest.raises(TimeoutError, match="admission timed out"):
        budget.admit(r2, 90, timeout_secs=0.2)
    budget.release(r1, 90)


def test_default_budget_reads_the_same_variable():
    j, t = (importlib.import_module(f"{p}.search.admission")
            for p in PACKAGES)
    assert t.DEFAULT_BUDGET_BYTES == j.DEFAULT_BUDGET_BYTES
    assert _budget_cls(PACKAGES[1])().budget == t.DEFAULT_BUDGET_BYTES


def test_drr_grant_order_matches_jax():
    """The same enqueue sequence over three tenants of different weights
    and costs gives the same grant order in both packages' schedulers."""
    seqs = []
    rng = np.random.RandomState(5)
    tenants = [("acme", 4.0), ("bigco", 2.0), ("tiny", 1.0)]
    plan = [(tenants[i % 3], int(c)) for i, c in
            enumerate(rng.randint(1 << 20, 300 << 20, size=30))]
    for package in PACKAGES:
        drr = importlib.import_module(f"{package}.tenancy.drr")
        sched = drr.DrrScheduler()
        tickets = [sched.enqueue(tid, weight, cost)
                   for (tid, weight), cost in plan]
        order = []
        while len(sched):
            head = sched.head()
            order.append(tickets.index(head))
            sched.remove(head, served=True)
        seqs.append(order)
    assert seqs[0] == seqs[1]
    assert sorted(seqs[1]) == list(range(len(plan)))
    assert seqs[1] != list(range(len(plan)))  # weights reorder the grants


# --- through the service ------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        yield corpus_engines(mp, "admission")


@pytest.mark.parametrize("engine_name", ["jax", "torch"])
def test_leaf_search_over_budget_queues_not_materializes(engines,
                                                         engine_name):
    """End-to-end: a budget smaller than two splits' plans. Every search
    succeeds; pinned bytes never held two splits at once, and the response
    equals the other package's unpressured one."""
    jax_engine, torch_engine = engines
    engine = jax_engine if engine_name == "jax" else torch_engine
    other = torch_engine if engine_name == "jax" else jax_engine
    probe, probe_ctx = engine.service(engine.resolver)
    request = engine.request(max_hits=5, aggs=None)
    engine.run(probe, engine.offsets[:1], request)
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    assert per_split > 0

    service, context = engine.service(engine.resolver)
    context.hbm_budget = engine.admission.HbmBudget(
        budget_bytes=int(per_split * 1.5))
    high_water = {"max": 0}
    original_admit = context.hbm_budget.admit

    def tracking_admit(owner, nbytes, **kw):
        out = original_admit(owner, nbytes, **kw)
        high_water["max"] = max(high_water["max"],
                                context.hbm_budget.stats()["pinned"])
        return out

    context.hbm_budget.admit = tracking_admit
    response = engine.run(service, engine.offsets, request)
    other_service, _ = other.service(other.resolver)
    want = other.run(other_service, other.offsets,
                     other.request(max_hits=5, aggs=None))
    assert response.num_hits == want.num_hits > 0
    assert_same_response(response, want)
    assert 0 < high_water["max"] <= per_split * 1.5
    assert context.hbm_budget.stats()["pinned"] == 0


@pytest.mark.parametrize("resident_columns", [True, False])
def test_concurrent_searches_under_a_tight_budget(engines, resident_columns):
    """Eight threads search one service at once under a budget of 1.5
    splits, with a short switch interval: every response equals the JAX
    service's, and no pin outlives its query."""
    import sys
    jax_engine, torch_engine = engines
    probe, probe_ctx = torch_engine.service(torch_engine.resolver)
    torch_engine.run(probe, torch_engine.offsets[:1])
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    service, context = torch_engine.service(
        torch_engine.resolver, resident_columns=resident_columns,
        leaf_cache_bytes=0, enable_mask_cache=False, enable_agg_cache=False)
    context.hbm_budget = torch_engine.admission.HbmBudget(
        budget_bytes=int(per_split * 1.5))
    j_service, _ = jax_engine.service(jax_engine.resolver)
    want = {m: jax_engine.run(j_service, jax_engine.offsets,
                              jax_engine.request(max_hits=m))
            for m in (4, 9)}
    got, errors = [], []

    def worker(i):
        try:
            max_hits = (4, 9)[i % 2]
            for _ in range(3):
                got.append((max_hits, torch_engine.run(
                    service, torch_engine.offsets,
                    torch_engine.request(max_hits=max_hits))))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 24
    for max_hits, response in got:
        assert_same_response(response, want[max_hits])
    assert context.hbm_budget.stats()["pinned"] == 0


@pytest.mark.parametrize("resident_columns", [True, False])
def test_concurrent_cold_warmups_stage_a_split_once(engines, monkeypatch,
                                                    resident_columns):
    """Two queries warm one cold split at once (the copy slowed down to
    widen the window): the split is staged and admitted once, so the
    budget's resident bytes are the bytes its cache holds."""
    _, torch_engine = engines
    leaf = engine_leaf(torch_engine)
    stage = leaf._stage

    def slow_stage(*args):
        time.sleep(0.2)
        return stage(*args)

    monkeypatch.setattr(leaf, "_stage", slow_stage)
    service, context = torch_engine.service(
        torch_engine.resolver, resident_columns=resident_columns,
        leaf_cache_bytes=0, enable_mask_cache=False, enable_agg_cache=False)
    staged = torch_engine.counter("STAGING_BYTES_TOTAL")
    threads = [threading.Thread(target=torch_engine.run, args=(
        service, torch_engine.offsets[:1],
        torch_engine.request(max_hits=m))) for m in (5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if resident_columns:
        owner = context.resident_store.peek("s0")
        assert context.resident_store.stats()["bytes"] == \
            context.hbm_budget.stats()["resident"]
    else:
        reader = context.reader(torch_engine.offsets[0])
        owner = leaf._reader_arrays(reader, context.device)
    held = sum(t.numel() * t.element_size()
               for t in owner._device_array_cache.values())
    assert held > 0
    assert context.hbm_budget.stats()["resident"] == held
    assert torch_engine.counter("STAGING_BYTES_TOTAL") - staged == held
    assert context.hbm_budget.stats()["pinned"] == 0


@pytest.mark.parametrize("resident_columns", [True, False])
def test_a_cold_warmup_queued_for_budget_never_stalls_a_warm_query(
        engines, resident_columns):
    """A cold query of one split waits in admission for its bytes. A warm
    query of the same split, whose columns are all resident, needs only a
    zero-byte pin: it finishes while the cold one still waits, and both
    responses equal the JAX service's."""
    jax_engine, torch_engine = engines
    HbmBudget = torch_engine.admission.HbmBudget
    gate, queued = threading.Event(), threading.Event()
    gate.set()

    class QueueingBudget(HbmBudget):
        def admit(self, owner, new_bytes, **kw):
            if new_bytes > 0 and not gate.is_set():
                queued.set()
                gate.wait(timeout=60)
            return HbmBudget.admit(self, owner, new_bytes, **kw)

    service, context = torch_engine.service(
        torch_engine.resolver, resident_columns=resident_columns,
        leaf_cache_bytes=0, enable_mask_cache=False, enable_agg_cache=False)
    context.hbm_budget = QueueingBudget(budget_bytes=1 << 30)
    split = torch_engine.offsets[:1]
    warm = torch_engine.request(max_hits=5, aggs=None)
    cold = torch_engine.request(query="severity:WARN", max_hits=5,
                                aggs=None)
    torch_engine.run(service, split, warm)
    gate.clear()
    got = {}
    rival = threading.Thread(target=lambda: got.setdefault(
        "cold", torch_engine.run(service, split, cold)))
    rival.start()
    try:
        assert queued.wait(timeout=30)
        repeat = threading.Thread(target=lambda: got.setdefault(
            "warm", torch_engine.run(service, split,
                                     torch_engine.request(max_hits=6,
                                                          aggs=None))))
        repeat.start()
        repeat.join(timeout=30)
        assert not repeat.is_alive()
        assert rival.is_alive() and "cold" not in got
    finally:
        gate.set()
        rival.join(timeout=60)
    assert not rival.is_alive()
    j_service, _ = jax_engine.service(jax_engine.resolver)
    j_split = jax_engine.offsets[:1]
    assert_same_response(got["warm"], jax_engine.run(
        j_service, j_split, jax_engine.request(max_hits=6, aggs=None)))
    assert_same_response(got["cold"], jax_engine.run(
        j_service, j_split, jax_engine.request(query="severity:WARN",
                                               max_hits=5, aggs=None)))
    assert context.hbm_budget.stats()["pinned"] == 0


@pytest.mark.parametrize("resident_columns", [True, False])
def test_eviction_racing_a_warm_lookup_cannot_lose_columns(engines,
                                                           resident_columns):
    """Another query's admission evicts every idle resident split right
    before each admission of this one. The warmup pins its owner before it
    reads the cache, so what it found resident stays resident: each warm
    response still equals the JAX service's."""
    jax_engine, torch_engine = engines
    HbmBudget = torch_engine.admission.HbmBudget

    class RivalBudget(HbmBudget):
        def admit(self, owner, new_bytes, **kw):
            rival = _FakeReader()
            HbmBudget.admit(self, rival, self.budget)   # evicts idle owners
            HbmBudget.release(self, rival, self.budget, to_resident=False)
            return HbmBudget.admit(self, owner, new_bytes, **kw)

    service, context = torch_engine.service(
        torch_engine.resolver, resident_columns=resident_columns,
        leaf_cache_bytes=0, enable_mask_cache=False, enable_agg_cache=False)
    context.hbm_budget = RivalBudget(budget_bytes=1 << 30)
    j_service, _ = jax_engine.service(jax_engine.resolver)
    # one split, so that each warm lookup finds its columns resident
    for max_hits in (5, 6, 7):
        got = torch_engine.run(service, torch_engine.offsets[:1],
                               torch_engine.request(max_hits=max_hits))
        assert_same_response(got, jax_engine.run(
            j_service, jax_engine.offsets[:1],
            jax_engine.request(max_hits=max_hits)))
    assert context.hbm_budget.stats()["pinned"] == 0


@pytest.mark.parametrize("query", ["repeated_term", "two_terms"])
def test_admitted_bytes_equal_the_bytes_staged(engines, query):
    """The port admits exactly the bytes its warmup stages, and the store
    holds them. A lowered plan names each array key in one slot (the same
    term twice in a Bool shares its slot), so both packages admit the same
    bytes."""
    jax_engine, torch_engine = engines
    builds = {
        "repeated_term": lambda Q: Q.Bool(should=(Q.Term("body", "error"),
                                                  Q.Term("body", "error"))),
        "two_terms": lambda Q: Q.Bool(should=(Q.Term("body", "error"),
                                              Q.Term("severity", "WARN"))),
    }
    admitted = {}
    for engine in (jax_engine, torch_engine):
        # the mask tier's seeded copy rides outside admission: off here
        service, context = engine.service(engine.resolver,
                                          enable_mask_cache=False)
        seen = []
        original_admit = context.hbm_budget.admit

        def recording_admit(owner, nbytes, original=original_admit,
                            seen=seen, **kw):
            seen.append(nbytes)
            return original(owner, nbytes, **kw)

        context.hbm_budget.admit = recording_admit
        staged = engine.counter("STAGING_BYTES_TOTAL")
        request = engine.request(builds[query], max_hits=5, aggs=None)
        response = engine.run(service, engine.offsets[:1], request)
        assert response.num_hits > 0
        assert sum(seen) == engine.counter("STAGING_BYTES_TOTAL") - staged
        assert sum(seen) == context.resident_store.stats()["bytes"] > 0
        plan = engine_leaf(engine).prepare_plan_only(
            request, engine.mapper, context.reader(engine.offsets[0]), "s0")
        assert len(set(plan.array_keys)) == len(plan.array_keys)
        assert sum(seen) == sum(arr.nbytes for arr in plan.arrays)
        admitted[engine.name] = (sum(seen), response)
    assert_same_response(admitted["torch"][1], admitted["jax"][1])
    assert admitted["torch"][0] == admitted["jax"][0]


def test_a_key_in_two_slots_is_staged_and_admitted_once(engines):
    """A plan built by hand with one key in two slots: the port stages the
    key once and admits its bytes once; the JAX package's warmup counts it
    per slot. Only the byte accounting differs: both slots read the same
    array."""
    import dataclasses
    jax_engine, torch_engine = engines
    counts = {}
    for engine in (jax_engine, torch_engine):
        leaf = engine_leaf(engine)
        _, context = engine.service(engine.resolver)
        reader = context.reader(engine.offsets[0])
        plan = leaf.prepare_plan_only(engine.request(aggs=None),
                                      engine.mapper, reader, "s0")
        plan = dataclasses.replace(
            plan, arrays=list(plan.arrays) + [plan.arrays[0]],
            array_keys=list(plan.array_keys) + [plan.array_keys[0]])
        budget = engine.admission.HbmBudget()
        kw = {"device": "cpu"} if engine.name == "torch" else {}
        arrays, admitted, owner = leaf.warmup_device_arrays(
            reader, plan, budget, **kw)
        budget.release(owner, admitted)
        assert arrays[-1] is arrays[0]
        counts[engine.name] = admitted
        unique = sum(arr.nbytes for arr in plan.arrays[:-1])
    assert counts["torch"] == unique
    assert counts["jax"] == unique + plan.arrays[0].nbytes


def engine_leaf(engine: Engine):
    return importlib.import_module(
        engine.service_mod.__name__.rsplit(".", 1)[0] + ".leaf")


@pytest.mark.parametrize("prefetch", [False, True])
def test_an_expired_deadline_fails_every_split_retryably(engines, prefetch):
    """A request whose wire deadline has run out sheds every split as a
    typed, retryable failure before anything is staged, as the JAX
    service does."""
    out = {}
    for engine in engines:
        service, context = engine.service(engine.resolver, prefetch=prefetch)
        staged = engine.counter("STAGING_BYTES_TOTAL")
        response = service.leaf_search(engine.models.LeafSearchRequest(
            search_request=engine.request(), index_uid="res:0",
            doc_mapping=engine.mapper.to_dict(),
            splits=list(engine.offsets), deadline_millis=0))
        assert engine.counter("STAGING_BYTES_TOTAL") == staged
        assert context.hbm_budget.stats()["pinned"] == 0
        out[engine.name] = (response.num_hits, [
            (f.split_id, f.retryable) for f in response.failed_splits])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [(o.split_id, True)
                               for o in engines[1].offsets]

