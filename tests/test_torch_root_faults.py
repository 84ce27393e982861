"""The port's root under faults, against the JAX package's root.

The pattern of `tests/test_chaos_search.py` and `tests/test_query_profile.py`
over the corpus and harness of `tests/test_torch_root.py`: each package's
root runs the same request over the same split bytes with the same seeded
fault plan (`common/faults.py`), and the two outcomes must agree — the
response (minus `elapsed_time_micros`), the retry counters, the fault
schedule. Covered: a leaf retried on another node, the per-query retry
pool, the fetch-docs replica retry, deadline partials (with the port's
admission pins released after an abandoned dispatch), cancel through
`CANCEL_REGISTRY`, `FaultyMetastore`, tenant rate limiting, the slow-query
log and the SLO tracker. The nodes run the per-split route (`batch_size=1`,
no prefetch), as the chaos suite's do, so that storage faults fire at the
same reads in both packages.
"""

import threading
import time

import pytest

from test_torch_root import assert_same_search, root_engines

pytestmark = pytest.mark.chaos

# thread joins and partial-response assembly on top of a deadline
DEADLINE_SLACK_SECS = 1.6
ERROR_DOCS = 200      # severity ERROR: every third doc of 600


@pytest.fixture(scope="module")
def engines():
    mp = pytest.MonkeyPatch()
    try:
        yield root_engines(mp, num_nodes=1)
    finally:
        mp.undo()


def cluster(engine, num_nodes=3, client_rules=None, storage_rules=None,
            seed=5, **kw):
    """A fresh cluster over the engine's corpus (no cache state crosses
    tests): (root, services, client injector, storage injector)."""
    f = engine.faults
    clients = (f.FaultInjector(seed=seed, rules=[
        f.FaultRule(*r[:2], **r[2]) for r in client_rules])
        if client_rules else None)
    storage = (f.FaultInjector(seed=seed, rules=[
        f.FaultRule(*r[:2], **r[2]) for r in storage_rules])
        if storage_rules else None)
    resolver = (f.FaultyStorageResolver(engine.resolver, storage)
                if storage is not None else engine.resolver)
    wrap = ((lambda node_id, client: f.FaultyClient(client, clients,
                                                    node_id))
            if clients is not None else None)
    kw.setdefault("batch_size", 1)
    kw.setdefault("prefetch", False)
    root, services = engine.cluster(resolver, engine.metastore, num_nodes,
                                    wrap=wrap, **kw)
    return root, services, clients, storage


def term_request(engine, **kw):
    return engine.request("severity:ERROR", sort=(("ts", "desc"),), **kw)


def run_both(engines, make_root, make_request, counters=()):
    """Each package's outcome: (response, counter deltas, root)."""
    out = {}
    for engine in engines:
        root = make_root(engine)
        before = {c: engine.counter(c) for c in counters}
        response = root.search(make_request(engine))
        out[engine.name] = (response, {c: engine.counter(c) - before[c]
                                       for c in counters}, root)
    return out


def failure_view(response):
    return (response.num_hits, getattr(response, "timed_out", None),
            getattr(response, "cancelled", None),
            sorted((e.split_id, e.error, e.retryable)
                   for e in response.failed_splits))


def deadline_verdict(response):
    """What a timed-out response must show whatever the thread timing:
    where each split was shed (at the leaf, at the dispatch or at the
    root's join) depends on it, so not the error strings."""
    return (response.timed_out, response.num_hits,
            sorted(e.split_id for e in response.failed_splits),
            all("deadline exceeded" in e.error
                for e in response.failed_splits))


def wait_for_fanout_threads(timeout=10.0):
    """An abandoned dispatch finishes on its daemon thread after the root
    answered: wait for every `root-fanout-*` thread to end."""
    end = time.monotonic() + timeout
    for thread in threading.enumerate():
        if thread.name.startswith("root-fanout-"):
            thread.join(max(end - time.monotonic(), 0.0))
            assert not thread.is_alive(), thread.name


# --------------------------------------------------------------------------
# retries

@pytest.mark.parametrize("max_fires", [1, None])
def test_leaf_retry_on_another_node(engines, max_fires):
    """node-0 fails its first leaf call (or every one): its splits are
    retried on the next node by rendezvous, and the response equals the
    fault-free one."""
    rule = {"max_fires": max_fires} if max_fires else {}
    out = run_both(
        engines,
        lambda e: cluster(e, client_rules=[
            ("client.leaf_search@node-0", "error", rule)])[0],
        lambda e: term_request(e, max_hits=10,
                               aggs={"sev": {"terms": {"field": "severity"}}}),
        counters=("SEARCH_LEAF_RETRIES_TOTAL",))
    clean = {e.name: cluster(e)[0].search(term_request(
        e, max_hits=10, aggs={"sev": {"terms": {"field": "severity"}}}))
        for e in engines}
    got, got_counts, _ = out["torch"]
    want, want_counts, _ = out["jax"]
    assert_same_search(got, want, batch_route=False)
    assert_same_search(got, clean["torch"], batch_route=False)
    assert_same_search(clean["torch"], clean["jax"], batch_route=False)
    assert got.num_hits == ERROR_DOCS and not got.failed_splits
    assert got_counts == want_counts == {"SEARCH_LEAF_RETRIES_TOTAL": 1.0}


def test_retry_pool_drained_reports_every_failed_split(engines):
    """A root whose retry pool is empty answers with node-0's splits as
    failed (typed, never dropped) in both packages."""
    def make_root(engine):
        root = cluster(engine, client_rules=[
            ("client.leaf_search@node-0", "error", {})])[0]
        root.MAX_RETRIES_PER_QUERY = 0
        return root

    out = run_both(engines, make_root, lambda e: term_request(e, max_hits=5),
                   counters=("SEARCH_LEAF_RETRIES_TOTAL",))
    got, got_counts, _ = out["torch"]
    want, want_counts, _ = out["jax"]
    assert failure_view(got) == failure_view(want)
    assert_same_search(got, want, batch_route=False)
    assert got.failed_splits and all("injected fault" in e.error
                                     for e in got.failed_splits)
    assert (got.num_successful_splits + len(got.failed_splits)
            == got.num_attempted_splits == 6)
    assert got_counts == want_counts == {"SEARCH_LEAF_RETRIES_TOTAL": 0.0}


class DeadClient:
    def leaf_search(self, request):
        raise RuntimeError("node unreachable")


@pytest.mark.parametrize("nodes", [["node-0"], ["node-0", "node-1"]])
def test_dead_nodes_report_failed_splits(engines, nodes):
    """No retry node, or a retry that fails too: every split of the
    request is reported with the error, in both packages."""
    views = {}
    for engine in engines:
        root = engine.root_mod.RootSearcher(
            engine.metastore, {n: DeadClient() for n in nodes})
        leaf_request = engine.models.LeafSearchRequest(
            search_request=term_request(engine, max_hits=3),
            index_uid="logs:01", doc_mapping=engine.mapper.to_dict(),
            splits=[engine.models.SplitIdAndFooter(split_id=s,
                                                   storage_uri="ram:///x")
                    for s in ("s1", "s2", "s3")])
        response = root._leaf_search_with_retry(leaf_request, "node-0",
                                                nodes)
        views[engine.name] = (response.num_attempted_splits,
                              failure_view(response))
    assert views["torch"] == views["jax"]
    assert views["torch"][0] == 3 and len(views["torch"][1][3]) == 3


class FlakyFetchClient:
    """Counts fetch_docs per node and fails on the nodes in `fail`."""

    def __init__(self, inner, node_id, fail, calls):
        self._inner, self.node_id = inner, node_id
        self._fail, self._calls = fail, calls

    def fetch_docs(self, request):
        self._calls[self.node_id] = self._calls.get(self.node_id, 0) + 1
        if self.node_id in self._fail:
            raise RuntimeError("injected fetch_docs failure")
        return self._inner.fetch_docs(request)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("down", ["preferred", "all"])
def test_fetch_docs_retries_one_replica(engines, down):
    """The top split's preferred replica (or every node) drops phase-2
    fetches: one retry on the next replica fills the page (or the page is
    empty with the phase-1 counts kept), in both packages."""
    outs = {}
    for engine in engines:
        fail, calls = set(), {}
        root, _ = engine.cluster(
            engine.resolver, engine.metastore, 3,
            wrap=lambda node_id, client, fail=fail, calls=calls:
            FlakyFetchClient(client, node_id, fail, calls))
        splits = engine.metastore.list_splits(
            engine.metastore_mod.ListSplitsQuery(index_uids=["logs:01"]))
        top = max(splits, key=lambda s: s.metadata.time_range_end)
        placer = __import__(engine.root_mod.__name__.rsplit(".", 1)[0]
                            + ".placer", fromlist=["nodes_for_split"])
        preference = placer.nodes_for_split(top.metadata.split_id,
                                            sorted(root.clients))
        fail.update(preference[:1] if down == "preferred" else root.clients)
        before = engine.counter("SEARCH_FETCH_DOCS_RETRIES_TOTAL")
        response = root.search(term_request(engine, max_hits=5))
        outs[engine.name] = (
            response,
            engine.counter("SEARCH_FETCH_DOCS_RETRIES_TOTAL") - before,
            calls, preference)
    got, retries, calls, preference = outs["torch"]
    want, want_retries, want_calls, _ = outs["jax"]
    assert_same_search(got, want, batch_route=False)
    assert retries == want_retries == 1.0
    assert calls == want_calls
    assert got.num_hits == ERROR_DOCS
    if down == "preferred":
        assert len(got.hits) == 5
        assert calls == {preference[0]: 1, preference[1]: 1}
    else:
        assert got.hits == [] and sum(calls.values()) == 2


# --------------------------------------------------------------------------
# storage faults and schedules

def test_storage_errors_surface_as_the_same_failed_splits(engines):
    """Seeded storage errors on one node fail the same splits with the
    same errors, and the injectors record the same schedule."""
    storage_rules = [
        ("storage.get_slice", "error", {"every": 3, "max_fires": 2}),
        ("storage.get_slice", "latency", {"every": 7,
                                          "latency_secs": 0.01}),
    ]
    outs = {}
    for engine in engines:
        root, _, _, injector = cluster(engine, num_nodes=1, seed=11,
                                       storage_rules=storage_rules)
        response = root.search(term_request(engine, max_hits=5,
                                            timeout_millis=20_000))
        outs[engine.name] = (response, injector.schedule())
    got, got_schedule = outs["torch"]
    want, want_schedule = outs["jax"]
    assert failure_view(got) == failure_view(want)
    assert_same_search(got, want, batch_route=False)
    assert got_schedule == want_schedule and got_schedule
    assert len(got.failed_splits) == 2
    assert got.num_successful_splits == 4


# --------------------------------------------------------------------------
# deadlines and cancellation

def test_leaf_hang_returns_timed_out_partial(engines):
    """Every leaf call hangs 3 s against a 0.4 s budget: a timed-out
    partial response within the slack, the same in both packages."""
    outs = {}
    for engine in engines:
        root = cluster(engine, client_rules=[
            ("client.leaf_search@*", "hang", {"hang_secs": 3.0})], seed=21)[0]
        t0 = time.monotonic()
        response = root.search(term_request(engine, max_hits=5,
                                            timeout_millis=400))
        assert time.monotonic() - t0 < 0.4 + DEADLINE_SLACK_SECS
        outs[engine.name] = response
    got, want = outs["torch"], outs["jax"]
    assert deadline_verdict(got) == deadline_verdict(want)
    assert got.timed_out and got.to_dict()["timed_out"] is True
    assert got.failed_splits and deadline_verdict(got)[3]


def test_storage_hang_partial_releases_admission_pins(engines):
    """Slow storage inside the leaf against a 0.3 s budget: the root answers
    timed out on time; the abandoned dispatch finishes in the background
    and the port's node leaves no admission pin behind."""
    _, torch_engine = engines
    outs = {}
    for engine in engines:
        root, services, _, _ = cluster(
            engine, num_nodes=1, seed=8, storage_rules=[
                ("storage.get_slice", "hang", {"hang_secs": 0.5})])
        t0 = time.monotonic()
        response = root.search(term_request(engine, max_hits=5,
                                            timeout_millis=300))
        assert time.monotonic() - t0 < 0.3 + DEADLINE_SLACK_SECS
        outs[engine.name] = (response, services)
    wait_for_fanout_threads()
    got, services = outs["torch"]
    assert got.timed_out and got.failed_splits
    assert outs["jax"][0].timed_out
    for service in services.values():
        assert service.context.hbm_budget.stats()["pinned"] == 0


def test_expired_budget_sheds_every_split(engines):
    """A budget that runs out as the fan-out starts: every split is shed
    with a typed deadline error, in both packages."""
    out = run_both(engines, lambda e: cluster(e, num_nodes=2)[0],
                   lambda e: term_request(e, max_hits=5, timeout_millis=1))
    got, want = out["torch"][0], out["jax"][0]
    assert deadline_verdict(got) == deadline_verdict(want)
    assert deadline_verdict(got)[:2] == (True, 0) and deadline_verdict(got)[3]
    assert len(got.failed_splits) == 6


@pytest.mark.parametrize("raced", [True, False])
def test_cancel_through_the_registry(engines, raced):
    """A query whose id was cancelled before it started (a DELETE racing
    ahead of its query) answers cancelled; a live registration is removed
    when the query ends. Both packages answer alike."""
    outs = {}
    for engine in engines:
        registry = engine.cancel.CANCEL_REGISTRY
        query_id = f"q-cancel-{raced}"
        token = engine.deadline.CancellationToken()
        if raced:
            registry.register(query_id, token)
            assert registry.cancel(query_id)
        root = cluster(engine, num_nodes=2)[0]
        response = root.search(term_request(engine, max_hits=5,
                                            query_id=query_id))
        registry.unregister(query_id, token)
        outs[engine.name] = (response, registry.get(query_id))
    got, left = outs["torch"]
    want, _ = outs["jax"]
    assert left is None
    assert failure_view(got) == failure_view(want)
    assert_same_search(got, want, batch_route=False)
    assert got.cancelled == raced
    if raced:
        assert got.failed_splits and not any(e.retryable
                                             for e in got.failed_splits)
    else:
        assert got.num_hits == ERROR_DOCS


# --------------------------------------------------------------------------
# the metastore

def test_metastore_error_is_typed(engines):
    for engine in engines:
        f = engine.faults
        root = cluster(engine, num_nodes=1)[0]
        root.metastore = f.FaultyMetastore(root.metastore, f.FaultInjector(
            seed=13, rules=[f.FaultRule("metastore.list_splits", "error")]))
        with pytest.raises(engine.metastore_mod.MetastoreError,
                           match="injected fault"):
            root.search(term_request(engine, max_hits=5,
                                     timeout_millis=20_000))


def test_slow_metastore_sheds_the_fan_out(engines):
    outs = {}
    for engine in engines:
        f = engine.faults
        injector = f.FaultInjector(seed=13, rules=[
            f.FaultRule("metastore.list_splits", "hang", hang_secs=1.0)])
        root = cluster(engine, num_nodes=2)[0]
        root.metastore = f.FaultyMetastore(root.metastore, injector)
        t0 = time.monotonic()
        response = root.search(term_request(engine, max_hits=5,
                                            timeout_millis=400))
        assert time.monotonic() - t0 < 1.0 + DEADLINE_SLACK_SECS
        assert injector.occurrences("metastore.list_splits") == 1
        outs[engine.name] = response
    got, want = outs["torch"], outs["jax"]
    assert deadline_verdict(got) == deadline_verdict(want)
    assert got.timed_out and len(got.failed_splits) == 6
    assert deadline_verdict(got)[3]


# --------------------------------------------------------------------------
# tenancy, slow-query log and SLO

def test_tenant_rate_limit_rejects_at_the_root(engines):
    """A tenant over its QPS bucket is rejected before any metastore work,
    with the same Retry-After verdict in both packages."""
    verdicts = {}
    for engine in engines:
        registry = engine.tenancy_reg.GLOBAL_TENANCY
        registry.configure({"tenants": {"acme": {"qps_limit": 2}}})
        # the QPS bucket refills on the clock seam: a frozen clock makes
        # the verdict independent of how long the two queries take
        clock = engine.clock.use_clock(engine.clock.FakeClock())
        clock.__enter__()
        try:
            tenant = registry.resolve("acme")
            root = cluster(engine, num_nodes=1)[0]
            with engine.tenancy_ctx.tenant_scope(tenant):
                answered = [root.search(term_request(engine, max_hits=2))
                            .num_hits for _ in range(2)]
                with pytest.raises(engine.tenancy_reg.TenantRateLimited) \
                        as exc:
                    root.search(term_request(engine, max_hits=2))
            report = registry.report()
        finally:
            clock.__exit__(None, None, None)
            registry.configure(None)
        verdicts[engine.name] = (answered, exc.value.limit,
                                 exc.value.tenant_id,
                                 {k: v for k, v in report["tenants"]["acme"]
                                  ["counters"].items()
                                  if not k.endswith("_seconds")})
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"][:3] == ([ERROR_DOCS] * 2, "qps", "acme")


def test_slow_query_log_and_slo(engines):
    """An armed slow-query log profiles every query and records it with its
    waterfall; the SLO tracker judges each query against its class. Both
    packages record the same entry shape and the same verdicts."""
    seen = {}
    for engine in engines:
        log = engine.slowlog.SLOW_QUERY_LOG
        slo = engine.slo.SLO_TRACKER
        log.clear()
        log.configure(0.0)
        slo.reset()
        before = (engine.counter("SEARCH_SLOWLOG_RECORDED_TOTAL"),
                  engine.counter("SEARCH_PROFILED_QUERIES_TOTAL"))
        try:
            root = cluster(engine, num_nodes=2)[0]
            response = root.search(term_request(engine, max_hits=3))
            timed = root.search(term_request(engine, max_hits=3,
                                             timeout_millis=1))
            entries = log.entries()
            report = slo.report()
        finally:
            log.configure(None)
            log.clear()
            slo.reset()
        seen[engine.name] = (
            response.profile is None, timed.timed_out,
            [(e["indexes"], e["timed_out"], sorted(e),
              {"execute" if p["name"] == "compile" else p["name"]
               for p in e["profile"]["phases"]},
              e["profile"].get("partial") is None) for e in entries],
            engine.counter("SEARCH_SLOWLOG_RECORDED_TOTAL") - before[0],
            engine.counter("SEARCH_PROFILED_QUERIES_TOTAL") - before[1],
            {cls: (v["window_total"], v["window_breached"])
             for cls, v in report["classes"].items()})
    assert seen["torch"] == seen["jax"]
    no_profile, timed_out, entries, recorded, profiled, classes = \
        seen["torch"]
    assert no_profile and timed_out and len(entries) == 2
    assert recorded == profiled == 2
    assert classes["standard"] == (2.0, 1.0)
