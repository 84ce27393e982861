"""The port's three leaf-cache tiers behind `SearchService.leaf_search`,
against the JAX package's service.

Tier A memoizes a filter's packed predicate mask, Tier B a split's count
and intermediate aggregation states, Tier C partitions every tier (and the
leaf response cache) by tenant. Each is a pure caching layer: every
response equals the cold baseline (all tiers off) and the JAX service's on
the same split bytes, across repeat queries, eviction pressure, injected
cache faults, threshold pushdown and count downgrades. The claims are
asserted through the counters: a warm mask hit stages zero predicate-column
bytes, and a fully cached dashboard panel runs no device program. The
pattern is the JAX package's `tests/test_hierarchical_cache.py`.

The tiers hold host values only: every value the service puts into a tier
is checked to hold no `torch.Tensor`.
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_residency import (
    AGGS, DOCS_PER_SPLIT, NUM_SPLITS, assert_same_response, corpus_engines,
)


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        yield corpus_engines(mp, "hiercache")


_HOST_LEAVES = (bool, int, float, str, bytes, type(None), np.ndarray,
                np.generic)


@pytest.fixture
def tier_puts(monkeypatch):
    """Every value the port's service puts into a tier, as handed over (a
    response, a packed mask, a count, an aggregation state)."""
    from quickwit_tpu_torch.search import agg_cache, cache, mask_cache
    puts = []

    def recording(cls, name, value_at):
        original = getattr(cls, name)

        def put(self, *args):
            puts.append(args[value_at])
            return original(self, *args)

        monkeypatch.setattr(cls, name, put)

    recording(cache.LeafSearchCache, "put", 1)
    recording(mask_cache.PredicateMaskCache, "put", 2)
    recording(agg_cache.PartialAggCache, "put_count", 2)
    recording(agg_cache.PartialAggCache, "put_agg", 3)
    return puts


def _assert_host_only(value, path="value"):
    """Only Python and numpy values, down to every leaf: no tensor."""
    assert not isinstance(value, torch.Tensor), path
    if isinstance(value, dict):
        for k, v in value.items():
            _assert_host_only(k, f"{path}.key")
            _assert_host_only(v, f"{path}.{k}")
    elif isinstance(value, (list, tuple, set)):
        for i, v in enumerate(value):
            _assert_host_only(v, f"{path}[{i}]")
    elif hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            _assert_host_only(getattr(value, name), f"{path}.{name}")
    else:
        assert isinstance(value, _HOST_LEAVES), (path, type(value))
    if isinstance(value, np.ndarray):
        assert value.dtype != object, path


def _assert_puts_host_only(puts):
    assert puts
    for value in puts:
        _assert_host_only(value)


# --- Tier A: predicate-mask cache ------------------------------------------------


def test_mask_tier_equivalence_and_zero_predicate_staging(engines, tier_puts):
    """A warm mask hit serves every split with ZERO predicate-column bytes
    staged and stays equal to the cold baseline and the JAX service."""
    jax_engine, torch_engine = engines
    masked, context = torch_engine.service(torch_engine.resolver,
                                           enable_agg_cache=False)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_masked, _ = jax_engine.service(jax_engine.resolver,
                                     enable_agg_cache=False)
    first = torch_engine.run(masked, torch_engine.offsets)
    assert_same_response(first, torch_engine.run(cold, torch_engine.offsets))
    assert_same_response(first, jax_engine.run(j_masked, jax_engine.offsets))
    assert context.mask_cache.stats["size_bytes"] > 0
    # a DIFFERENT page size over the same filter: leaf-cache miss, mask hit
    for engine, service in ((torch_engine, masked), (jax_engine, j_masked)):
        hits = engine.counter("MASK_CACHE_HITS_TOTAL")
        pred = engine.counter("PREDICATE_STAGED_BYTES_TOTAL")
        warm = engine.run(service, engine.offsets, engine.request(max_hits=7))
        assert engine.counter("MASK_CACHE_HITS_TOTAL") - hits == NUM_SPLITS
        # not one predicate-column byte staged (the mask slot itself is
        # deliberately not a predicate column)
        assert engine.counter("PREDICATE_STAGED_BYTES_TOTAL") == pred
        if engine is torch_engine:
            t_warm = warm
        else:
            assert_same_response(t_warm, warm)
    assert_same_response(t_warm, torch_engine.run(
        cold, torch_engine.offsets, torch_engine.request(max_hits=7)))
    _assert_puts_host_only(tier_puts)


def test_seeded_mask_is_what_warmup_would_stage(engines):
    """The device copy the fill seeds under `mask.<digest>` has the dtype
    and shape warmup stages for that slot, so a mask hit copies nothing and
    feeds the program the same tensor it would have staged."""
    _, torch_engine = engines
    service, context = torch_engine.service(torch_engine.resolver,
                                            enable_agg_cache=False)
    torch_engine.run(service, torch_engine.offsets[:1])
    cols = context.resident_store.peek("s0")
    seeded = {k: v for k, v in cols._device_array_cache.items()
              if k.startswith("mask.")}
    assert len(seeded) == 1
    (key, dev_packed), = seeded.items()
    leaf = importlib.import_module("quickwit_tpu_torch.search.leaf")
    host = context.mask_cache.get("s0", key[len("mask."):],
                                  dev_packed.numel())
    reader = context.reader(torch_engine.offsets[0])
    plan = leaf.prepare_plan_only(
        torch_engine.request(max_hits=7), torch_engine.mapper, reader, "s0",
        mask_override=host, mask_key=key)
    slot = plan.array_keys.index(key)
    staged, _, _ = leaf.warmup_device_arrays(reader, plan, device="cpu")
    assert (staged[slot].dtype, tuple(staged[slot].shape)) == \
        (dev_packed.dtype, tuple(dev_packed.shape))
    assert torch.equal(staged[slot], dev_packed)
    misses = torch_engine.counter("RESIDENT_COLUMN_MISSES")
    torch_engine.run(service, torch_engine.offsets[:1],
                     torch_engine.request(max_hits=7))
    assert torch_engine.counter("RESIDENT_COLUMN_MISSES") == misses


def test_two_filters_on_one_split_keep_their_own_masks(engines):
    """Two filters on one split served from Tier A in turn: each mask rides
    its own `mask.<digest>` slot (never the lowering's fallback key), and
    each warm response equals its cold run and the JAX service's."""
    jax_engine, torch_engine = engines
    service, context = torch_engine.service(torch_engine.resolver,
                                            enable_agg_cache=False,
                                            leaf_cache_bytes=0)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_service, _ = jax_engine.service(jax_engine.resolver,
                                      enable_agg_cache=False,
                                      leaf_cache_bytes=0)
    offsets = torch_engine.offsets[:1]
    queries = ("body:error", "severity:WARN")
    for query in queries:   # fills both masks
        torch_engine.run(service, offsets, torch_engine.request(query))
    keys = [k for k in context.resident_store.peek("s0")._device_array_cache
            if k.startswith("mask.")]
    assert len(keys) == 2 and "mask.override" not in keys
    for max_hits in (6, 4):
        for query in queries:
            hits = torch_engine.counter("MASK_CACHE_HITS_TOTAL")
            t_req = torch_engine.request(query, max_hits=max_hits)
            got = torch_engine.run(service, offsets, t_req)
            assert torch_engine.counter("MASK_CACHE_HITS_TOTAL") == hits + 1
            assert_same_response(got, torch_engine.run(cold, offsets, t_req))
            assert_same_response(got, jax_engine.run(
                j_service, jax_engine.offsets[:1],
                jax_engine.request(query, max_hits=max_hits)))


def test_mask_ineligible_for_scoring_sorts(engines):
    """_score sorts carry BM25 scores the mask cannot reproduce: the tier
    must never consult or fill, and results must match the cold twin."""
    jax_engine, torch_engine = engines
    masked, context = torch_engine.service(torch_engine.resolver,
                                           enable_agg_cache=False)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_masked, _ = jax_engine.service(jax_engine.resolver,
                                     enable_agg_cache=False)
    request = torch_engine.request(sort=(("_score", "desc"),), aggs=None)
    for _ in range(2):
        got = torch_engine.run(masked, torch_engine.offsets, request)
        assert_same_response(got, torch_engine.run(
            cold, torch_engine.offsets, request))
        assert_same_response(got, jax_engine.run(
            j_masked, jax_engine.offsets,
            jax_engine.request(sort=(("_score", "desc"),), aggs=None)))
    stats = context.mask_cache.stats
    assert stats["hits"] == 0 and stats["misses"] == 0
    assert stats["size_bytes"] == 0


def test_mask_fill_gated_on_impact_truncation(engines):
    """An impact-prefix-truncated plan (count_override set) never saw the
    posting tail — its mask would be incomplete. The fill must skip it."""
    _, torch_engine = engines
    service, context = torch_engine.service(torch_engine.resolver,
                                            enable_agg_cache=False)
    cache_ctx = {"digest": "d" * 32, "mask_fill": True, "agg_hits": {},
                 "agg_fill": []}

    class _Plan:
        count_override = 42  # impact-truncated marker

    service._fill_split_caches(torch_engine.request(),
                               torch_engine.offsets[0], _Plan(), [], None,
                               cache_ctx)
    assert context.mask_cache.stats["size_bytes"] == 0


def test_kill_switches_and_flags(engines, monkeypatch):
    jax_engine, torch_engine = engines
    _, off_ctx = torch_engine.service(torch_engine.resolver,
                                      enable_mask_cache=False,
                                      enable_agg_cache=False)
    assert off_ctx.mask_cache is None and off_ctx.agg_cache is None
    monkeypatch.setenv("QW_DISABLE_MASK_CACHE", "1")
    monkeypatch.setenv("QW_DISABLE_AGG_CACHE", "1")
    killed, killed_ctx = torch_engine.service(torch_engine.resolver)
    j_killed, _ = jax_engine.service(jax_engine.resolver)
    assert killed_ctx.mask_cache is None and killed_ctx.agg_cache is None
    monkeypatch.delenv("QW_DISABLE_MASK_CACHE")
    monkeypatch.delenv("QW_DISABLE_AGG_CACHE")
    live, live_ctx = torch_engine.service(torch_engine.resolver)
    assert live_ctx.mask_cache is not None and live_ctx.agg_cache is not None
    request = torch_engine.request(max_hits=4)
    got = torch_engine.run(live, torch_engine.offsets, request)
    assert_same_response(got, torch_engine.run(killed, torch_engine.offsets,
                                               request))
    assert_same_response(got, jax_engine.run(
        j_killed, jax_engine.offsets, jax_engine.request(max_hits=4)))


@pytest.mark.parametrize("package", ["quickwit_tpu", "quickwit_tpu_torch"])
def test_mask_cache_shape_mismatch_degrades_to_miss(package):
    cache = importlib.import_module(
        f"{package}.search.mask_cache").PredicateMaskCache(1 << 20)
    cache.put("s0", "abc", np.arange(48, dtype=np.uint8))
    got = cache.get("s0", "abc", 48)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    # wrong padded doc space: a miss, never a wrong-shaped array
    assert cache.get("s0", "abc", 64) is None
    assert cache.get("s0", "zzz", 48) is None


# --- Tier B: partial-aggregation cache -------------------------------------------


def test_agg_tier_full_short_circuit_runs_no_program(engines, tier_puts):
    """A dashboard count/agg panel (max_hits=0) whose filter already ran —
    under renamed aggs of the same shape — is assembled from cached
    partials: no device program, no staging, no reader open."""
    jax_engine, torch_engine = engines
    renamed = {f"panel_{k}": dict(v) for k, v in AGGS.items()}
    for engine in (torch_engine, jax_engine):
        service, context = engine.service(engine.resolver,
                                          enable_mask_cache=False)
        engine.run(service, engine.offsets)  # fills count + all agg states
        launches = engine.counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
        staged = engine.counter("STAGING_BYTES_TOTAL")
        agg_hits = engine.counter("AGG_CACHE_HITS_TOTAL")
        served = engine.run(service, engine.offsets,
                            engine.request(max_hits=0, aggs=renamed))
        assert engine.counter("SEARCH_KERNEL_LAUNCHES_TOTAL") == launches
        assert engine.counter("STAGING_BYTES_TOTAL") == staged
        assert engine.counter("AGG_CACHE_HITS_TOTAL") - agg_hits \
            >= NUM_SPLITS
        if engine is torch_engine:
            t_served = served
        else:
            assert_same_response(t_served, served)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    assert_same_response(t_served, torch_engine.run(
        cold, torch_engine.offsets,
        torch_engine.request(max_hits=0, aggs=renamed)))
    _assert_puts_host_only(tier_puts)


def test_agg_partial_hits_merge_with_executed_misses(engines):
    """A panel sharing two cached agg shapes plus one NEW shape lowers only
    the miss; cached states join the executed response before the merge."""
    jax_engine, torch_engine = engines
    mixed = {"sev": AGGS["sev"], "lat": AGGS["lat"],
             "per_min": {"date_histogram": {"field": "ts",
                                            "fixed_interval": "1m"}}}
    service, _ = torch_engine.service(torch_engine.resolver,
                                      enable_mask_cache=False)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_cold, _ = jax_engine.cold_service(jax_engine.resolver)
    torch_engine.run(service, torch_engine.offsets)
    for max_hits in (5, 3):   # the new shape is cached after the first
        t_req = torch_engine.request(max_hits=max_hits, aggs=mixed)
        got = torch_engine.run(service, torch_engine.offsets, t_req)
        assert_same_response(got, torch_engine.run(
            cold, torch_engine.offsets, t_req))
        assert_same_response(got, jax_engine.run(
            j_cold, jax_engine.offsets,
            jax_engine.request(max_hits=max_hits, aggs=mixed)))


def _timed_offsets(engine):
    """The corpus's splits with their time ranges (disjoint per split), so
    threshold pruning can bound them."""
    return [engine.models.SplitIdAndFooter(
        split_id=o.split_id, storage_uri=o.storage_uri,
        file_len=o.file_len, num_docs=o.num_docs,
        time_range=((1_700_000_000 + n * 3600) * 1_000_000,
                    (1_700_000_000 + n * 3600
                     + (DOCS_PER_SPLIT - 1) * 7) * 1_000_000))
        for n, o in enumerate(engine.offsets)]


def test_count_downgrade_served_from_agg_cache(engines):
    """Splits downgraded to count-only (threshold pruning + exact counts)
    reuse the cached per-split count."""
    jax_engine, torch_engine = engines
    offsets = _timed_offsets(torch_engine)
    # the leaf cache off, so that a downgraded split's count is Tier B's
    service, _ = torch_engine.service(torch_engine.resolver,
                                      enable_mask_cache=False,
                                      leaf_cache_bytes=0,
                                      enable_threshold_pruning=True)
    cold, _ = torch_engine.cold_service(torch_engine.resolver,
                                        enable_threshold_pruning=False)
    j_service, _ = jax_engine.service(jax_engine.resolver,
                                      enable_mask_cache=False,
                                      enable_threshold_pruning=True)
    j_offsets = _timed_offsets(jax_engine)
    for max_hits in (3, 2):
        t_req = torch_engine.request(max_hits=max_hits, aggs=None,
                                     count_hits_exact=True)
        agg_hits = torch_engine.counter("AGG_CACHE_HITS_TOTAL")
        got = torch_engine.run(service, offsets, t_req)
        assert got.resource_stats["num_splits_downgraded_to_count"] >= 1
        if max_hits == 2:   # the downgraded splits' counts come from Tier B
            assert torch_engine.counter("AGG_CACHE_HITS_TOTAL") > agg_hits
        assert_same_response(got, torch_engine.run(cold, offsets, t_req))
        want = jax_engine.run(j_service, j_offsets, jax_engine.request(
            max_hits=max_hits, aggs=None, count_hits_exact=True))
        assert_same_response(got, want)
        # the pruning counters agree (elapsed micros do not)
        assert {k: v for k, v in got.resource_stats.items()
                if k != "cpu_micros"} == \
            {k: v for k, v in want.resource_stats.items()
             if k != "cpu_micros"}


# --- threshold pushdown stays uncacheable -------------------------------------


def test_threshold_pushdown_response_never_enters_leaf_cache(engines,
                                                            tier_puts):
    """A pushed-down threshold truncates the hit list below k — correct for
    the carrying query, poison for any future one. The leaf cache must
    refuse it; an unthresholded twin of the same request lands."""
    jax_engine, torch_engine = engines
    service, context = torch_engine.service(torch_engine.resolver,
                                            enable_mask_cache=False,
                                            enable_agg_cache=False)
    j_service, _ = jax_engine.service(jax_engine.resolver,
                                      enable_mask_cache=False,
                                      enable_agg_cache=False)
    request = torch_engine.request(max_hits=3, aggs=None)
    before = context.leaf_cache.stats["size_bytes"]
    got = torch_engine.run(service, torch_engine.offsets[:1], request,
                           threshold=1.7e9 + 500)
    assert context.leaf_cache.stats["size_bytes"] == before
    assert_same_response(got, jax_engine.run(
        j_service, jax_engine.offsets[:1],
        jax_engine.request(max_hits=3, aggs=None), threshold=1.7e9 + 500))
    torch_engine.run(service, torch_engine.offsets[:1], request)
    assert context.leaf_cache.stats["size_bytes"] > before
    _assert_puts_host_only(tier_puts)


def test_leaf_cache_hit_runs_no_program(engines):
    """Tier C: a byte-identical repeat is a leaf-cache hit — no program, no
    staging — and equals the first answer."""
    _, torch_engine = engines
    service, _ = torch_engine.service(torch_engine.resolver)
    first = torch_engine.run(service, torch_engine.offsets)
    launches = torch_engine.counter("SEARCH_KERNEL_LAUNCHES_TOTAL")
    hits = torch_engine.counter("LEAF_CACHE_HITS_TOTAL")
    again = torch_engine.run(service, torch_engine.offsets)
    assert torch_engine.counter("SEARCH_KERNEL_LAUNCHES_TOTAL") == launches
    assert torch_engine.counter("LEAF_CACHE_HITS_TOTAL") - hits == NUM_SPLITS
    assert_same_response(again, first)


# --- eviction pressure and fault storms ----------------------------------------


def test_equivalence_under_eviction_pressure(engines):
    """Cache capacities that fit about one entry force continuous eviction
    in every tier; responses stay identical and evictions are observable."""
    jax_engine, torch_engine = engines
    pressured, context = torch_engine.service(
        torch_engine.resolver, mask_cache_bytes=160, agg_cache_bytes=256,
        leaf_cache_bytes=512)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_cold, _ = jax_engine.cold_service(jax_engine.resolver)
    evicted = torch_engine.counter("MASK_CACHE_EVICTED_BYTES_TOTAL")
    for query in ("body:error", "body:ok", "severity:WARN", "body:error"):
        for max_hits in (10, 7):
            t_req = torch_engine.request(query, max_hits=max_hits)
            got = torch_engine.run(pressured, torch_engine.offsets, t_req)
            assert_same_response(got, torch_engine.run(
                cold, torch_engine.offsets, t_req))
            assert_same_response(got, jax_engine.run(
                j_cold, jax_engine.offsets,
                jax_engine.request(query, max_hits=max_hits)))
    assert torch_engine.counter("MASK_CACHE_EVICTED_BYTES_TOTAL") > evicted
    assert context.mask_cache.stats["size_bytes"] <= 160
    assert context.agg_cache.stats["size_bytes"] <= 256


def test_equivalence_under_cache_fault_storm(engines, tier_puts):
    """`cache.mask_corrupt` poisons every other hit, `cache.evict` storms
    every third put: both degrade to recompute, never to wrong results."""
    jax_engine, torch_engine = engines
    faults = torch_engine.faults
    injector = faults.FaultInjector(seed=5, rules=[
        faults.FaultRule(operation="cache.mask_corrupt", kind="error",
                         every=2),
        faults.FaultRule(operation="cache.evict", kind="error", every=3),
    ])
    chaotic, context = torch_engine.service(torch_engine.resolver,
                                            fault_injector=injector)
    j_cold, _ = jax_engine.cold_service(jax_engine.resolver)
    for query in ("body:error", "severity:WARN"):
        for max_hits in (10, 7, 4):
            got = torch_engine.run(chaotic, torch_engine.offsets,
                                   torch_engine.request(query,
                                                        max_hits=max_hits))
            assert_same_response(got, jax_engine.run(
                j_cold, jax_engine.offsets,
                jax_engine.request(query, max_hits=max_hits)))
    fired = injector.schedule()
    assert "cache.mask_corrupt" in fired and "cache.evict" in fired
    assert context.mask_cache.stats["misses"] > 0
    _assert_puts_host_only(tier_puts)


# --- Tier C: tenant partitioning -------------------------------------------------


@pytest.mark.parametrize("package", ["quickwit_tpu", "quickwit_tpu_torch"])
def test_tenant_quotas_follow_drr_weights(package):
    cache = importlib.import_module(
        f"{package}.search.tenant_cache").TenantPartitionedCache(6000)
    tenancy = importlib.import_module(f"{package}.tenancy.context")
    with tenancy.tenant_scope(tenancy.TenantContext.for_class("acme",
                                                              "standard")):
        cache.put("k1", b"x" * 100)
    assert cache.stats["partitions"]["acme"]["quota_bytes"] == 6000
    with tenancy.tenant_scope(tenancy.TenantContext.for_class(
            "bigco", "interactive")):
        cache.put("k1", b"y" * 100)
    # standard:interactive = 2:4 -> 2000 / 4000
    parts = cache.stats["partitions"]
    assert parts["acme"]["quota_bytes"] == 2000
    assert parts["bigco"]["quota_bytes"] == 4000


@pytest.mark.parametrize("package", ["quickwit_tpu", "quickwit_tpu_torch"])
def test_tenant_storm_cannot_evict_other_tenants_working_set(package):
    cache = importlib.import_module(
        f"{package}.search.tenant_cache").TenantPartitionedCache(4000)
    tenancy = importlib.import_module(f"{package}.tenancy.context")
    acme = tenancy.TenantContext.for_class("acme", "standard")
    bigco = tenancy.TenantContext.for_class("bigco", "standard")
    with tenancy.tenant_scope(acme):
        cache.put("hot", b"a" * 500)
    with tenancy.tenant_scope(bigco):
        for i in range(100):  # far past bigco's 2000-byte quota
            cache.put(f"storm{i}", b"b" * 500)
        assert cache.stats["partitions"]["bigco"]["size_bytes"] <= 2000
    with tenancy.tenant_scope(acme):
        assert cache.get("hot") == b"a" * 500  # untouched by the storm
    with tenancy.tenant_scope(bigco):
        assert cache.get("hot") is None


def test_tenant_partitioned_mask_reuse_is_per_tenant(engines):
    """Two tenants issuing the same filter keep separate mask partitions
    (no cross-tenant cache reads), yet both match the cold baseline and the
    JAX service. A second round is a mask hit in each tenant's own
    partition."""
    jax_engine, torch_engine = engines
    service, context = torch_engine.service(torch_engine.resolver,
                                            enable_agg_cache=False,
                                            leaf_cache_bytes=0)
    cold, _ = torch_engine.cold_service(torch_engine.resolver)
    j_service, _ = jax_engine.service(jax_engine.resolver,
                                      enable_agg_cache=False,
                                      leaf_cache_bytes=0)
    tenancy = torch_engine.tenancy
    j_tenancy = jax_engine.tenancy
    request = torch_engine.request(max_hits=6)
    want = torch_engine.run(cold, torch_engine.offsets, request)
    for round_ in range(2):
        for tenant, klass in (("acme", "standard"), ("bigco", "interactive")):
            hits = torch_engine.counter("MASK_CACHE_HITS_TOTAL")
            with tenancy.tenant_scope(tenancy.TenantContext.for_class(
                    tenant, klass)):
                got = torch_engine.run(service, torch_engine.offsets,
                                       request)
            assert torch_engine.counter("MASK_CACHE_HITS_TOTAL") - hits == \
                (NUM_SPLITS if round_ else 0)
            assert_same_response(got, want)
            with j_tenancy.tenant_scope(j_tenancy.TenantContext.for_class(
                    tenant, klass)):
                assert_same_response(got, jax_engine.run(
                    j_service, jax_engine.offsets,
                    jax_engine.request(max_hits=6)))
    parts = context.mask_cache.stats["partitions"]
    assert set(parts) == {"acme", "bigco"}
    assert parts["acme"]["size_bytes"] > 0
    assert parts["bigco"]["size_bytes"] > 0
