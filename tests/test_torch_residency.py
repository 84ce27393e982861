"""The port's node search service over device-resident columns, against the
JAX package's service.

Each package writes the same three-split corpus with its own `SplitWriter`
(the bytes must be equal) and answers the same `LeafSearchRequest`s through
its own `SearchService` — the port on `device="cpu"`, the JAX package with
`batch_size=1, prefetch=False`. Responses are compared exactly: hits, counts
and every intermediate aggregation state, f64 sums to rtol 1e-12.

The resident column store (`search/residency.py`) is a pure caching layer:
a context with `resident_columns=True` answers like the per-reader staging
baseline across repeat queries, reader reopens and eviction pressure, and a
warm repeat query copies ZERO column bytes
(`qw_resident_staging_cache_hits_total` rises by one per split,
`qw_resident_column_misses_total` by none). The pattern is the JAX
package's `tests/test_resident_engine.py`.

This file also holds the harness the other service test files import
(`Engine`, `corpus_engines`, `assert_same_response`).
"""

import importlib

import numpy as np
import pytest

NUM_SPLITS = 3
DOCS_PER_SPLIT = 300

AGGS = {
    "sev": {"terms": {"field": "severity"}},
    "lat": {"stats": {"field": "latency"}},
    "per_hour": {"date_histogram": {"field": "ts", "fixed_interval": "1h"}},
}

# query name -> builder over an engine's ast module
QUERIES = {
    "body:error": lambda Q: Q.Term("body", "error"),
    "body:ok": lambda Q: Q.Term("body", "ok"),
    "severity:WARN": lambda Q: Q.Term("severity", "WARN"),
}

SUM_KEYS = ("sum", "sum_sq")


class Engine:
    """One package's service stack over its own copy of the corpus."""

    def __init__(self, name: str):
        root = "quickwit_tpu" if name == "jax" else "quickwit_tpu_torch"

        def mod(path):
            return importlib.import_module(f"{root}.{path}")

        self.name = name
        self.Q = mod("query.ast")
        self.models = mod("search.models")
        self.service_mod = mod("search.service")
        self.metrics = mod("observability.metrics")
        self.residency = mod("search.residency")
        self.admission = mod("search.admission")
        self.tenancy = mod("tenancy.context")
        self.faults = mod("common.faults")
        self.uri = mod("common.uri")
        dm = mod("models.doc_mapper")
        self.mapper = dm.DocMapper(
            field_mappings=[
                dm.FieldMapping("body", dm.FieldType.TEXT),
                dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                                input_formats=("unix_timestamp",)),
                dm.FieldMapping("severity", dm.FieldType.TEXT,
                                tokenizer="raw", fast=True),
                dm.FieldMapping("latency", dm.FieldType.F64, fast=True),
            ],
            timestamp_field="ts", default_search_fields=("body",))
        self._writer_cls = mod("index.writer").SplitWriter
        self._storage_mod = mod("storage")

    # --- corpus ---------------------------------------------------------
    def write_corpus(self, name: str, num_splits: int = NUM_SPLITS):
        """The corpus of `tests/test_resident_engine.py`, one split per
        `s<n>`, into a RAM storage; returns (resolver, bytes, offsets)."""
        uri = f"ram:///{name}"
        storage = self._storage_mod.RamStorage(self.uri.Uri.parse(uri))
        rng = np.random.RandomState(7)
        blobs, offsets = [], []
        for n in range(num_splits):
            writer = self._writer_cls(self.mapper)
            for i in range(DOCS_PER_SPLIT):
                writer.add_json_doc({
                    "body": f"log entry {i} "
                            f"{'error' if i % 5 == 0 else 'ok'}",
                    "ts": 1_700_000_000 + n * 3600 + i * 7,
                    "severity": ["INFO", "WARN", "ERROR"][i % 3],
                    "latency": float(rng.gamma(2.0, 50.0)),
                })
            data = writer.finish()
            storage.put(f"s{n}.split", data)
            blobs.append(data)
            offsets.append(self.models.SplitIdAndFooter(
                split_id=f"s{n}", storage_uri=uri, file_len=len(data),
                num_docs=DOCS_PER_SPLIT))
        resolver = self._storage_mod.StorageResolver()
        resolver.register(self.uri.Protocol.RAM, lambda _uri: storage)
        return resolver, blobs, offsets

    # --- service --------------------------------------------------------
    def service(self, resolver, **context_kw):
        context_kw.setdefault("batch_size", 1)
        context_kw.setdefault("prefetch", False)
        if self.name == "torch":
            context_kw.setdefault("device", "cpu")
        context = self.service_mod.SearcherContext(
            storage_resolver=resolver, **context_kw)
        return self.service_mod.SearchService(context), context

    def cold_service(self, resolver, **kw):
        """Baseline twin: per-reader staging and every cache tier off."""
        kw.setdefault("resident_columns", False)
        kw.setdefault("enable_mask_cache", False)
        kw.setdefault("enable_agg_cache", False)
        kw.setdefault("leaf_cache_bytes", 0)
        return self.service(resolver, **kw)

    def request(self, query="body:error", max_hits=10,
                sort=(("ts", "desc"),), aggs=AGGS, **kw):
        build = QUERIES[query] if isinstance(query, str) else query
        return self.models.SearchRequest(
            index_ids=["res"], query_ast=build(self.Q), max_hits=max_hits,
            sort_fields=tuple(self.models.SortField(*s) for s in sort),
            aggs=dict(aggs) if aggs else {}, **kw)

    def run(self, service, offsets, request=None, threshold=None):
        return service.leaf_search(self.models.LeafSearchRequest(
            search_request=request or self.request(), index_uid="res:0",
            doc_mapping=self.mapper.to_dict(), splits=list(offsets),
            sort_value_threshold=threshold))

    def counter(self, name: str) -> float:
        """A counter's value; the JAX package defines the `qw_resident_*`
        family in `search/residency.py`, the port re-exports it there."""
        source = self.residency if hasattr(self.residency, name) \
            else self.metrics
        return getattr(source, name).get()


def corpus_engines(monkeypatch_module, name: str):
    """(jax, torch) engines with their corpora; the two packages' splits
    must be byte-identical, each package's writer on its Python path."""
    from test_torch_indexing import force_python_paths
    force_python_paths(monkeypatch_module)
    out = {}
    for engine_name in ("jax", "torch"):
        engine = Engine(engine_name)
        engine.resolver, engine.blobs, engine.offsets = \
            engine.write_corpus(name)
        out[engine_name] = engine
    assert out["jax"].blobs == out["torch"].blobs
    return out["jax"], out["torch"]


def _hits(resp):
    return [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
             h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits]


def assert_states_close(want, got, path="aggs") -> None:
    """Intermediate aggregation states: f64 sums (and a stats state's sum
    and sum of squares) to rtol 1e-12, everything else exactly."""
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            assert_states_close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_states_close(w, g, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic, float)):
        w, g = np.asarray(want), np.asarray(got)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), path
        close = np.zeros(w.shape, dtype=bool)
        if key in SUM_KEYS:
            close[...] = True
        elif key == "state":          # [count, sum, sum_sq, min, max]
            close[1:3] = True
        if w.dtype.kind == "f":
            exact = (w == g) | (np.isnan(w) & np.isnan(g))
            near = np.isclose(g, w, rtol=1e-12, atol=0, equal_nan=True)
            ok = np.where(close, near, exact)
        else:
            ok = w == g
        assert np.all(ok), f"{path}: {w} vs {g}"
    else:
        assert want == got, path


def assert_same_response(got, want):
    assert got.num_hits == want.num_hits
    assert not got.failed_splits and not want.failed_splits
    assert _hits(got) == _hits(want)
    assert_states_close(want.intermediate_aggs, got.intermediate_aggs)


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        yield corpus_engines(mp, "resident")


def _both(engines, **kw):
    """(torch service, torch context, jax service, jax context)."""
    jax_engine, torch_engine = engines
    t_svc, t_ctx = torch_engine.service(torch_engine.resolver, **kw)
    j_svc, j_ctx = jax_engine.service(jax_engine.resolver, **kw)
    return t_svc, t_ctx, j_svc, j_ctx


# --- resident vs per-reader staging, and against the JAX service -------------


@pytest.mark.parametrize("query", list(QUERIES))
def test_resident_matches_cold_staging(engines, query):
    jax_engine, torch_engine = engines
    resident, _, j_resident, _ = _both(engines, resident_columns=True)
    cold, _ = torch_engine.service(torch_engine.resolver,
                                   resident_columns=False)
    t_req, j_req = torch_engine.request(query), jax_engine.request(query)
    got = torch_engine.run(resident, torch_engine.offsets, t_req)
    assert got.num_hits > 0
    assert_same_response(got, torch_engine.run(cold, torch_engine.offsets,
                                               t_req))
    assert_same_response(got, jax_engine.run(j_resident, jax_engine.offsets,
                                             j_req))


@pytest.mark.parametrize("max_open_splits", [128, 1],
                         ids=["warm_repeat", "reader_reopen"])
def test_warm_repeat_stages_zero_columns(engines, max_open_splits):
    """A repeat query at another page size (a leaf-cache miss over the same
    columns) is a full resident hit in every split — zero columns copied —
    in both packages, also when a one-slot reader LRU reopens every split's
    reader between the queries (residency keys on the split id)."""
    jax_engine, torch_engine = engines
    t_svc, t_ctx, j_svc, _ = _both(engines, resident_columns=True,
                                   max_open_splits=max_open_splits)
    cold, _ = torch_engine.service(torch_engine.resolver,
                                   resident_columns=False,
                                   max_open_splits=max_open_splits)
    for engine, svc in ((torch_engine, t_svc), (jax_engine, j_svc)):
        first = engine.run(svc, engine.offsets)
        # a bit-identical repeat is a leaf-cache hit: no warmup at all
        assert_same_response(engine.run(svc, engine.offsets), first)
    warm = {}
    for engine, svc in ((torch_engine, t_svc), (jax_engine, j_svc)):
        hits = engine.counter("RESIDENT_STAGING_CACHE_HITS")
        misses = engine.counter("RESIDENT_COLUMN_MISSES")
        warm[engine.name] = engine.run(svc, engine.offsets,
                                       engine.request(max_hits=7))
        assert engine.counter("RESIDENT_STAGING_CACHE_HITS") - hits \
            == NUM_SPLITS, engine.name
        assert engine.counter("RESIDENT_COLUMN_MISSES") - misses == 0, \
            engine.name
    assert_same_response(warm["torch"], warm["jax"])
    assert_same_response(warm["torch"], torch_engine.run(
        cold, torch_engine.offsets, torch_engine.request(max_hits=7)))
    stats = t_ctx.resident_store.stats()
    assert stats["splits"] == NUM_SPLITS and stats["bytes"] > 0


def test_resident_bytes_are_the_staged_bytes(engines):
    """The store's bytes per split are what the warmups staged, and they
    equal the budget's resident bytes (the mask tier's seeded copy rides
    outside admission by design, so its tier is off here)."""
    jax_engine, torch_engine = engines
    t_svc, t_ctx, j_svc, j_ctx = _both(engines, enable_mask_cache=False)
    torch_engine.run(t_svc, torch_engine.offsets[:1])
    jax_engine.run(j_svc, jax_engine.offsets[:1])
    t_stats = t_ctx.resident_store.stats()
    assert t_stats["bytes"] == t_ctx.hbm_budget.stats()["resident"] > 0
    # no array key repeats across this plan's slots, so the port's bytes
    # (each key once) are the JAX package's (each slot)
    assert t_stats == j_ctx.resident_store.stats()


def test_equivalence_under_eviction_pressure(engines):
    """A budget of 1.5 splits forces LRU eviction of resident columns
    mid-request; results stay identical to the unpressured JAX service and
    to the per-reader baseline, and evictions are observable."""
    jax_engine, torch_engine = engines
    probe, probe_ctx = torch_engine.service(torch_engine.resolver)
    torch_engine.run(probe, torch_engine.offsets[:1])
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    assert per_split > 0

    cold, _ = torch_engine.service(torch_engine.resolver,
                                   resident_columns=False)
    j_plain, _ = jax_engine.service(jax_engine.resolver)
    pressured, context = torch_engine.service(torch_engine.resolver)
    j_pressured, j_context = jax_engine.service(jax_engine.resolver)
    context.hbm_budget = torch_engine.admission.HbmBudget(
        budget_bytes=int(per_split * 1.5))
    j_context.hbm_budget = jax_engine.admission.HbmBudget(
        budget_bytes=int(per_split * 1.5))
    evictions = {e.name: e.counter("RESIDENT_EVICTIONS")
                 for e in (jax_engine, torch_engine)}
    for max_hits in (10, 7):  # two passes: warm hits AND evictions
        t_req = torch_engine.request(max_hits=max_hits)
        j_req = jax_engine.request(max_hits=max_hits)
        got = torch_engine.run(pressured, torch_engine.offsets, t_req)
        assert_same_response(got, jax_engine.run(j_plain, jax_engine.offsets,
                                                 j_req))
        assert_same_response(got, jax_engine.run(
            j_pressured, jax_engine.offsets, j_req))
        assert_same_response(got, torch_engine.run(
            cold, torch_engine.offsets, t_req))
    for engine in (jax_engine, torch_engine):
        assert engine.counter("RESIDENT_EVICTIONS") - evictions[engine.name] \
            > 0, engine.name
    # accounting stayed consistent: never more resident than the budget
    assert context.hbm_budget.stats()["resident"] <= per_split * 1.5
    assert context.resident_store.stats()["bytes"] >= 0
    assert context.hbm_budget.stats()["pinned"] == 0


def test_eviction_fault_is_absorbed(engines):
    """`residency.evict` faults fire inside the eviction notification and
    are absorbed: queries under pressure still answer like the baseline."""
    jax_engine, torch_engine = engines
    injector = torch_engine.faults.FaultInjector(seed=3, rules=[
        torch_engine.faults.FaultRule(operation="residency.evict",
                                      kind="error")])
    probe, probe_ctx = torch_engine.service(torch_engine.resolver)
    torch_engine.run(probe, torch_engine.offsets[:1])
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    chaotic, context = torch_engine.service(
        torch_engine.resolver, fault_injector=injector,
        enable_mask_cache=False, leaf_cache_bytes=0)
    context.hbm_budget = torch_engine.admission.HbmBudget(
        budget_bytes=int(per_split * 1.5))
    j_plain, _ = jax_engine.service(jax_engine.resolver)
    for _ in range(2):
        assert_same_response(
            torch_engine.run(chaotic, torch_engine.offsets),
            jax_engine.run(j_plain, jax_engine.offsets))
    assert injector.occurrences("residency.evict") > 0


def test_pruning_pushdown_equivalence_resident(engines):
    """Dynamic top-K pruning composes with residency: pruned resident ==
    unpruned per-reader == the JAX service, and a warm follow-up page
    copies no column."""
    jax_engine, torch_engine = engines
    pruned, _ = torch_engine.service(torch_engine.resolver,
                                     enable_threshold_pruning=True)
    cold, _ = torch_engine.service(torch_engine.resolver,
                                   resident_columns=False,
                                   enable_threshold_pruning=False)
    j_pruned, _ = jax_engine.service(jax_engine.resolver,
                                     enable_threshold_pruning=True)
    for max_hits in (3, 2):
        t_req = torch_engine.request(max_hits=max_hits)
        misses = torch_engine.counter("RESIDENT_COLUMN_MISSES")
        got = torch_engine.run(pruned, torch_engine.offsets, t_req)
        if max_hits == 2:
            assert torch_engine.counter("RESIDENT_COLUMN_MISSES") == misses
        assert_same_response(got, torch_engine.run(
            cold, torch_engine.offsets, t_req))
        assert_same_response(got, jax_engine.run(
            j_pruned, jax_engine.offsets, jax_engine.request(
                max_hits=max_hits)))
