"""The port's root search against the JAX package's.

`tests/test_distributed_search.py`'s three-node cluster, built in both
packages over the same split bytes and the same metastore content: each
package writes the splits with its own `SplitWriter` (the JAX native text
builder off; the bytes must be equal), stages and publishes them in its own
`FileBackedMetastore` under a `FakeClock` and a seeded RNG (the metastore
files must be equal), and answers the same requests through its own
`RootSearcher` over three `LocalSearchClient`s, the port's contexts on
`device="cpu"`. Every `SearchResponse.to_dict()` must be equal, minus
`elapsed_time_micros`, with each hit's split, doc id, score and sort
values; aggregation floats are held to rtol 1e-12 (f64 sums), everything
else exactly.

Covered: term, scored and paged (`start_offset`) searches, Bool + range
sorted by timestamp and its `search_after` page, two-key and text-field
sorts, every aggregation kind, snippets, tag pruning, zonemap pruning
(`tests/test_zonemap_pruning.py`), time-range pruning down to no split at
all (`_fill_empty_aggs`), index patterns, query strings and ES-DSL bodies,
profiles (structure and counters; the reader's storage attribution) and
`list_fields` / `root_list_terms`.

This file also holds the harness `tests/test_torch_root_faults.py` imports
(`RootEngine`, `root_engines`, `assert_same_search`).
"""

import importlib
import random

import numpy as np
import pytest

NUM_SPLITS = 6
DOCS_PER_SPLIT = 100
SPLIT_URI = "ram:///root/splits"
OTHER_URI = "ram:///root/other"
T0 = 1_600_000_000
SEED = 11

AGGS = {
    "sev": {"terms": {"field": "severity"}},
    "lat": {"stats": {"field": "latency"}},
    "lat_pct": {"percentiles": {"field": "latency",
                                "percents": [50, 95, 99]}},
    "tenants": {"cardinality": {"field": "tenant"}},
    "per_min": {"date_histogram": {"field": "ts", "fixed_interval": "1m"},
                "aggs": {"avg_lat": {"avg": {"field": "latency"}}}},
    "lat_ranges": {"range": {"field": "latency",
                             "ranges": [{"to": 50.0}, {"from": 50.0,
                                                       "to": 150.0},
                                        {"from": 150.0}]}},
    "status_hist": {"histogram": {"field": "status", "interval": 100}},
}


def make_docs(split: int, rng: np.random.RandomState) -> list[dict]:
    """One split's documents: one tenant (a tag) per split, its own band
    of status codes (a zonemap bound), a minute of timestamps."""
    docs = []
    for i in range(DOCS_PER_SPLIT):
        g = split * DOCS_PER_SPLIT + i
        docs.append({
            "ts": T0 + g,
            "body": f"event {g} common word{g % 7}"
                    + (" error disk full" if g % 5 == 0 else " ok"),
            "tenant": split % 3,
            "severity": ["INFO", "ERROR", "WARN"][g % 3],
            "status": 200 + 100 * (split % 4) + g % 5,
            "latency": float(np.round(rng.gamma(2.0, 50.0), 3)),
        })
    return docs


class RootEngine:
    """One package's root, metastore and nodes over its own copy of the
    corpus."""

    def __init__(self, name: str):
        root = "quickwit_tpu" if name == "jax" else "quickwit_tpu_torch"

        def mod(path):
            return importlib.import_module(f"{root}.{path}")

        self.name = name
        self.Q = mod("query.ast")
        self.query = mod("query")
        self.es_dsl = mod("query.es_dsl")
        self.models = mod("search.models")
        self.root_mod = mod("search.root")
        self.service_mod = mod("search.service")
        self.list_apis = mod("search.list_apis")
        self.metastore_mod = mod("metastore")
        self.split_md = mod("models.split_metadata")
        self.index_md = mod("models.index_metadata")
        self.clock = mod("common.clock")
        self.faults = mod("common.faults")
        self.deadline = mod("common.deadline")
        self.metrics = mod("observability.metrics")
        self.slowlog = mod("observability.slowlog")
        self.slo = mod("observability.slo")
        self.cancel = mod("search.cancel")
        self.tenancy_ctx = mod("tenancy.context")
        self.tenancy_reg = mod("tenancy.registry")
        self.storage_mod = mod("storage")
        dm = mod("models.doc_mapper")
        self.mapper = dm.DocMapper(
            field_mappings=[
                dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                                input_formats=("unix_timestamp",)),
                dm.FieldMapping("body", dm.FieldType.TEXT, record="position"),
                dm.FieldMapping("tenant", dm.FieldType.U64, fast=True),
                dm.FieldMapping("severity", dm.FieldType.TEXT,
                                tokenizer="raw", fast=True),
                dm.FieldMapping("status", dm.FieldType.U64, fast=True),
                dm.FieldMapping("latency", dm.FieldType.F64, fast=True),
            ],
            timestamp_field="ts", tag_fields=("tenant",),
            default_search_fields=("body",))
        self._writer_cls = mod("index.writer").SplitWriter

    # --- corpus and metastore ------------------------------------------
    def populate(self):
        """Write the corpus and publish it, under a FakeClock and a seeded
        RNG (split ids and timestamps come from those seams). Returns
        (resolver, metastore, split bytes, metastore files)."""
        resolver = self.storage_mod.StorageResolver.for_test()
        meta_storage = resolver.resolve("ram:///root/metastore")
        blobs = []
        with self.clock.use_clock(self.clock.FakeClock()), \
                self.clock.use_rng(random.Random(SEED)):
            metastore = self.metastore_mod.FileBackedMetastore(meta_storage)
            rng = np.random.RandomState(SEED)
            for index_id, uri, splits in (("logs", SPLIT_URI, NUM_SPLITS),
                                          ("logs-b", OTHER_URI, 2)):
                index_uid = f"{index_id}:01"
                metastore.create_index(self.index_md.IndexMetadata(
                    index_uid=index_uid,
                    index_config=self.index_md.IndexConfig(
                        index_id=index_id, index_uri=uri,
                        doc_mapper=self.mapper),
                    sources={"src": self.index_md.SourceConfig("src",
                                                               "vec")}))
                storage = resolver.resolve(uri)
                staged = []
                for n in range(splits):
                    writer = self._writer_cls(self.mapper)
                    for doc in make_docs(n, rng):
                        writer.add_json_doc(doc)
                    data = writer.finish()
                    metadata = self.split_md.SplitMetadata(
                        split_id=self.split_md.new_split_id(),
                        index_uid=index_uid, source_id="src",
                        num_docs=writer.num_docs,
                        uncompressed_docs_size_bytes=(
                            writer._uncompressed_docs_size),
                        footprint_bytes=len(data),
                        time_range_start=writer._time_min,
                        time_range_end=writer._time_max,
                        tags=frozenset(writer.tags),
                        create_timestamp=int(self.clock.wall_time()),
                        column_bounds=dict(writer.column_bounds))
                    storage.put(f"{metadata.split_id}.split", data)
                    blobs.append(data)
                    staged.append(metadata)
                metastore.stage_splits(index_uid, staged)
                metastore.publish_splits(
                    index_uid, [m.split_id for m in staged],
                    source_id="src")
        files = {path: meta_storage.get_all(path)
                 for path in sorted(meta_storage.list_files())}
        return resolver, metastore, blobs, files

    # --- nodes and root -------------------------------------------------
    def context(self, resolver, **kw):
        if self.name == "torch":
            kw.setdefault("device", "cpu")
        return self.service_mod.SearcherContext(storage_resolver=resolver,
                                                **kw)

    def cluster(self, resolver, metastore, num_nodes=3, wrap=None, **kw):
        """(root, {node_id: service}); `wrap(node_id, client)` may replace
        a node's client (a FaultyClient)."""
        services = {f"node-{i}": self.service_mod.SearchService(
            self.context(resolver, **kw), node_id=f"node-{i}")
            for i in range(num_nodes)}
        clients = {}
        for node_id, service in services.items():
            client = self.service_mod.LocalSearchClient(service)
            clients[node_id] = wrap(node_id, client) if wrap else client
        return self.root_mod.RootSearcher(metastore, clients), services

    # --- requests -------------------------------------------------------
    def request(self, query, index_ids=("logs",), sort=(), aggs=None,
                **kw):
        """`query`: a query string, an ES-DSL dict or a builder over the
        ast module."""
        if isinstance(query, str):
            ast = self.query.parse_query_string(query, ["body"])
        elif isinstance(query, dict):
            ast = self.es_dsl.es_query_to_ast(query, ["body"])
        else:
            ast = query(self.Q)
        return self.models.SearchRequest(
            index_ids=list(index_ids), query_ast=ast,
            sort_fields=tuple(self.models.SortField(*s) for s in sort),
            aggs=dict(aggs or {}), **kw)

    def counter(self, name: str) -> float:
        return getattr(self.metrics, name).get()


def root_engines(monkeypatch_module, **cluster_kw):
    """(jax, torch) engines, each with `resolver`, `metastore`, `root` and
    `services`. The two packages' split bytes and metastore files must be
    equal, each package's writer on its Python path."""
    from test_torch_indexing import force_python_paths
    force_python_paths(monkeypatch_module)
    out = {}
    for name in ("jax", "torch"):
        engine = RootEngine(name)
        engine.resolver, engine.metastore, engine.blobs, engine.files = \
            engine.populate()
        engine.root, engine.services = engine.cluster(
            engine.resolver, engine.metastore, **cluster_kw)
        out[name] = engine
    assert out["jax"].blobs == out["torch"].blobs
    assert out["jax"].files == out["torch"].files
    return out["jax"], out["torch"]


def assert_close(want, got, path="response"):
    """Exact, except floats under `aggregations`: rtol 1e-12 (f64 sums and
    what finalize derives from them)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), path
        for k in want:
            assert_close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_close(w, g, f"{path}[{i}]")
    elif (isinstance(want, float) and not isinstance(want, bool)
          and ".aggregations" in path):
        assert isinstance(got, float), path
        assert (np.isnan(want) and np.isnan(got)) or np.isclose(
            got, want, rtol=1e-12, atol=0), f"{path}: {want} vs {got}"
    else:
        assert want == got and type(want) is type(got), \
            f"{path}: {want!r} vs {got!r}"


# Counters that differ by design: the JAX executor counts its program
# cache (`compile_cache_*`: the port compiles nothing at query time),
# `cpu_micros` is a time, `device_dispatches` is the port's own count
# of the device programs a query launched, and `agg_evals` and
# `agg_kernel_evals` its own count of the aggregation nodes its split
# programs evaluated and of those its aggregation kernel computed.
UNCOMPARED_COUNTERS = ("compile_cache_hits", "compile_cache_misses",
                       "cpu_micros", "device_dispatches", "agg_evals",
                       "agg_kernel_evals", "topk_evals", "topk_kernel_evals",
                       "docs_fetched", "store_blocks_read")


def profile_shape(profile):
    """A profile without its times, in an order that does not depend on
    the fan-out's threads: the phase records (each without its times,
    `start_ms`, `duration_ms` and the port's `cpu_ms`; the JAX `compile`
    phase read as `execute`: the JAX executor names a dispatch that traced
    and compiled its program `compile`, and the port compiles nothing at
    query time) as a sorted multiset, the counters, the partial mark and
    the leaves' shapes."""
    if profile is None:
        return None

    def phase(p):
        rec = {k: v for k, v in p.items()
               if k not in ("start_ms", "duration_ms", "cpu_ms")}
        if rec["name"] == "compile":
            rec["name"] = "execute"
        return sorted(rec.items(), key=lambda kv: kv[0])

    return {"phases": sorted(phase(p) for p in profile["phases"]),
            "counters": {k: v for k, v in profile["counters"].items()
                         if k not in UNCOMPARED_COUNTERS},
            "partial": profile.get("partial"),
            "leaves": [profile_shape(c) for c in profile.get("leaves", [])]}


def batch_profile_shape(profile):
    """What the batch route's profiles share: the phase names and stages
    as a set, the root's own phases exactly and the counters other than
    staging. The port's batch stages each split through the per-split
    route's warmup (one `staging_upload` per split, `staging_bytes` and
    `predicate_staging_bytes` of the per-split route), where the JAX batch
    uploads one stacked set per batch."""
    shape = profile_shape(profile)
    phases = [dict(p) for p in shape["phases"]]
    return {"names": sorted({(p["name"], p.get("stage")) for p in phases
                             if p["name"] != "staging_upload"}, key=str),
            "root": [p for p in phases
                     if p["name"] in ("root_merge", "fetch_docs")],
            "counters": {k: v for k, v in shape["counters"].items()
                         if "staging" not in k},
            "partial": shape["partial"]}


def search_dict(response):
    out = response.to_dict()
    out.pop("elapsed_time_micros")
    out.pop("profile", None)
    out["hit_keys"] = [(h.split_id, h.doc_id, h.score, list(h.sort_values))
                       for h in response.hits]
    return out


def assert_same_search(got, want, batch_route=True):
    """Responses equal (minus elapsed time); profiles equal in shape, the
    batch route's in what the two batch designs share."""
    assert_close(search_dict(want), search_dict(got))
    assert (got.profile is None) == (want.profile is None)
    if got.profile is not None:
        shape = batch_profile_shape if batch_route else profile_shape
        assert shape(got.profile) == shape(want.profile)


@pytest.fixture(scope="module")
def engines():
    mp = pytest.MonkeyPatch()
    try:
        yield root_engines(mp)
    finally:
        mp.undo()


def both(engines, query, **kw):
    jax_engine, torch_engine = engines
    want = jax_engine.root.search(jax_engine.request(query, **kw))
    got = torch_engine.root.search(torch_engine.request(query, **kw))
    assert_same_search(got, want)
    return got, want


# --------------------------------------------------------------------------
# the cluster's requests

def test_the_two_corpora_and_metastores_are_equal(engines):
    _, torch_engine = engines
    splits = torch_engine.metastore.list_splits(
        torch_engine.metastore_mod.ListSplitsQuery(index_uids=["logs:01"]))
    assert len(splits) == NUM_SPLITS
    assert all(s.state.value == "Published" and s.metadata.column_bounds
               for s in splits)
    assert len(torch_engine.files) >= 3   # manifest + one file per index


REQUESTS = {
    "term_by_ts": dict(query="severity:ERROR", max_hits=10,
                       sort=(("ts", "desc"),)),
    "scored_common": dict(query="common", max_hits=20),
    "scored_common_offset": dict(query="common", max_hits=10,
                                 start_offset=10),
    "phrase_disk_full": dict(query='"disk full"', max_hits=7),
    "bool_range_by_ts": dict(
        query={"bool": {"must": [{"match": {"body": "common"}}],
                        "filter": [{"range": {"status": {"gte": 300,
                                                         "lt": 500}}}]}},
        max_hits=15, sort=(("ts", "desc"),)),
    "two_keys": dict(query="severity:WARN", max_hits=12,
                     sort=(("status", "asc"), ("ts", "desc"))),
    "text_sort": dict(query="word3", max_hits=9,
                      sort=(("severity", "asc"),)),
    "aggs_only": dict(query="*", max_hits=0, aggs=AGGS),
    "aggs_with_hits": dict(query="error", max_hits=5, aggs=AGGS),
    "snippets": dict(query="body:error", max_hits=5,
                     snippet_fields=("body",)),
    "tag_pruning": dict(query="tenant:1 AND severity:ERROR", max_hits=10,
                        sort=(("ts", "asc"),), aggs={"sev": AGGS["sev"]}),
    "zonemap_status_500": dict(
        query=lambda Q: Q.Range("status", lower=Q.RangeBound(500, True)),
        max_hits=5, sort=(("ts", "desc"),)),
    "zonemap_no_split": dict(query=lambda Q: Q.Term("status", "900"),
                             max_hits=5, aggs={"sev": AGGS["sev"]}),
    "time_range": dict(query="*", max_hits=3, sort=(("ts", "desc"),),
                       start_timestamp=(T0 + 150) * 1_000_000,
                       end_timestamp=(T0 + 349) * 1_000_000),
    "time_range_prunes_all": dict(query="*", max_hits=10, aggs=AGGS,
                                  start_timestamp=(T0 + 10**6) * 1_000_000),
    "pattern_two_indexes": dict(query="severity:INFO", max_hits=10,
                                index_ids=("log*",), sort=(("ts", "desc"),),
                                aggs={"sev": AGGS["sev"]}),
    "pattern_and_unknown": dict(query="common", max_hits=5,
                                index_ids=("logs-b", "nope")),
    "es_dsl_terms_and_exists": dict(
        query={"bool": {"filter": [{"terms": {"severity": ["INFO", "WARN"]}},
                                   {"exists": {"field": "latency"}}],
                        "must_not": [{"term": {"tenant": 2}}]}},
        max_hits=8, sort=(("latency", "desc"),)),
    "profiled": dict(query="severity:ERROR AND common", max_hits=4,
                     profile=True, aggs={"sev": AGGS["sev"]}),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_root_matches_jax(engines, name):
    got, want = both(engines, **REQUESTS[name])
    assert not got.errors
    if name == "time_range_prunes_all":
        assert got.num_attempted_splits == 0 and got.aggregations
    elif name == "zonemap_no_split":
        assert got.num_attempted_splits == 0 and got.num_hits == 0
    elif name == "snippets":
        assert all(h.snippets for h in got.hits)
    elif name == "profiled":
        names = {p["name"] for p in got.profile["phases"]}
        assert {"root_merge", "fetch_docs", "execute"} <= names
    else:
        assert got.num_hits > 0


def test_search_after_pages_match(engines):
    """Page 2 through `search_after` on each package's own page 1, equal
    to hits 16-30 of a 30-hit page."""
    jax_engine, torch_engine = engines
    query = REQUESTS["bool_range_by_ts"]["query"]
    pages = {}
    for engine in engines:
        first = engine.root.search(engine.request(
            query, max_hits=15, sort=(("ts", "desc"),)))
        last = first.hits[-1]
        second = engine.root.search(engine.request(
            query, max_hits=15, sort=(("ts", "desc"),),
            search_after=[last.sort_values[0], last.split_id, last.doc_id]))
        full = engine.root.search(engine.request(
            query, max_hits=30, sort=(("ts", "desc"),)))
        assert [h.doc for h in second.hits] == [h.doc for h in
                                                full.hits[15:]]
        pages[engine.name] = second
    assert_same_search(pages["torch"], pages["jax"])


def test_pruning_counts_match(engines):
    """Tag and zonemap pruning plan the same splits in both packages."""
    planned = {}
    for engine in engines:
        im = engine.metastore.index_metadata("logs")
        counts = []
        for name in ("tag_pruning", "zonemap_status_500",
                     "zonemap_no_split", "scored_common"):
            spec = dict(REQUESTS[name])
            req = engine.request(spec.pop("query"), **{
                k: v for k, v in spec.items() if k != "aggs"})
            counts.append(len(engine.root._prune_splits(im, engine.mapper,
                                                         req)))
        planned[engine.name] = counts
    assert planned["torch"] == planned["jax"] == [2, 1, 0, NUM_SPLITS]


def test_pruning_helpers_match(engines):
    jax_engine, torch_engine = engines
    for engine in engines:
        engine.cases = [
            engine.query.parse_query_string(q, ["body"])
            for q in ("tenant:2 AND severity:ERROR",
                      "tenant:2 OR severity:ERROR",
                      "status:[300 TO 400} AND latency:>10.5",
                      "status:500 AND NOT tenant:1", "(tenant:1)^2")]
    for jq, tq in zip(jax_engine.cases, torch_engine.cases):
        assert (jax_engine.root_mod.extract_required_tags(jq, ("tenant",))
                == torch_engine.root_mod.extract_required_tags(
                    tq, ("tenant",)))
        want = jax_engine.root_mod.extract_numeric_constraints(
            jq, jax_engine.mapper)
        got = torch_engine.root_mod.extract_numeric_constraints(
            tq, torch_engine.mapper)
        assert got == want
        for bounds in ({"status": (200, 204)}, {"status": (400, 404)},
                       {"latency": (0.0, 10.0)}, {}):
            assert (torch_engine.root_mod.split_excluded_by_bounds(
                bounds, got) == jax_engine.root_mod.split_excluded_by_bounds(
                    bounds, want))


def test_list_apis_match(engines):
    outs = {}
    for engine in engines:
        context = engine.context(engine.resolver)
        la = engine.list_apis
        outs[engine.name] = (
            la.root_list_terms(engine.metastore, context, "logs", "body",
                               max_terms=20),
            la.root_list_terms(engine.metastore, context, "logs", "severity",
                               start_key="F"),
            la.list_fields(engine.metastore, ["log*"], context),
            la.list_fields(engine.metastore, ["logs"]),
            la.list_field_entries(engine.metastore, context, ["logs"],
                                  field_patterns=["s*"]),
        )
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == ["INFO", "WARN"]


def test_profile_on_the_per_split_route_matches_jax():
    """On fresh nodes over the per-split route (`batch_size=1`) a profiled
    root search records the same phases (records and count, in any
    order), the same storage reads and staging bytes in both packages."""
    mp = pytest.MonkeyPatch()
    try:
        jax_engine, torch_engine = root_engines(mp, batch_size=1,
                                                prefetch=False)
    finally:
        mp.undo()
    spec = dict(REQUESTS["profiled"])
    query = spec.pop("query")
    want = jax_engine.root.search(jax_engine.request(query, **spec))
    got = torch_engine.root.search(torch_engine.request(query, **spec))
    assert_same_search(got, want, batch_route=False)
    counters = got.profile["counters"]
    assert counters["storage_reads"] > 0 and counters["staging_bytes"] > 0
    # the tenant meter reads these: one dispatch and one readback per split
    stages = [p.get("stage") for p in got.profile["phases"]
              if p["name"] == "execute"]
    assert sorted(stages) == ["dispatch"] * 6 + ["readback"] * 6


# --------------------------------------------------------------------------
# the reader's storage attribution

def test_profiled_leaf_reads_count_storage_like_jax(engines):
    """A profiled leaf call over cold readers of the same split bytes adds
    the same `storage_read_bytes` and `storage_reads` to the ambient
    profile in both packages."""
    counters = {}
    for engine in engines:
        profile_mod = importlib.import_module(
            engine.root_mod.__name__.rsplit(".", 2)[0]
            + ".observability.profile")
        context = engine.context(engine.resolver, batch_size=1,
                                 prefetch=False)
        service = engine.service_mod.SearchService(context)
        split = engine.metastore.list_splits(
            engine.metastore_mod.ListSplitsQuery(index_uids=["logs:01"]))[0]
        offset = engine.models.SplitIdAndFooter(
            split_id=split.metadata.split_id, storage_uri=SPLIT_URI,
            num_docs=split.metadata.num_docs)
        profile = profile_mod.QueryProfile(query_id="attribution")
        with profile_mod.profile_scope(profile):
            service.leaf_search(engine.models.LeafSearchRequest(
                search_request=engine.request("severity:ERROR",
                                              max_hits=3),
                index_uid="logs:01", doc_mapping=engine.mapper.to_dict(),
                splits=[offset]))
            docs = service.fetch_docs(engine.models.FetchDocsRequest(
                index_uid="logs:01", split=offset, doc_ids=[0, 5]))
        counters[engine.name] = (
            {k: v for k, v in profile.counters().items()
             if k.startswith("storage_")}, docs)
    assert counters["torch"] == counters["jax"]
    assert counters["torch"][0]["storage_reads"] > 0
    assert counters["torch"][0]["storage_read_bytes"] > 0


# --------------------------------------------------------------------------
# the kernels the root reaches

# request -> (solo `score_topk` calls, `score_topk_lanes` calls) on three
# fresh nodes: each node's batch of a score-sorted request takes one lane
# call (3 nodes of 2 splits); `pattern_and_unknown` searches the two splits
# of `logs-b`, one per node, on the per-split route (one solo call each)
KERNEL_CALLS = {name: (0, 0) for name in REQUESTS}
KERNEL_CALLS.update({
    "scored_common": (0, 3), "scored_common_offset": (0, 3),
    "phrase_disk_full": (0, 3), "snippets": (0, 3),
    "pattern_and_unknown": (2, 0),
})


def test_kernel_calls_per_request(engines, monkeypatch):
    """The kernel calls each request makes through fresh nodes (the plain
    versions on the CPU count no launch: spy on the calls);
    `tests/test_torch_cuda_root.py` holds the card's launches to the same
    table."""
    from quickwit_tpu_torch.parallel import fanout
    from quickwit_tpu_torch.search import executor
    _, torch_engine = engines
    root, _ = torch_engine.cluster(torch_engine.resolver,
                                   torch_engine.metastore)
    calls = []
    for mod, name in ((fanout, "score_topk_lanes"),
                      (executor, "score_topk")):
        real = getattr(mod, name)

        def spy(*args, real=real, name=name, **kw):
            calls.append(name)
            return real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    for name in sorted(REQUESTS):
        spec = dict(REQUESTS[name])
        calls.clear()
        response = root.search(torch_engine.request(spec.pop("query"),
                                                    **spec))
        assert (calls.count("score_topk"), calls.count("score_topk_lanes")
                ) == KERNEL_CALLS[name], name
        assert len(response.hits) == min(
            spec.get("max_hits", 10),
            max(response.num_hits - spec.get("start_offset", 0), 0)), name
