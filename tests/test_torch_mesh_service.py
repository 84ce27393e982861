"""A port node whose searcher context shards batches over a device mesh
(`SearcherContext(mesh_devices=[cpu] * 8)`) beside a JAX node over the
forced host devices, the service-level cases of
`tests/test_mesh_root_merge.py:399-530`.

Each package writes the same 6-split index through its own indexing
pipeline under a FakeClock and a seeded RNG (the JAX writer on its Python
paths), so split ids and bytes agree. Both nodes answer the same
requests through their roots: the responses must be equal (minus
`elapsed_time_micros`), and so must the routing, read from the batch
route's `dispatch.launch` flight events (their `mesh` size) and the
`qw_mesh_dispatches_total` deltas.
"""

import importlib
import random

import pytest
import torch

import test_mesh_root_merge as jm

SEED = 5


def _docs():
    return [{"timestamp": 1_600_000_000 + i * 60,
             "severity_text": jm.SEVERITIES[i % 4],
             "tenant_id": i % 4,
             "body": ["alpha beta", "alpha", "beta beta", "alpha alpha"][i % 4],
             "latency": float((i * 37) % 5_000)}
            for i in range(600)]


class Node:
    """One package's metastore, one searcher node and its root."""

    def __init__(self, name: str):
        root = "quickwit_tpu" if name == "jax" else "quickwit_tpu_torch"

        def mod(path):
            return importlib.import_module(f"{root}.{path}")

        self.name = name
        self.Q = mod("query.ast")
        self.models = mod("search.models")
        self.service_mod = mod("search.service")
        self.root_mod = mod("search.root")
        self.metrics = mod("observability.metrics")
        self.flight = mod("observability.flight")
        self.meta_mod = mod("metastore")
        self.index_md = mod("models.index_metadata")
        self.indexing = mod("indexing")
        self.clock = mod("common.clock")
        dm = mod("models.doc_mapper")
        self.mapper = dm.DocMapper.from_dict(jm.MAPPER.to_dict())
        self.resolver = mod("storage").StorageResolver.for_test()

    def populate(self):
        with self.clock.use_clock(self.clock.FakeClock()), \
                self.clock.use_rng(random.Random(SEED)):
            self.metastore = self.meta_mod.FileBackedMetastore(
                self.resolver.resolve("ram:///meshsvc/meta"))
            config = self.index_md.IndexConfig(
                index_id="logs", index_uri="ram:///meshsvc/splits",
                doc_mapper=self.mapper, split_num_docs_target=100)
            self.metastore.create_index(self.index_md.IndexMetadata(
                index_uid="logs:01", index_config=config,
                sources={"src": self.index_md.SourceConfig("src", "vec")}))
            self.indexing.IndexingPipeline(
                self.indexing.PipelineParams(
                    index_uid="logs:01", source_id="src",
                    split_num_docs_target=100, batch_num_docs=50),
                self.mapper, self.indexing.VecSource(_docs()),
                self.metastore,
                self.resolver.resolve("ram:///meshsvc/splits"),
            ).run_to_completion()
        self.root, self.service = self.node("node-0")
        return self

    def node(self, node_id, **kw):
        if self.name == "torch":
            kw.update(device="cpu", mesh_devices=[torch.device("cpu")] * 8)
        service = self.service_mod.SearchService(
            self.service_mod.SearcherContext(storage_resolver=self.resolver,
                                             **kw), node_id=node_id)
        root = self.root_mod.RootSearcher(
            self.metastore,
            {node_id: self.service_mod.LocalSearchClient(service)})
        return root, service

    def request(self, query, **kw):
        sort = kw.pop("sort", ())
        return self.models.SearchRequest(
            index_ids=["logs"], query_ast=query(self.Q),
            sort_fields=tuple(self.models.SortField(*s) for s in sort), **kw)

    def search(self, root, query, **kw):
        """(response dict, mesh dispatches, the batch route's launches as
        (splits, mesh size))."""
        self.flight.FLIGHT.begin_run()
        before = self.metrics.MESH_DISPATCHES_TOTAL.get()
        resp = self.last = root.search(self.request(query, **kw))
        launches = [(e["attrs"]["splits"], e["attrs"]["mesh"])
                    for e in self.flight.FLIGHT.events()
                    if e["kind"] == "dispatch.launch"
                    and e["attrs"].get("path") == "batch"]
        out = resp.to_dict()
        out.pop("elapsed_time_micros", None)
        return out, self.metrics.MESH_DISPATCHES_TOTAL.get() - before, \
            launches


@pytest.fixture(scope="module")
def nodes():
    from test_torch_indexing import force_python_paths
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        pair = Node("jax").populate(), Node("torch").populate()
    ids = [sorted(s.metadata.split_id for s in node.metastore
                  .list_splits(node.meta_mod.ListSplitsQuery(
                      index_uids=["logs:01"])))
           for node in pair]
    assert ids[0] == ids[1] and len(ids[0]) == 6
    return pair


def both(nodes, query, which="default", **kw):
    """The same search on each package's node of `which`."""
    out = []
    for node in nodes:
        root = node.root if which == "default" else which(node)
        out.append(node.search(root, query, **kw))
    return out


def test_scored_query_rides_mesh_and_warm_equals_cold(nodes):
    """A scored multi-split search stays on the batch route with the
    tiers on, and the batch route is the mesh: six splits over a 6-way
    split axis (8 devices)."""
    query = lambda Q: Q.FullText("body", "beta", "or")  # noqa: E731
    (j_cold, j_n, j_l), (t_cold, t_n, t_l) = both(nodes, query, max_hits=10)
    assert t_cold == j_cold
    assert t_n == j_n == 1
    assert t_l == j_l == [(6, 6)]
    assert nodes[1].metrics.MESH_DEVICES.get() == 6
    (j_warm, _, _), (t_warm, _, _) = both(nodes, query, max_hits=10)
    assert t_warm == j_warm == t_cold


def test_search_after_routes_per_split(nodes):
    query = lambda Q: Q.MatchAll()  # noqa: E731
    sort = (("timestamp", "desc"),)
    (j_full, _, _), (t_full, _, _) = both(nodes, query, max_hits=20,
                                          sort=sort)
    assert t_full == j_full
    pivot = nodes[1].last.hits[9]
    marker = list(pivot.sort_values) + [pivot.split_id, pivot.doc_id]
    (j_page, j_n, j_l), (t_page, t_n, t_l) = both(
        nodes, query, max_hits=10, sort=sort, search_after=marker)
    assert t_page == j_page
    assert t_n == j_n == 0 and t_l == j_l == []
    assert t_page["hits"] == t_full["hits"][10:20]


def test_cache_routing_rule_keeps_host_path(nodes):
    """Tier A/B consult and fill per split: a mask-eligible sorted query
    and a Tier-B-eligible agg-only query route per split in both
    packages, off the mesh."""
    assert nodes[1].service.context.mask_cache is not None
    term = lambda Q: Q.Term("severity_text", "ERROR")  # noqa: E731
    (j_sorted, j_n1, _), (t_sorted, t_n1, t_l1) = both(
        nodes, term, max_hits=10, sort=(("timestamp", "desc"),))
    (j_agg, j_n2, _), (t_agg, t_n2, t_l2) = both(
        nodes, term, max_hits=0, aggs={"t": {"terms": {"field":
                                                       "tenant_id"}}})
    assert t_sorted == j_sorted and t_agg == j_agg
    assert t_n1 == j_n1 == t_n2 == j_n2 == 0
    assert t_l1 == t_l2 == []
    assert t_sorted["num_hits"] == t_agg["num_hits"] > 0


def test_caches_off_restores_fused_mesh_routing(nodes):
    """Both tiers off: the sorted query rides the mesh again in both
    packages, equal to the cache-routed per-split answer."""
    term = lambda Q: Q.Term("severity_text", "ERROR")  # noqa: E731
    sort = (("timestamp", "desc"),)
    (j_want, _, _), (t_want, _, _) = both(nodes, term, max_hits=12,
                                          sort=sort)

    def bare(node):
        return node.node("node-bare", enable_mask_cache=False,
                         enable_agg_cache=False)[0]

    (j_got, j_n, j_l), (t_got, t_n, t_l) = both(nodes, term, which=bare,
                                                max_hits=12, sort=sort)
    assert t_got == j_got == t_want == j_want
    assert t_n == j_n == 1 and t_l == j_l == [(6, 6)]


def test_device_mesh_rule_matches_jax(nodes):
    """`device_mesh(n)` picks the JAX service's split axis for every split
    count over 8 devices; the port leaves the JAX docs axis's devices
    unused. One device, the default, gives none."""
    j_ctx, t_ctx = nodes[0].service.context, nodes[1].service.context
    for n in range(1, 17):
        j, t = j_ctx.device_mesh(n), t_ctx.device_mesh(n)
        assert (None if j is None else j.shape["splits"]) == \
            (None if t is None else t.size), n
        assert t is None or t.shape == {"splits": t.size}
    assert t_ctx.device_mesh(8) is t_ctx.device_mesh(8)
    single = nodes[1].service_mod.SearcherContext(
        storage_resolver=nodes[1].resolver, device="cpu")
    assert single.mesh_devices == [torch.device("cpu")]
    assert single.device_mesh(8) is None
