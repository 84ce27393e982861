"""The write path as a whole: the port against the JAX package.

In each package, on the CPU, under a `FakeClock` and a seeded RNG, the
node's write flow runs as `quickwit_tpu/serve/node.py` composes it:
1. `Node.ingest_v2`: 2,000 hdfs-shaped docs made from a numpy seed
   (`chip_smoke.write_docs`, as phase 13 makes its docs) go through an
   `IngestRouter` into two fsync'd WAL shards, in requests of 100 docs
   (the last request alone carries tenant 10);
2. `Node.run_ingest_pass`: one `IngestSource` pipeline pass with a split
   target of 500 publishes 4 splits, then the WAL is truncated behind the
   published checkpoint;
3. a delete task on tenant 10, then `Node.run_janitor` (GC, retention, the
   delete planner: one split rewritten, three fast-forwarded);
4. `Node.run_merges`: the `stable_log` policy (merge factor 4) merges the
   four splits into one over the array fast path;
5. GC with `now` past the deletion grace: only the merged split's file
   stays.
After every step the same root searches run through each package's
`RootSearcher` over two nodes (term top-10 by `_score` with the flagship's
aggregations, c2's bool + range top-100 as ES-DSL, a date_histogram +
terms aggregation, the deleted tenant's count, and every hit of a rare
body term sorted by timestamp): the port's responses must equal the JAX
root's with `tests/test_torch_root.py`'s tolerances, and the WAL files,
the metastore files and the split files must be byte-identical.

`tests/test_torch_cuda_write_path.py` imports `write_path` and runs the
same flow with the port's nodes and delete planner on the card. This file
imports neither JAX nor the JAX package at module level.
"""

import importlib
import random

import pytest

from chip_smoke import WRITE_DELETED_TENANT as DELETED_TENANT
from chip_smoke import WRITE_T0 as T0
from chip_smoke import write_docs
from test_torch_indexing import WriteEngine, force_python_paths
from test_torch_ingest_wal import tree_bytes
from test_torch_root import assert_close, assert_same_search, search_dict

SEED = 47
DAY_US = 86_400 * 1_000_000
RARE_TERM = 200
MERGE_POLICY = {"type": "stable_log", "merge_factor": 4,
                "max_merge_factor": 4}


def search_requests(e):
    query = e.mod("query")
    es_dsl = e.mod("query.es_dsl")
    body_term = e.mod("index.synthetic").body_term
    aggs = {"over_time": {"date_histogram": {"field": "timestamp",
                                             "fixed_interval": "1d"}},
            "severities": {"terms": {"field": "severity_text", "size": 10}}}
    t0_us = T0 * 1_000_000
    c2 = {"bool": {
        "must": [{"term": {"severity_text": "ERROR"}}],
        "should": [{"term": {"body": body_term(3)}},
                   {"term": {"body": body_term(7)}}],
        "filter": [{"range": {"timestamp": {"gte": t0_us + DAY_US,
                                            "lt": t0_us + 4 * DAY_US}}}]}}

    def request(q, **kw):
        ast = (es_dsl.es_query_to_ast(q, ["body"]) if isinstance(q, dict)
               else query.parse_query_string(q, ["body"]))
        return e.models.SearchRequest(index_ids=["logs"], query_ast=ast,
                                      **kw)

    by_ts = (e.models.SortField("timestamp", "desc"),)
    return {
        "flagship": request("severity_text:ERROR", max_hits=10, aggs=aggs),
        "c2_bool_range_top100": request(c2, max_hits=100),
        "c3_aggs": request("severity_text:ERROR", max_hits=0, aggs=aggs),
        "deleted_tenant": request(f"tenant_id:{DELETED_TENANT}",
                                  max_hits=0),
        "rare_term_all_hits": request(f"body:{body_term(RARE_TERM)}",
                                      max_hits=100, sort_fields=by_ts),
    }


def run_ingest_pass(e, env, ingester, batch_num_docs=None):
    """`Node.run_ingest_pass`: drain the WAL shards into splits, publish,
    truncate behind the published checkpoint."""
    source_id = e.router.INGEST_V2_SOURCE_ID
    metadata = env.metastore.index_metadata("logs")
    uid = metadata.index_uid
    if source_id not in metadata.sources:
        env.metastore.add_source(uid, e.index_md.SourceConfig(source_id,
                                                              "ingest"))
    params = e.pipeline.PipelineParams(
        index_uid=uid, source_id=source_id,
        split_num_docs_target=metadata.index_config.split_num_docs_target,
        **({"batch_num_docs": batch_num_docs} if batch_num_docs else {}))
    counters = e.pipeline.IndexingPipeline(
        params, metadata.index_config.doc_mapper,
        e.sources.IngestSource(ingester, uid, source_id), env.metastore,
        env.resolver.resolve(metadata.index_config.index_uri)) \
        .run_to_completion()
    checkpoint = env.metastore.source_checkpoint(uid, source_id)
    for shard in ingester.list_shards(uid):
        position = checkpoint.position_for(shard.shard_id)
        if position != e.checkpoint.BEGINNING:
            ingester.truncate(uid, source_id, shard.shard_id, int(position))
    return vars(counters)


def run_merges(e, env):
    """`Node.run_merges`: one merge-policy pass."""
    metadata = env.metastore.index_metadata("logs")
    policy = e.merge.merge_policy_from_config(
        metadata.index_config.merge_policy)
    operations = policy.operations(env.published())
    executor = e.merge.MergeExecutor(
        metadata.index_uid, metadata.index_config.doc_mapper, env.metastore,
        env.resolver.resolve(metadata.index_config.index_uri))
    delete_tasks = env.metastore.list_delete_tasks(metadata.index_uid)
    for operation in operations:
        executor.execute(operation, delete_tasks=delete_tasks or None)
    return len(operations)


def roots(e, env, devices):
    """{label: RootSearcher over two fresh nodes on that device}."""
    service_mod = e.mod("search.service")
    root_mod = e.mod("search.root")
    out = {}
    for label, device in devices.items():
        kw = {} if device is None else {"device": device}
        clients = {f"node-{i}": service_mod.LocalSearchClient(
            service_mod.SearchService(service_mod.SearcherContext(
                storage_resolver=env.resolver, **kw), node_id=f"node-{i}"))
            for i in range(2)}
        out[label] = root_mod.RootSearcher(env.metastore, clients)
    return out


def write_path(e, wal_dir, devices, num_docs=2_000, request_docs=100,
               shards=2, split_target=500):
    """The five steps in package `e`, searching after each through a root
    per entry of `devices` ({label: device, None for the JAX package}).
    Returns [(step, observations, {label: {request: response}}, files)]."""
    env = e.env(mapper=e.mod("index.synthetic").HDFS_MAPPER,
                merge_policy=MERGE_POLICY, split_num_docs_target=split_target,
                sources=())
    requests = search_requests(e)
    uid = "logs:01"
    planner_kw = {"device": devices["planner"]} if e.is_port else {}
    search_devices = {k: v for k, v in devices.items() if k != "planner"}
    steps = []

    def after(step, obs):
        responses = {label: {name: root.search(req)
                             for name, req in requests.items()}
                     for label, root in roots(e, env, search_devices).items()}
        steps.append((step, obs, responses, env.files()))

    # 1. ingest: the router spreads requests over the WAL shards
    ingester = e.ingest.Ingester(wal_dir, fsync=True)
    router = e.ingest.IngestRouter(ingester, shards_per_source=shards)
    docs = write_docs(e.mod("index.synthetic"), num_docs, request_docs, SEED)
    positions = [router.ingest(uid, docs[lo:lo + request_docs])
                 for lo in range(0, num_docs, request_docs)]
    after("ingest", positions)

    # 2. index: one ingest pass, then the WAL truncated behind it
    counters = run_ingest_pass(e, env, ingester)
    wal_state = ingester.shard_throughput_state()
    assert [s.metadata.num_docs for s in env.published()] == \
        [split_target] * (num_docs // split_target)
    assert all(s["published"] == s["head"] for s in wal_state.values())
    after("index", (counters, wal_state))

    # 3. delete: a task on the last request's tenant, then the janitor
    env.metastore.create_delete_task(uid, {
        "type": "term", "field": "tenant_id", "value": str(DELETED_TENANT)})
    now = e.clock.wall_time()
    janitor = {
        **e.gc.run_garbage_collection(env.metastore, env.resolver, now=now),
        **e.janitor.apply_retention(env.metastore, now=now),
        **e.janitor.run_delete_planner(env.metastore, env.resolver,
                                       **planner_kw)}
    assert (janitor["delete_splits_rewritten"],
            janitor["delete_splits_fast_forwarded"]) == \
        (1, num_docs // split_target - 1)
    after("delete", janitor)

    # 4. merge: the four splits into one over the array fast path
    merged = run_merges(e, env)
    [split] = env.published()
    assert merged == 1
    assert split.metadata.num_docs == num_docs - request_docs
    after("merge", (merged, split.metadata.to_dict()))

    # 5. gc past the deletion grace: only the merged split's file stays
    gc = e.gc.run_garbage_collection(
        env.metastore, env.resolver,
        now=e.clock.wall_time() + e.gc.DELETION_GRACE_SECS + 1)
    assert env.split_storage.list_files() == \
        [e.pipeline.split_file_path(split.metadata.split_id)]
    after("gc", gc)
    return steps


def stored_docs(response):
    return sorted(tuple(sorted(h.doc.items())) for h in response.hits)


def check_flow(steps, num_docs=2_000, request_docs=100):
    """What the flow must show in one package, root by root."""
    by_step = {step: responses for step, _, responses, _ in steps}
    for responses in by_step["ingest"].values():
        assert all(r.num_hits == 0 for r in responses.values())
    for label in by_step["index"]:
        index, delete, merge, gc = (by_step[s][label] for s in
                                    ("index", "delete", "merge", "gc"))
        assert index["deleted_tenant"].num_hits == request_docs
        assert delete["deleted_tenant"].num_hits == 0
        assert delete["c3_aggs"].num_hits > 0
        assert len(index["flagship"].hits) == 10
        assert 0 < len(index["rare_term_all_hits"].hits) == \
            index["rare_term_all_hits"].num_hits
        # the merge renumbers doc ids (the timestamp reorder) but keeps
        # every count, every bucket and every stored doc
        for name in ("flagship", "c2_bool_range_top100", "c3_aggs",
                     "deleted_tenant", "rare_term_all_hits"):
            assert merge[name].num_hits == delete[name].num_hits, name
            assert_close(delete[name].aggregations,
                         merge[name].aggregations,
                         f"{name}.aggregations")
            assert_close(search_dict(merge[name]), search_dict(gc[name]))
        assert stored_docs(merge["rare_term_all_hits"]) == \
            stored_docs(delete["rare_term_all_hits"])
        # one split left; the deleted tenant's count prunes it by bounds
        assert merge["flagship"].num_attempted_splits == 1
        assert merge["deleted_tenant"].num_attempted_splits == 0
        assert not any(r.errors for r in merge.values())


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """The flow in both packages (the JAX writer and merge on their Python
    paths)."""
    mp = pytest.MonkeyPatch()
    force_python_paths(mp)
    try:
        out = {}
        for root in ("quickwit_tpu", "quickwit_tpu_torch"):
            e = WriteEngine(root)
            wal_dir = str(tmp_path_factory.mktemp(root) / "wal")
            devices = ({"cpu": "cpu", "planner": "cpu"} if e.is_port
                       else {"cpu": None})
            calls = []
            orig = e.merge_arrays.merge_splits

            def spy(readers, _orig=orig, **kw):
                calls.append(len(readers))
                return _orig(readers, **kw)
            mp.setattr(e.merge_arrays, "merge_splits", spy)
            with e.clock.use_clock(e.clock.FakeClock()), \
                    e.clock.use_rng(random.Random(SEED)):
                steps = write_path(e, wal_dir, devices)
            out[root] = (steps, tree_bytes(wal_dir), calls)
        yield out
    finally:
        mp.undo()


STEPS = ["ingest", "index", "delete", "merge", "gc"]


@pytest.mark.parametrize("step", range(len(STEPS)), ids=STEPS)
def test_step_matches_jax(flows, step):
    want_step, want_obs, want_resp, want_files = flows["quickwit_tpu"][0][step]
    got_step, got_obs, got_resp, got_files = \
        flows["quickwit_tpu_torch"][0][step]
    assert got_step == want_step == STEPS[step]
    assert got_obs == want_obs
    for name, want in want_resp["cpu"].items():
        assert_same_search(got_resp["cpu"][name], want)
    for kind, w, g in zip(("metastore", "splits"), want_files, got_files):
        assert sorted(g) == sorted(w), kind
        for path in w:
            assert g[path] == w[path], (kind, path)


def test_wal_files_match_jax(flows):
    want = flows["quickwit_tpu"][1]
    got = flows["quickwit_tpu_torch"][1]
    assert got and sorted(got) == sorted(want) and got == want


@pytest.mark.parametrize("root", ["quickwit_tpu", "quickwit_tpu_torch"])
def test_flow_holds_in_each_package(flows, root):
    steps, _, calls = flows[root]
    check_flow(steps)
    # the merge took the array fast path once, over the four splits
    assert calls == [4]


def test_write_docs_follow_the_generator():
    """`chip_smoke.write_docs`, which makes this flow's docs and phase
    13's."""
    synthetic = importlib.import_module("quickwit_tpu_torch.index.synthetic")
    docs = write_docs(synthetic, 2_000, 100, SEED)
    assert docs == write_docs(synthetic, 2_000, 100, SEED)
    assert {d["severity_text"] for d in docs} <= set(synthetic.SEVERITIES)
    assert {d["tenant_id"] for d in docs[-100:]} == {DELETED_TENANT}
    assert DELETED_TENANT not in {d["tenant_id"] for d in docs[:-100]}
    assert all(len(d["body"].split()) == 20 for d in docs)
    ts = [d["timestamp"] for d in docs]
    assert T0 <= min(ts) and max(ts) < T0 + 7 * 86_400
    # requests arrive in time order; inside a request the order is shuffled
    assert max(ts[:100]) <= min(ts[100:200])
