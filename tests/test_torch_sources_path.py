"""External sources through the write path: the port against the JAX
package.

1. Each source through the pipeline. In each package, under a `FakeClock`
   and a seeded RNG, hdfs-logs docs made from a numpy seed
   (`chip_smoke.sources_docs`, as phase 14 makes its docs) go into the
   package's own fake (a Kafka topic of two partitions, a Kinesis stream
   of two shards, or S3 files notified through SQS) in two halves, and
   after each half one `IndexingPipeline.run_to_completion()` over the
   package's cached `make_source` client publishes splits. The split files
   and the metastore files must be byte-identical between the packages,
   the checkpoints equal, and the same root searches (the flagship, c2 as
   ES-DSL, c3, each severity's count and a rare term's hits) must answer
   equally through each package's `RootSearcher`.
2. Phase 14's move at a small size. `chip_smoke.SourcesFlow` runs in each
   package: three indexers plan the three sources, the Kafka task's
   indexer dies half way and its task moves, and every source is indexed
   exactly once. The plans, the move, the turns' counts and the
   exactly-once counts must equal JAX's, and each package's root must find
   every produced doc once.

`tests/test_torch_cuda_sources.py` imports `SMALL` and `flow_modules` and
runs part 2's root searches on the card. This file imports neither JAX
nor the JAX package at module level.
"""

import importlib
import json
import random
from types import SimpleNamespace

import pytest

from chip_smoke import (SOURCES_BUCKET, SOURCES_KEYS, SOURCES_TOPIC,
                        SourcesFlow, check_exactly_once_search, s3_event,
                        sources_docs, sources_requests, write_requests)
from test_torch_indexing import force_python_paths
from test_torch_root import assert_close, assert_same_search

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
SEED = 53
SMALL = {"kafka_partitions": 2, "kafka_docs": 1_024,
         "kinesis_shards": 2, "kinesis_docs": 512,
         "sqs_files": 4, "sqs_docs": 512,
         "split_docs": 512, "rare_term": 50}
PATH_SPLIT_DOCS = 300
PATH_BATCH_DOCS = 100
FLAGSHIP_AGGS = {
    "over_time": {"date_histogram": {"field": "timestamp",
                                     "fixed_interval": "1d"}},
    "severities": {"terms": {"field": "severity_text", "size": 10}}}


def flow_modules(root):
    """A package's modules under the names `chip_smoke.SourcesFlow` and
    its search helpers read."""
    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    synthetic = mod("index.synthetic")
    storage, s3 = mod("storage"), mod("storage.s3")
    index_md, metastore = mod("models.index_metadata"), mod("metastore")
    control_plane, actors = mod("control_plane"), mod("common.actors")
    membership = mod("cluster.membership")
    return SimpleNamespace(
        root=root, is_port=root == "quickwit_tpu_torch",
        synthetic=synthetic, HDFS_MAPPER=synthetic.HDFS_MAPPER,
        body_term=synthetic.body_term, clock=mod("common.clock"),
        StorageResolver=storage.StorageResolver,
        Protocol=mod("common.uri").Protocol,
        FakeS3Server=mod("storage.fake_s3").FakeS3Server,
        S3CompatibleStorage=s3.S3CompatibleStorage, S3Config=s3.S3Config,
        FakeKafkaBroker=mod("indexing.fake_kafka").FakeKafkaBroker,
        FakeKinesisServer=mod("indexing.fake_kinesis").FakeKinesisServer,
        FakeSqsServer=mod("indexing.fake_sqs").FakeSqsServer,
        kafka=mod("indexing.kafka"), sqs=mod("indexing.sqs"),
        checkpoint=mod("metastore.checkpoint"),
        FileBackedMetastore=metastore.FileBackedMetastore,
        ListSplitsQuery=metastore.ListSplitsQuery,
        IndexMetadata=index_md.IndexMetadata,
        IndexConfig=index_md.IndexConfig,
        SourceConfig=index_md.SourceConfig,
        SplitState=mod("models.split_metadata").SplitState,
        Cluster=membership.Cluster, ClusterMember=membership.ClusterMember,
        GossipService=mod("cluster.gossip").GossipService,
        IndexingScheduler=control_plane.IndexingScheduler,
        IndexingTask=control_plane.IndexingTask,
        Universe=actors.Universe, Actor=actors.Actor,
        CooperativeIndexingCycle=mod(
            "indexing.cooperative").CooperativeIndexingCycle,
        make_source=mod("indexing.sources").make_source,
        pipeline=mod("indexing.pipeline"), svc_mod=mod("search.service"),
        RootSearcher=mod("search.root").RootSearcher,
        SearchRequest=mod("search.models").SearchRequest,
        SortField=mod("search.models").SortField,
        parse_query_string=mod("query").parse_query_string,
        es_query_to_ast=mod("query.es_dsl").es_query_to_ast)


def root_over(m, resolver, metastore, device="cpu", nodes=2):
    """A `RootSearcher` over `nodes` fresh nodes (the port's on
    `device`)."""
    kw = {"device": device} if m.is_port else {}
    return m.RootSearcher(metastore, {
        f"node-{i}": m.svc_mod.LocalSearchClient(m.svc_mod.SearchService(
            m.svc_mod.SearcherContext(storage_resolver=resolver, **kw),
            node_id=f"node-{i}"))
        for i in range(nodes)})


def all_requests(m, index_id, rare_term):
    full = write_requests(m, FLAGSHIP_AGGS, index_id)
    return {**{name: full[name] for name in (
        "flagship", "c2_bool_range_top100", "c3_aggs")},
        **sources_requests(m, index_id, rare_term)}


@pytest.fixture(scope="module")
def python_writers():
    mp = pytest.MonkeyPatch()
    force_python_paths(mp)
    try:
        yield
    finally:
        mp.undo()


# --- 1. each source through the pipeline ---------------------------------

def produce(m, kind, fake, resolver, docs, half, sent):
    lo, hi = half * len(docs) // 2, (half + 1) * len(docs) // 2
    if kind == "kafka":
        for p in range(2):
            part = docs[lo:hi][p::2]
            fake.seed(SOURCES_TOPIC, p, [json.dumps(d).encode()
                                          for d in part])
    elif kind == "kinesis":
        for d in docs[lo:hi]:
            fake.put_record(SOURCES_TOPIC, json.dumps(d).encode())
    else:
        landing = resolver.resolve(f"s3://{SOURCES_BUCKET}/landing")
        per = (hi - lo) // 2
        for f in range(2):
            name = f"part-{half}{f}.ndjson"
            data = "\n".join(json.dumps(d) for d in
                             docs[lo + f * per:lo + (f + 1) * per]).encode()
            landing.put(name, data)
            sent.append(fake.send_message(s3_event(
                SOURCES_BUCKET, f"landing/{name}", len(data))))


def source_through_pipeline(m, kind):
    """`kind`'s docs through the pipeline in two halves (and, for SQS, the
    pass that acknowledges). Returns (observations, files, responses)."""
    keys = SOURCES_KEYS
    docs = sources_docs(m.synthetic, {f"{k}_docs": 700 for k in
                                      ("kafka", "kinesis", "sqs")}, SEED)[kind]
    resolver = m.StorageResolver.for_test()
    servers = [m.FakeS3Server(access_key=keys["access_key"],
                              secret_key=keys["secret_key"]).start()]
    s3_config = m.S3Config(endpoint=servers[0].endpoint, **keys)
    resolver.register(m.Protocol.S3, lambda uri: m.S3CompatibleStorage(
        uri, s3_config))
    client = None
    try:
        if kind == "kafka":
            fake = m.FakeKafkaBroker()
            fake.create_topic(SOURCES_TOPIC, partitions=2)
            params = {"topic": SOURCES_TOPIC, "client_params": {
                "bootstrap.servers": f"{fake.host}:{fake.port}"}}
        elif kind == "kinesis":
            fake = m.FakeKinesisServer(access_key=keys["access_key"],
                                       secret_key=keys["secret_key"]).start()
            fake.create_stream(SOURCES_TOPIC, num_shards=2)
            fake.records_page_limit = 64
            params = {"stream_name": SOURCES_TOPIC,
                      "endpoint": fake.endpoint, **keys}
        else:
            fake = m.FakeSqsServer(access_key=keys["access_key"],
                                   secret_key=keys["secret_key"]).start()
            params = {"queue_url": fake.queue_url,
                      "endpoint": fake.endpoint, **keys}
        servers.append(fake)
        meta_storage = resolver.resolve("ram:///sources/metastore")
        split_storage = resolver.resolve(f"ram:///sources/{kind}")
        metastore = m.FileBackedMetastore(meta_storage)
        uid, source_id = f"hdfs-{kind}:01", f"{kind}-source"
        metastore.create_index(m.IndexMetadata(
            index_uid=uid, index_config=m.IndexConfig(
                index_id=f"hdfs-{kind}", index_uri=f"ram:///sources/{kind}",
                doc_mapper=m.HDFS_MAPPER,
                split_num_docs_target=PATH_SPLIT_DOCS),
            # as the JAX source tests register it: the client's address
            # (a port of this run's fake) stays out of the metastore file
            sources={source_id: m.SourceConfig(source_id, kind)}))
        client = m.make_source(kind, params, resolver=resolver)
        sent, passes = [], []
        for half in (0, 1, None):
            if half is not None:
                produce(m, kind, fake, resolver, docs, half, sent)
            counters = m.pipeline.IndexingPipeline(
                m.pipeline.PipelineParams(
                    index_uid=uid, source_id=source_id,
                    split_num_docs_target=PATH_SPLIT_DOCS,
                    batch_num_docs=PATH_BATCH_DOCS),
                m.HDFS_MAPPER, client, metastore, split_storage) \
                .run_to_completion()
            passes.append((vars(counters),
                           metastore.source_checkpoint(uid,
                                                       source_id).to_dict()))
        if kind == "sqs":
            assert fake.visible_count() == 0
            assert sorted(set(fake.deleted)) == sorted(sent)
        published = metastore.list_splits(m.ListSplitsQuery(
            index_uids=[uid], states=[m.SplitState.PUBLISHED]))
        files = ({p: meta_storage.get_all(p)
                  for p in meta_storage.list_files()},
                 {p: split_storage.get_all(p)
                  for p in split_storage.list_files()})
        root = root_over(m, resolver, metastore)
        responses = {name: root.search(req) for name, req in
                     all_requests(m, f"hdfs-{kind}", 40).items()}
        check_exactly_once_search(m, docs, 40, responses, kind)
        return ((passes, [s.metadata.num_docs for s in published]), files,
                responses)
    finally:
        if client is not None:
            client.close()
        for server in servers:
            server.stop()


@pytest.mark.parametrize("kind", ["kafka", "kinesis", "sqs"])
def test_source_through_the_pipeline_matches_jax(kind, python_writers):
    out = {}
    for root in PACKAGES:
        m = flow_modules(root)
        with m.clock.use_clock(m.clock.FakeClock()), \
                m.clock.use_rng(random.Random(SEED)):
            out[root] = source_through_pipeline(m, kind)
    (want, want_files, want_resp), (got, got_files, got_resp) = (
        out[root] for root in PACKAGES)
    assert got == want
    passes, splits = got
    assert sum(splits) == 700 and len(splits) >= 2
    assert passes[-1][0]["num_docs_processed"] == 0
    for label, w, g in zip(("metastore", "splits"), want_files, got_files):
        assert w and sorted(g) == sorted(w), label
        for path in w:
            assert g[path] == w[path], (label, path)
    for name, response in want_resp.items():
        assert_same_search(got_resp[name], response)
    assert got_resp["flagship"].num_hits > 0
    assert len(got_resp["flagship"].hits) == 10


# --- 2. phase 14's move at a small size ------------------------------------

def run_flow(m, sizes=SMALL, seed=SEED):
    """`SourcesFlow` at `sizes` in package `m`, then the exactly-once
    searches through a CPU root. Returns the observations and the port's
    flow for more searches (its servers stopped, its storage kept)."""
    flow = SourcesFlow(m, sizes, seed, "ram:///sources")
    obs = {}
    try:
        with m.clock.use_clock(flow.clock), m.clock.use_rng(
                random.Random(seed)):
            plan = flow.setup()
            obs["plan"] = plan_keys(plan)
            obs["first_half"] = turns(flow, 0)
            obs["move"] = flow.move()
            obs["moved_plan"] = plan_keys(flow.plan)
            obs["second_half"] = turns(flow, 1)
            obs["ack"] = turn_counts(flow.drain("ack"))
            obs["exactly_once"] = flow.exactly_once()
            obs["produced"] = dict(flow.produced)
            obs["checkpoints"] = flow.expected_checkpoints()
    finally:
        flow.close()
    root = root_over(m, flow.resolver, flow.metastore)
    obs["searches"] = {}
    for kind in ("kafka", "kinesis", "sqs"):
        responses = {name: root.search(req) for name, req in all_requests(
            m, f"hdfs-{kind}", sizes["rare_term"]).items()}
        obs["searches"][kind] = (
            check_exactly_once_search(m, flow.docs[kind], sizes["rare_term"],
                                      responses, kind),
            {name: (r.num_hits, r.aggregations)
             for name, r in responses.items()})
    return obs, flow


def plan_keys(plan):
    return {node: [t.key for t in tasks]
            for node, tasks in sorted(plan.assignments.items())}


def turn_counts(ran):
    return {f"{node}/{key[1]}": turn["counters"]
            for (node, key), turn in sorted(ran.items())}


def turns(flow, half):
    flow.produce(half)
    return turn_counts(flow.drain(f"half {half}"))


@pytest.fixture(scope="module")
def flows(python_writers):
    return {root: run_flow(flow_modules(root)) for root in PACKAGES}


def test_move_matches_jax(flows):
    want, got = (flows[root][0] for root in PACKAGES)
    for step in ("plan", "first_half", "move", "moved_plan", "second_half",
                 "ack", "exactly_once", "produced", "checkpoints"):
        assert got[step] == want[step], step
    for kind, (checked, responses) in want["searches"].items():
        got_checked, got_responses = got["searches"][kind]
        assert got_checked == checked
        assert_close({k: list(v) for k, v in responses.items()},
                     {k: list(v) for k, v in got_responses.items()},
                     f"{kind}.aggregations")


def test_move_holds_in_each_package(flows):
    for root in PACKAGES:
        obs, flow = flows[root]
        assert sorted(obs["plan"]) == ["indexer-0", "indexer-1", "indexer-2"]
        move = obs["move"]
        dead, new_owner = move["kafka"]
        assert dead not in move["indexers"] and new_owner != dead
        assert move["drift_before_apply"] and not move["drift_after_apply"]
        assert set(move["stayed"]) == {"kinesis-source", "sqs-source"}
        # the new owner resumed the Kafka task from the checkpoint: it read
        # the second half only
        kafka_turns = {k: v for k, v in obs["second_half"].items()
                       if k.endswith("kafka-source")}
        assert kafka_turns == {f"{new_owner}/kafka-source": {
            **kafka_turns[f"{new_owner}/kafka-source"],
            "num_docs_processed": SMALL["kafka_docs"] // 2}}
        assert all(c["num_docs_processed"] == 0 for c in obs["ack"].values())
        once = obs["exactly_once"]
        assert once["published_docs"] == {
            kind: SMALL[f"{kind}_docs"] for kind in ("kafka", "kinesis",
                                                     "sqs")}
        assert once["sqs_messages"] == {"sent": 4, "deleted": 4, "left": 0}
        assert all(checked["rare_term_hits"] > 0
                   for checked, _ in obs["searches"].values())
        assert flow.universe is None and not flow.servers


def test_flow_stops_everything_when_a_source_fails():
    """A source that raises fails its drain (no hang), and `close()` still
    stops every actor and server."""
    m = flow_modules("quickwit_tpu_torch")
    flow = SourcesFlow(m, SMALL, SEED, "ram:///sources-fail")
    try:
        with m.clock.use_clock(flow.clock), m.clock.use_rng(
                random.Random(SEED)):
            flow.setup()
            flow.produce(0)
            flow.broker.fail_next_fetches = 10
            with pytest.raises(AssertionError, match="raised"):
                flow.drain("first half")
    finally:
        universe = flow.universe
        flow.close()
    assert all(h.join(5.0) is None and not h.thread.is_alive()
               for h in universe.handles())
    assert not flow.servers and not flow.clients
