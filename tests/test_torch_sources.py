"""The port's external sources and their fakes against the JAX package's.

The scenarios of `tests/test_kafka_source.py` (10), `test_kinesis_source.py`
(11) and `test_sqs_source.py` (9) that need no `serve.Node` run in both
packages (`indexing/{kafka,fake_kafka,aws_json,kinesis,fake_kinesis,sqs,
fake_sqs}.py`, `make_source`'s three branches), each against its own
package's fake. On top of those, the wire is held between the packages in
both directions: the port's `KafkaSource` against the JAX
`FakeKafkaBroker` and the JAX source against the port's broker (and the
same for Kinesis and SQS) yield the same `SourceBatch` docs and checkpoint
deltas as a source against its own package's fake, and
`encode_record_batch` writes the same bytes in both packages.
"""

import importlib
import json
from types import SimpleNamespace

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def load(root):
    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    kafka, kinesis, sqs = (mod("indexing.kafka"), mod("indexing.kinesis"),
                           mod("indexing.sqs"))
    dm, index_md = mod("models.doc_mapper"), mod("models.index_metadata")
    metastore, pipeline = mod("metastore"), mod("indexing.pipeline")
    storage, leaf = mod("storage"), mod("search.leaf")
    cpu = {"device": "cpu"} if root == "quickwit_tpu_torch" else {}
    return SimpleNamespace(
        root=root, kafka=kafka, kinesis=kinesis, sqs=sqs,
        FakeKafkaBroker=mod("indexing.fake_kafka").FakeKafkaBroker,
        FakeKinesisServer=mod("indexing.fake_kinesis").FakeKinesisServer,
        FakeSqsServer=mod("indexing.fake_sqs").FakeSqsServer,
        make_source=mod("indexing.sources").make_source,
        checkpoint=mod("metastore.checkpoint"),
        SourceCheckpoint=mod("metastore.checkpoint").SourceCheckpoint,
        S3Config=mod("storage.s3").S3Config,
        StorageResolver=storage.StorageResolver,
        RamStorage=storage.RamStorage, Uri=mod("common.uri").Uri,
        SplitReader=mod("index.reader").SplitReader,
        IndexingPipeline=pipeline.IndexingPipeline,
        PipelineParams=pipeline.PipelineParams,
        split_file_path=pipeline.split_file_path,
        FileBackedMetastore=metastore.FileBackedMetastore,
        ListSplitsQuery=metastore.ListSplitsQuery,
        DocMapper=dm.DocMapper, FieldMapping=dm.FieldMapping,
        FieldType=dm.FieldType, IndexConfig=index_md.IndexConfig,
        IndexMetadata=index_md.IndexMetadata,
        SourceConfig=index_md.SourceConfig,
        SplitState=mod("models.split_metadata").SplitState,
        Term=mod("query.ast").Term,
        SearchRequest=mod("search.models").SearchRequest,
        leaf_search=lambda *args: leaf.leaf_search_single_split(*args,
                                                                 **cpu))


@pytest.fixture(params=PACKAGES)
def q(request):
    return load(request.param)


@pytest.fixture()
def broker(q):
    b = q.FakeKafkaBroker()
    yield b
    b.stop()


@pytest.fixture
def server(q):
    fake = q.FakeKinesisServer(access_key="AKID", secret_key="sekrit").start()
    yield fake
    fake.stop()


@pytest.fixture
def env(q):
    fake = q.FakeSqsServer(access_key="AKID", secret_key="s3kr1t",
                           visibility_timeout=30.0).start()
    resolver = q.StorageResolver.for_test()
    yield fake, resolver, resolver.resolve("ram:///sqs-files")
    fake.stop()


def drain(source, checkpoint, key="seq", **kw):
    out = []
    for batch in source.batches(checkpoint, **kw):
        out.extend(d[key] for d in batch.docs)
        checkpoint.try_apply_delta(batch.checkpoint_delta)
    return out


# --- Kafka: tests/test_kafka_source.py, in both packages ------------------

def kafka_docs(n, start=0):
    return [json.dumps({"seq": i}).encode() for i in range(start, start + n)]


def servers(broker):
    return {"bootstrap.servers": f"{broker.host}:{broker.port}"}


def test_crc32c_known_vector(q):
    assert q.kafka.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert q.kafka.crc32c(b"123456789") == 0xE3069283


def test_record_batch_roundtrip(q):
    data = q.kafka.encode_record_batch(41, [b"alpha", b"beta", b'{"x": 1}'])
    assert q.kafka.decode_record_batches(data) == [
        (41, b"alpha"), (42, b"beta"), (43, b'{"x": 1}')]
    corrupted = bytearray(data)
    corrupted[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC32C"):
        q.kafka.decode_record_batches(bytes(corrupted))


def test_wire_client_apis(q, broker):
    broker.create_topic("logs", partitions=2)
    broker.seed("logs", 0, kafka_docs(3))
    broker.seed("logs", 1, kafka_docs(2, start=100))
    client = q.kafka.KafkaWireClient([f"{broker.host}:{broker.port}"])
    assert client.api_versions()[1][1] >= 4
    assert len(client.metadata(["logs"])["topics"]["logs"]["partitions"]) \
        == 2
    assert client.list_offsets("logs", [0, 1], q.kafka.EARLIEST) == \
        {0: 0, 1: 0}
    records, high = client.fetch("logs", 0, 0)
    assert high == 3
    assert [json.loads(v)["seq"] for _o, v in records] == [0, 1, 2]
    client.close()


def test_source_drains_all_partitions(q, broker):
    broker.create_topic("logs", partitions=3)
    broker.seed("logs", 0, kafka_docs(5))
    broker.seed("logs", 1, kafka_docs(4, start=50))
    broker.seed("logs", 2, kafka_docs(3, start=90))
    source = q.make_source("kafka", {"topic": "logs",
                                     "client_params": servers(broker)})
    assert source.partition_ids() == ["logs:0", "logs:1", "logs:2"]
    assert sorted(drain(source, q.SourceCheckpoint())) == sorted(
        list(range(5)) + list(range(50, 54)) + list(range(90, 93)))


def test_kafka_source_resumes_exactly_once(q, broker):
    broker.create_topic("logs")
    broker.seed("logs", 0, kafka_docs(6))
    params = {"topic": "logs", "client_params": servers(broker)}
    checkpoint = q.SourceCheckpoint()
    first = next(iter(q.make_source("kafka", params).batches(
        checkpoint, batch_num_docs=4)))
    assert [d["seq"] for d in first.docs] == [0, 1, 2, 3]
    checkpoint.try_apply_delta(first.checkpoint_delta)
    source2 = q.make_source("kafka", params)
    assert drain(source2, checkpoint, batch_num_docs=4) == [4, 5]
    broker.seed("logs", 0, kafka_docs(2, start=6))
    assert [d["seq"] for b in source2.batches(checkpoint)
            for d in b.docs] == [6, 7]


def test_fetch_error_surfaces(q, broker):
    broker.create_topic("logs")
    broker.seed("logs", 0, kafka_docs(2))
    broker.fail_next_fetches = 1
    source = q.make_source("kafka", {"topic": "logs",
                                     "client_params": servers(broker)})
    with pytest.raises(q.kafka.KafkaProtocolError, match="Fetch error"):
        list(source.batches(q.SourceCheckpoint()))
    assert [d["seq"] for b in source.batches(q.SourceCheckpoint())
            for d in b.docs] == [0, 1]


def test_unreachable_broker_errors_clearly(q):
    source = q.make_source("kafka", {
        "topic": "logs", "client_params": {"bootstrap.servers":
                                           "127.0.0.1:1"}})
    with pytest.raises(q.kafka.KafkaProtocolError, match="bootstrap"):
        source.partition_ids()


def test_kafka_to_searchable_split(q, broker):
    broker.create_topic("logs")
    broker.seed("logs", 0, [json.dumps(
        {"body": f"msg {i}", "level": "ERROR" if i % 2 else "INFO"}).encode()
        for i in range(40)])
    storage = q.RamStorage(q.Uri.parse("ram:///kafka-e2e"))
    metastore = q.FileBackedMetastore(storage)
    mapper = q.DocMapper(field_mappings=[
        q.FieldMapping("body", q.FieldType.TEXT),
        q.FieldMapping("level", q.FieldType.TEXT, tokenizer="raw",
                       fast=True)])
    metastore.create_index(q.IndexMetadata(
        index_uid="kafka-idx:01",
        index_config=q.IndexConfig(index_id="kafka-idx",
                                   index_uri="ram:///kafka-e2e",
                                   doc_mapper=mapper),
        sources={"kafka-src": q.SourceConfig("kafka-src", "kafka")}))
    source = q.make_source("kafka", {"topic": "logs",
                                     "client_params": servers(broker)})
    pipeline = q.IndexingPipeline(
        q.PipelineParams(index_uid="kafka-idx:01", source_id="kafka-src"),
        mapper, source, metastore, storage)
    assert pipeline.run_to_completion().num_docs_processed == 40
    splits = metastore.list_splits(q.ListSplitsQuery(
        index_uids=["kafka-idx:01"], states=[q.SplitState.PUBLISHED]))
    assert sum(s.metadata.num_docs for s in splits) == 40
    split_id = splits[0].metadata.split_id
    res = q.leaf_search(
        q.SearchRequest(index_ids=["kafka-idx"],
                        query_ast=q.Term("level", "ERROR"), max_hits=5),
        mapper, q.SplitReader(storage, q.split_file_path(split_id)),
        split_id)
    assert res.num_hits == 20


def test_multi_broker_leader_routing(q):
    a = q.FakeKafkaBroker(node_id=0)
    b = q.FakeKafkaBroker(node_id=1)
    try:
        for broker in (a, b):
            broker.create_topic("logs", partitions=2)
        a.seed("logs", 0, kafka_docs(3))
        b.seed("logs", 1, kafka_docs(2, start=10))
        a.peer_brokers = [b]
        b.peer_brokers = [a]
        leaders = {("logs", 0): 0, ("logs", 1): 1}
        a.partition_leaders.update(leaders)
        b.partition_leaders.update(leaders)
        source = q.kafka.KafkaSource([f"{a.host}:{a.port}"], "logs")
        assert sorted(drain(source, q.SourceCheckpoint())) == \
            [0, 1, 2, 10, 11]
        source.close()
    finally:
        a.stop()
        b.stop()


def test_retention_truncation_resumes_at_earliest(q, broker):
    broker.create_topic("logs")
    broker.seed("logs", 0, kafka_docs(5))
    broker.seed("logs", 0, kafka_docs(5, start=5))
    source = q.make_source("kafka", {"topic": "logs",
                                     "client_params": servers(broker)})
    checkpoint = q.SourceCheckpoint()
    first = next(iter(source.batches(checkpoint, batch_num_docs=3)))
    checkpoint.try_apply_delta(first.checkpoint_delta)
    broker.truncate_before("logs", 0, 5)
    assert drain(source, checkpoint) == [5, 6, 7, 8, 9]


# --- Kinesis: tests/test_kinesis_source.py, in both packages --------------

def kinesis_params(server, stream="events"):
    return {"stream_name": stream, "region": "us-east-1",
            "endpoint": server.endpoint,
            "access_key": "AKID", "secret_key": "sekrit"}


def put(server, stream, n, start=0, shard=None):
    for i in range(n):
        server.put_record(stream, json.dumps({"seq": start + i}).encode(),
                          shard=shard)


def test_kinesis_wire_client_signed_roundtrip(q, server):
    server.create_stream("events", num_shards=3)
    client = q.kinesis.KinesisWireClient(
        server.endpoint, q.S3Config(access_key="AKID", secret_key="sekrit"))
    assert client.list_shards("events") == [
        "shardId-000000000000", "shardId-000000000001",
        "shardId-000000000002"]
    assert server.auth_failures == 0
    client.close()


def test_kinesis_bad_signature_rejected(q, server):
    server.create_stream("events")
    client = q.kinesis.KinesisWireClient(
        server.endpoint, q.S3Config(access_key="AKID", secret_key="WRONG"))
    with pytest.raises(q.kinesis.KinesisError) as exc:
        client.list_shards("events")
    assert "signature" in str(exc.value)
    assert server.auth_failures == 1
    client.close()


def test_source_drains_all_shards(q, server):
    server.create_stream("events", num_shards=2)
    put(server, "events", 5, shard=0)
    put(server, "events", 4, start=50, shard=1)
    source = q.make_source("kinesis", kinesis_params(server))
    assert source.partition_ids() == [
        "events:shardId-000000000000", "events:shardId-000000000001"]
    assert sorted(drain(source, q.SourceCheckpoint())) == sorted(
        list(range(5)) + list(range(50, 54)))
    source.close()


def test_kinesis_source_resumes_exactly_once(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 6)
    server.records_page_limit = 4
    source = q.make_source("kinesis", kinesis_params(server))
    checkpoint = q.SourceCheckpoint()
    first = next(iter(source.batches(checkpoint)))
    assert [d["seq"] for d in first.docs] == [0, 1, 2, 3]
    checkpoint.try_apply_delta(first.checkpoint_delta)
    source.close()
    source2 = q.make_source("kinesis", kinesis_params(server))
    assert drain(source2, checkpoint) == [4, 5]
    put(server, "events", 2, start=6)
    assert [d["seq"] for b in source2.batches(checkpoint)
            for d in b.docs] == [6, 7]
    source2.close()


def test_replayed_delta_rejected(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 3)
    source = q.make_source("kinesis", kinesis_params(server))
    checkpoint = q.SourceCheckpoint()
    batch = next(iter(source.batches(checkpoint)))
    checkpoint.try_apply_delta(batch.checkpoint_delta)
    with pytest.raises(q.checkpoint.IncompatibleCheckpointDelta):
        checkpoint.try_apply_delta(batch.checkpoint_delta)
    source.close()


def test_empty_mid_stream_pages_are_not_eof(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 5)
    server.records_page_limit = 2
    server.empty_pages = 2
    source = q.make_source("kinesis", kinesis_params(server))
    assert drain(source, q.SourceCheckpoint()) == list(range(5))
    source.close()


def test_reshard_new_shards_consumed_without_restart(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 3, shard=0)
    source = q.make_source("kinesis", kinesis_params(server))
    checkpoint = q.SourceCheckpoint()
    drain(source, checkpoint)
    server.add_shard("events")
    put(server, "events", 2, start=10, shard=1)
    assert drain(source, checkpoint) == [10, 11]
    source.close()


def test_bounded_pass_under_continuous_production(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 10)
    server.records_page_limit = 2
    source = q.make_source("kinesis", kinesis_params(server))
    source.max_pages_per_shard_pass = 3
    checkpoint = q.SourceCheckpoint()
    seqs = drain(source, checkpoint)
    assert seqs == [0, 1, 2, 3, 4, 5]
    seqs += drain(source, checkpoint)
    assert seqs == list(range(10))
    source.close()


def test_throttle_retries_transparently(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 2)
    server.throttle_requests = 2
    source = q.make_source("kinesis", kinesis_params(server))
    assert drain(source, q.SourceCheckpoint()) == [0, 1]
    server.fail_requests = 1
    assert drain(source, q.SourceCheckpoint()) == [0, 1]
    source.close()


def test_persistent_server_error_surfaces_then_recovers(q, server):
    server.create_stream("events", num_shards=1)
    put(server, "events", 2)
    server.fail_requests = 4
    source = q.make_source("kinesis", kinesis_params(server))
    with pytest.raises(q.kinesis.KinesisError):
        list(source.batches(q.SourceCheckpoint()))
    assert drain(source, q.SourceCheckpoint()) == [0, 1]
    source.close()


def test_kinesis_to_searchable_split(q, server):
    mapper = q.DocMapper(
        field_mappings=[
            q.FieldMapping("ts", q.FieldType.DATETIME, fast=True,
                           input_formats=("unix_timestamp",)),
            q.FieldMapping("body", q.FieldType.TEXT),
        ],
        timestamp_field="ts", default_search_fields=("body",))
    server.create_stream("logs", num_shards=2)
    for i in range(30):
        server.put_record("logs", json.dumps(
            {"ts": 1000 + i, "body": f"event {i} common"}).encode())
    split_storage = q.RamStorage(q.Uri.parse("ram:///kin-splits"))
    metastore = q.FileBackedMetastore(
        q.RamStorage(q.Uri.parse("ram:///kin-meta")))
    metastore.create_index(q.IndexMetadata(
        index_uid="logs:01",
        index_config=q.IndexConfig(index_id="logs",
                                   index_uri="ram:///kin-splits",
                                   doc_mapper=mapper),
        sources={"kin": q.SourceConfig(
            "kin", "kinesis", params=kinesis_params(server, "logs"))}))
    source = q.make_source("kinesis", kinesis_params(server, "logs"))
    q.IndexingPipeline(
        q.PipelineParams(index_uid="logs:01", source_id="kin",
                         split_num_docs_target=10**6, batch_num_docs=100),
        mapper, source, metastore, split_storage).run_to_completion()
    splits = metastore.list_splits(q.ListSplitsQuery(
        index_uids=["logs:01"], states=[q.SplitState.PUBLISHED]))
    assert sum(s.metadata.num_docs for s in splits) == 30
    split_id = splits[0].metadata.split_id
    resp = q.leaf_search(
        q.SearchRequest(index_ids=["logs"], query_ast=q.Term("body",
                                                             "common"),
                        max_hits=5),
        mapper, q.SplitReader(split_storage, q.split_file_path(split_id)),
        split_id)
    assert resp.num_hits == splits[0].metadata.num_docs
    source.close()


# --- SQS: tests/test_sqs_source.py, in both packages ----------------------

def sqs_params(fake):
    return {"queue_url": fake.queue_url, "region": "us-east-1",
            "endpoint": fake.endpoint,
            "access_key": "AKID", "secret_key": "s3kr1t"}


def put_file(storage, name, docs):
    storage.put(name, "\n".join(json.dumps(d) for d in docs).encode())


def test_notification_body_formats(q):
    s3_event = json.dumps({"Records": [{"s3": {
        "bucket": {"name": "b"}, "object": {"key": "path/f+1.ndjson"}}}]})
    assert q.sqs.notified_uris(s3_event) == ["s3://b/path/f 1.ndjson"]
    sns = json.dumps({"Type": "Notification", "Message": s3_event})
    assert q.sqs.notified_uris(sns) == ["s3://b/path/f 1.ndjson"]
    assert q.sqs.notified_uris("ram:///x/a.ndjson\nram:///x/b.ndjson") == [
        "ram:///x/a.ndjson", "ram:///x/b.ndjson"]


def test_signed_receive_index_ack_cycle(q, env):
    fake, resolver, storage = env
    put_file(storage, "a.ndjson", [{"n": i} for i in range(5)])
    put_file(storage, "b.ndjson", [{"n": 100 + i} for i in range(3)])
    fake.send_message("ram:///sqs-files/a.ndjson")
    fake.send_message("ram:///sqs-files/b.ndjson")
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    checkpoint = q.SourceCheckpoint()
    assert sorted(drain(source, checkpoint, key="n")) == \
        [0, 1, 2, 3, 4, 100, 101, 102]
    assert checkpoint.position_for("ram:///sqs-files/a.ndjson") == \
        q.sqs.EOF_POSITION
    assert fake.visible_count() == 2
    list(source.batches(checkpoint))
    assert fake.visible_count() == 0
    assert fake.auth_failures == 0
    source.close()


def test_crash_resume_exactly_once(q, env):
    fake, resolver, storage = env
    put_file(storage, "a.ndjson", [{"n": 1}, {"n": 2}])
    put_file(storage, "b.ndjson", [{"n": 3}])
    fake.send_message("ram:///sqs-files/a.ndjson")
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    checkpoint = q.SourceCheckpoint()
    assert drain(source, checkpoint, key="n") == [1, 2]
    source.close()
    assert fake.visible_count() == 1
    fake.make_visible_all()
    fake.send_message("ram:///sqs-files/b.ndjson")
    source2 = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    assert drain(source2, checkpoint, key="n") == [3]
    fake.make_visible_all()
    list(source2.batches(checkpoint))
    assert fake.visible_count() == 0
    source2.close()


def test_unreadable_file_left_for_redelivery(q, env):
    fake, resolver, _storage = env
    fake.send_message("ram:///sqs-files/missing.ndjson")
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    assert list(source.batches(q.SourceCheckpoint())) == []
    assert fake.visible_count() == 1
    source.close()


def test_sqs_bad_signature_rejected(q, env):
    fake, resolver, _storage = env
    source = q.make_source("sqs", dict(sqs_params(fake), secret_key="WRONG"),
                           resolver=resolver)
    with pytest.raises(q.sqs.SqsError):
        list(source.batches(q.SourceCheckpoint()))
    assert fake.auth_failures >= 1
    source.close()


def test_sqs_to_searchable_split(q, env):
    fake, resolver, storage = env
    mapper = q.DocMapper(
        field_mappings=[
            q.FieldMapping("ts", q.FieldType.DATETIME, fast=True,
                           input_formats=("unix_timestamp",)),
            q.FieldMapping("body", q.FieldType.TEXT),
        ],
        timestamp_field="ts", default_search_fields=("body",))
    put_file(storage, "events.ndjson",
             [{"ts": 1000 + i, "body": f"row {i} sqsword"}
              for i in range(25)])
    fake.send_message("ram:///sqs-files/events.ndjson")
    split_storage = resolver.resolve("ram:///sqs-splits")
    metastore = q.FileBackedMetastore(resolver.resolve("ram:///sqs-meta"))
    metastore.create_index(q.IndexMetadata(
        index_uid="q:01",
        index_config=q.IndexConfig(index_id="q",
                                   index_uri="ram:///sqs-splits",
                                   doc_mapper=mapper),
        sources={"sqs": q.SourceConfig("sqs", "sqs",
                                       params=sqs_params(fake))}))
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)

    def run():
        q.IndexingPipeline(
            q.PipelineParams(index_uid="q:01", source_id="sqs",
                             split_num_docs_target=10**6, batch_num_docs=10),
            mapper, source, metastore, split_storage).run_to_completion()

    run()
    splits = metastore.list_splits(q.ListSplitsQuery(
        index_uids=["q:01"], states=[q.SplitState.PUBLISHED]))
    assert sum(s.metadata.num_docs for s in splits) == 25
    resp = q.leaf_search(
        q.SearchRequest(index_ids=["q"], query_ast=q.Term("body", "sqsword"),
                        max_hits=3), mapper,
        q.SplitReader(split_storage,
                      q.split_file_path(splits[0].metadata.split_id)), "s")
    assert resp.num_hits == splits[0].metadata.num_docs
    run()
    assert fake.visible_count() == 0
    source.close()


def test_multifile_message_waits_for_every_sibling(q, env):
    fake, resolver, storage = env
    put_file(storage, "a.ndjson", [{"n": 1}])
    fake.send_message("ram:///sqs-files/a.ndjson\n"
                      "ram:///sqs-files/late.ndjson")
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    checkpoint = q.SourceCheckpoint()
    assert drain(source, checkpoint, key="n") == [1]
    fake.make_visible_all()
    list(source.batches(checkpoint))
    assert fake.visible_count() == 1
    put_file(storage, "late.ndjson", [{"n": 2}])
    fake.make_visible_all()
    assert drain(source, checkpoint, key="n") == [2]
    fake.make_visible_all()
    list(source.batches(checkpoint))
    assert fake.visible_count() == 0
    source.close()


def test_mid_file_crash_resumes_from_chunk(q, env):
    fake, resolver, storage = env
    put_file(storage, "big.ndjson", [{"n": i} for i in range(25)])
    fake.send_message("ram:///sqs-files/big.ndjson")
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    checkpoint = q.SourceCheckpoint()
    batches = source.batches(checkpoint, batch_num_docs=10)
    first = next(batches)
    checkpoint.try_apply_delta(first.checkpoint_delta)
    assert [d["n"] for d in first.docs] == list(range(10))
    batches.close()
    source.close()
    fake.make_visible_all()
    source2 = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    assert drain(source2, checkpoint, key="n", batch_num_docs=10) == \
        list(range(10, 25))
    assert checkpoint.position_for("ram:///sqs-files/big.ndjson") == \
        q.sqs.EOF_POSITION
    fake.make_visible_all()
    list(source2.batches(checkpoint))
    assert fake.visible_count() == 0
    source2.close()


def test_test_event_messages_deleted(q, env):
    fake, resolver, _storage = env
    fake.send_message(json.dumps({"Service": "Amazon S3",
                                  "Event": "s3:TestEvent"}))
    source = q.make_source("sqs", sqs_params(fake), resolver=resolver)
    assert list(source.batches(q.SourceCheckpoint())) == []
    assert fake.visible_count() == 0
    source.close()


# --- the wire between the packages -----------------------------------------

def batches_of(source, checkpoint, **kw):
    """Every batch of passes until one yields nothing: (docs, delta)."""
    out = []
    while True:
        got = 0
        for batch in source.batches(checkpoint, **kw):
            out.append((batch.docs, batch.checkpoint_delta.to_dict(),
                        batch.force_commit))
            checkpoint.try_apply_delta(batch.checkpoint_delta)
            got += 1
        if not got:
            return out, checkpoint.to_dict()


def test_record_batch_bytes_match_jax():
    jax_pkg, port_pkg = (load(root) for root in PACKAGES)
    cases = [(0, [b""]), (41, [b"alpha", b"beta", b'{"x": 1}']),
             (7, [bytes(range(256)) * 3, b"\x00" * 300]),
             (1 << 40, [json.dumps({"seq": i, "pad": "x" * i}).encode()
                        for i in range(300)])]
    for base, values in cases:
        for ts in (0, 1_600_000_000_000):
            want = jax_pkg.kafka.encode_record_batch(base, values, ts)
            got = port_pkg.kafka.encode_record_batch(base, values, ts)
            assert got == want
            assert port_pkg.kafka.decode_record_batches(want) == \
                jax_pkg.kafka.decode_record_batches(got)
        blob = b"".join(values)
        assert port_pkg.kafka.crc32c(blob) == jax_pkg.kafka.crc32c(blob)
    for n in (0, 1, 127, 128, 300, 1 << 20, -1, -64, -65):
        assert port_pkg.kafka._varzig(n) == jax_pkg.kafka._varzig(n)


def kafka_run(broker_pkg, source_pkg):
    broker = broker_pkg.FakeKafkaBroker()
    try:
        broker.create_topic("logs", partitions=3)
        for p in range(3):
            for chunk in range(3):
                broker.seed("logs", p, [json.dumps(
                    {"p": p, "i": chunk * 10 + i, "body": f"m {i}"}).encode()
                    for i in range(4 + p + chunk)])
        broker.seed("logs", 1, [b"not json"])
        source = source_pkg.make_source("kafka", {
            "topic": "logs", "client_params": servers(broker)})
        client = source.client
        apis = (client.api_versions(), client.metadata(["logs"])["topics"],
                client.list_offsets("logs", [0, 1, 2],
                                    source_pkg.kafka.LATEST),
                client.fetch("logs", 1, 2))
        first = batches_of(source, source_pkg.SourceCheckpoint(),
                           batch_num_docs=5)
        broker.seed("logs", 2, [b'{"tail": true}'])
        checkpoint = source_pkg.SourceCheckpoint.from_dict(first[1])
        tail = batches_of(source, checkpoint, batch_num_docs=5)
        source.close()
        return apis, first, tail
    finally:
        broker.stop()


@pytest.mark.parametrize("broker_root,source_root", [
    ("quickwit_tpu", "quickwit_tpu_torch"),
    ("quickwit_tpu_torch", "quickwit_tpu")],
    ids=["port_source_jax_broker", "jax_source_port_broker"])
def test_kafka_across_the_packages(broker_root, source_root):
    broker_pkg, source_pkg = load(broker_root), load(source_root)
    want = kafka_run(source_pkg, source_pkg)
    got = kafka_run(broker_pkg, source_pkg)
    assert got == want
    _apis, (batches, checkpoint), tail = got
    assert sum(len(docs) for docs, _, _ in batches) == 15 + 19 + 21
    assert checkpoint == {"logs:0": "00000000000000000015",
                          "logs:1": "00000000000000000019",
                          "logs:2": "00000000000000000021"}
    assert tail[0] == [([{"tail": True}],
                        {"logs:2": ["00000000000000000021",
                                    "00000000000000000022"]}, False)]


def kinesis_run(server_pkg, source_pkg):
    server = server_pkg.FakeKinesisServer(access_key="AKID",
                                          secret_key="sekrit").start()
    try:
        server.create_stream("events", num_shards=3)
        for i in range(40):
            server.put_record("events", json.dumps(
                {"seq": i, "body": f"e {i}"}).encode())
        server.put_record("events", b"\xff not json", shard=1)
        server.records_page_limit = 6
        source = source_pkg.make_source("kinesis", kinesis_params(server))
        first = batches_of(source, source_pkg.SourceCheckpoint())
        server.add_shard("events")
        for i in range(3):
            server.put_record("events", json.dumps({"late": i}).encode(),
                              shard=3)
        tail = batches_of(
            source, source_pkg.SourceCheckpoint.from_dict(first[1]))
        source.close()
        return first, tail, server.auth_failures
    finally:
        server.stop()


@pytest.mark.parametrize("server_root,source_root", [
    ("quickwit_tpu", "quickwit_tpu_torch"),
    ("quickwit_tpu_torch", "quickwit_tpu")],
    ids=["port_source_jax_server", "jax_source_port_server"])
def test_kinesis_across_the_packages(server_root, source_root):
    server_pkg, source_pkg = load(server_root), load(source_root)
    want = kinesis_run(source_pkg, source_pkg)
    got = kinesis_run(server_pkg, source_pkg)
    assert got == want
    (batches, checkpoint), (tail, _), auth_failures = got
    assert auth_failures == 0
    assert sum(len(docs) for docs, _, _ in batches) == 41
    assert sorted(checkpoint) == [f"events:shardId-00000000000{i}"
                                  for i in range(3)]
    assert [docs for docs, _, _ in tail] == [[{"late": 0}, {"late": 1},
                                              {"late": 2}]]


def sqs_run(server_pkg, source_pkg):
    fake = server_pkg.FakeSqsServer(access_key="AKID", secret_key="s3kr1t",
                                    visibility_timeout=30.0).start()
    resolver = source_pkg.StorageResolver.for_test()
    storage = resolver.resolve("ram:///sqs-files")
    try:
        for f in range(4):
            put_file(storage, f"f{f}.ndjson",
                     [{"f": f, "n": i} for i in range(7 + f)])
        fake.send_message("ram:///sqs-files/f0.ndjson")
        fake.send_message("ram:///sqs-files/f1.ndjson\n"
                          "ram:///sqs-files/f2.ndjson")
        fake.send_message(json.dumps({"Event": "s3:TestEvent"}))
        fake.send_message("ram:///sqs-files/f3.ndjson")
        source = source_pkg.make_source("sqs", sqs_params(fake),
                                        resolver=resolver)
        checkpoint = source_pkg.SourceCheckpoint()
        out = batches_of(source, checkpoint, batch_num_docs=4)
        left = fake.visible_count()
        fake.make_visible_all()
        list(source.batches(checkpoint))
        source.close()
        return out, left, fake.visible_count(), fake.auth_failures
    finally:
        fake.stop()


@pytest.mark.parametrize("server_root,source_root", [
    ("quickwit_tpu", "quickwit_tpu_torch"),
    ("quickwit_tpu_torch", "quickwit_tpu")],
    ids=["port_source_jax_server", "jax_source_port_server"])
def test_sqs_across_the_packages(server_root, source_root):
    server_pkg, source_pkg = load(server_root), load(source_root)
    want = sqs_run(source_pkg, source_pkg)
    got = sqs_run(server_pkg, source_pkg)
    assert got == want
    (batches, checkpoint), left, after_ack, auth_failures = got
    assert sum(len(docs) for docs, _, _ in batches) == 7 + 8 + 9 + 10
    assert set(checkpoint.values()) == {source_pkg.sqs.EOF_POSITION}
    assert (left, after_ack, auth_failures) == (0, 0, 0)
