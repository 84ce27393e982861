"""The port's indexing pipeline against the JAX package's.

`tests/test_indexing.py`'s and `tests/test_chaos_indexing.py`'s pipeline
scenarios (end to end, a split cut on target, invalid docs dropped with the
checkpoint advanced, crash replay exactly once, the stage, upload and
publish faults, file-source checkpoints, a transform) run in both
packages, each over its own RAM storage and `FileBackedMetastore`, under a
`FakeClock` and a seeded RNG installed through each package's
`common/clock.py` (split ids and timestamps come from those seams). Each
package's writer and merge run their Python paths (`_native_capable` and
the native module off). Every scenario must return the same observations in both
packages, and the two packages must have written the same split files and
the same metastore files, byte for byte.

This file also holds the harness that `tests/test_torch_merge.py`,
`tests/test_torch_compaction_janitor.py` and
`tests/test_torch_write_path.py` import (`WriteEngine`, `run_both`,
`python_paths`, `force_python_paths`).
"""

import importlib
import json
import random

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
SEED = 31
SPLIT_URI = "ram:///w/splits"
META_URI = "ram:///w/metastore"


class WriteEngine:
    """One package's write path: its modules, a doc mapper and helpers
    that hide the one difference between the packages' call signatures
    (the port's leaf search takes `device`)."""

    def __init__(self, root: str):
        self.root = root
        self.is_port = root == "quickwit_tpu_torch"
        # the port's device entry points run on the CPU only when asked
        self.cpu = {"device": "cpu"} if self.is_port else {}

        def mod(path):
            return importlib.import_module(f"{root}.{path}")

        self.mod = mod
        self.indexing = mod("indexing")
        self.pipeline = mod("indexing.pipeline")
        self.sources = mod("indexing.sources")
        self.merge = mod("indexing.merge")
        self.transform = mod("indexing.transform")
        self.ingest = mod("ingest")
        self.router = mod("ingest.router")
        self.compaction = mod("compaction")
        self.janitor = mod("janitor")
        self.delete_planner = mod("janitor.delete_planner")
        self.gc = mod("janitor.gc")
        self.merge_arrays = mod("index.merge_arrays")
        self.writer = mod("index.writer")
        self.reader = mod("index.reader")
        self.metastore_mod = mod("metastore")
        self.checkpoint = mod("metastore.checkpoint")
        self.split_md = mod("models.split_metadata")
        self.index_md = mod("models.index_metadata")
        self.dm = mod("models.doc_mapper")
        self.clock = mod("common.clock")
        self.faults = mod("common.faults")
        self.metrics = mod("observability.metrics")
        self.storage_mod = mod("storage")
        self.leaf = mod("search.leaf")
        self.models = mod("search.models")
        self.Q = mod("query.ast")
        dm = self.dm
        self.mapper = dm.DocMapper(
            field_mappings=[
                dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                                input_formats=("unix_timestamp",)),
                dm.FieldMapping("body", dm.FieldType.TEXT),
                dm.FieldMapping("tenant", dm.FieldType.U64, fast=True),
            ],
            timestamp_field="ts", tag_fields=("tenant",),
            default_search_fields=("body",))

    # --- environment ---------------------------------------------------
    def env(self, mapper=None, merge_policy=None, split_num_docs_target=None,
            sources=("src", "src2")):
        """A fresh resolver, metastore and index `logs:01`."""
        resolver = self.storage_mod.StorageResolver.for_test()
        meta_storage = resolver.resolve(META_URI)
        metastore = self.metastore_mod.FileBackedMetastore(meta_storage)
        config_kw = {}
        if merge_policy is not None:
            config_kw["merge_policy"] = merge_policy
        if split_num_docs_target is not None:
            config_kw["split_num_docs_target"] = split_num_docs_target
        config = self.index_md.IndexConfig(
            index_id="logs", index_uri=SPLIT_URI,
            doc_mapper=mapper or self.mapper, **config_kw)
        metastore.create_index(self.index_md.IndexMetadata(
            index_uid="logs:01", index_config=config,
            sources={s: self.index_md.SourceConfig(s, "vec")
                     for s in sources}))
        return Env(self, resolver, metastore, meta_storage,
                   resolver.resolve(SPLIT_URI))

    # --- search ----------------------------------------------------------
    def leaf_search(self, request, mapper, reader, split_id):
        return self.leaf.leaf_search_single_split(request, mapper, reader,
                                                  split_id, **self.cpu)

    def request(self, ast_fn, max_hits=1000, **kw):
        return self.models.SearchRequest(index_ids=["logs"],
                                         query_ast=ast_fn(self.Q),
                                         max_hits=max_hits, **kw)


class Env:
    def __init__(self, engine, resolver, metastore, meta_storage,
                 split_storage):
        self.e = engine
        self.resolver = resolver
        self.metastore = metastore
        self.meta_storage = meta_storage
        self.split_storage = split_storage

    def pipeline(self, source, target=1_000_000, batch=100, source_id="src",
                 mapper=None, **kw):
        e = self.e
        params = e.pipeline.PipelineParams(
            index_uid="logs:01", source_id=source_id,
            split_num_docs_target=target, batch_num_docs=batch)
        return e.pipeline.IndexingPipeline(
            params, mapper or e.mapper, source, self.metastore,
            self.split_storage, **kw)

    def published(self):
        e = self.e
        return self.metastore.list_splits(e.metastore_mod.ListSplitsQuery(
            index_uids=["logs:01"],
            states=[e.split_md.SplitState.PUBLISHED]))

    def splits(self, state=None):
        e = self.e
        states = None if state is None else [e.split_md.SplitState(state)]
        return self.metastore.list_splits(e.metastore_mod.ListSplitsQuery(
            index_uids=["logs:01"], states=states))

    def open(self, split_id):
        return self.e.reader.SplitReader(
            self.split_storage, self.e.pipeline.split_file_path(split_id))

    def count(self, split_id, ast_fn, mapper=None):
        e = self.e
        response = e.leaf_search(e.request(ast_fn, max_hits=0),
                                 mapper or e.mapper, self.open(split_id),
                                 split_id)
        return response.num_hits

    def hits(self, split_id, ast_fn, mapper=None, **kw):
        e = self.e
        response = e.leaf_search(e.request(ast_fn, **kw),
                                 mapper or e.mapper, self.open(split_id),
                                 split_id)
        return response.num_hits, [
            (h.split_id, h.doc_id, h.sort_value, h.raw_sort_value)
            for h in response.partial_hits]

    def files(self):
        """(metastore files, split files): path -> bytes."""
        return ({p: self.meta_storage.get_all(p)
                 for p in self.meta_storage.list_files()},
                {p: self.split_storage.get_all(p)
                 for p in self.split_storage.list_files()})


def make_docs(n, start=0):
    return [{"ts": 1000 + start + i, "body": f"event {start + i} common",
             "tenant": (start + i) % 3} for i in range(n)]


def listed(splits):
    return [s.to_dict() for s in splits]


def force_python_paths(monkeypatch):
    """Each package's writer and merge on their Python paths: no
    `"native"` footer marker, the Python k-way merge
    (`tests/test_torch_native.py` holds the native paths)."""
    from quickwit_tpu import native as j_native
    from quickwit_tpu.index import writer as j_writer
    from quickwit_tpu_torch import native as t_native
    from quickwit_tpu_torch.index import writer as t_writer
    for writer, native in ((j_writer, j_native), (t_writer, t_native)):
        monkeypatch.setattr(writer, "_native_capable", lambda fm: None)
        monkeypatch.setattr(native, "_cached", None)


@pytest.fixture
def python_paths(monkeypatch):
    force_python_paths(monkeypatch)


def run_both(scenario, *args, **env_kw):
    """Run `scenario(engine, env, *args)` in each package under a
    `FakeClock` and a seeded RNG. The observations and the files each
    package wrote must be equal. Returns the port's (observations, env)."""
    out = {}
    for root in PACKAGES:
        engine = WriteEngine(root)
        with engine.clock.use_clock(engine.clock.FakeClock()), \
                engine.clock.use_rng(random.Random(SEED)):
            env = engine.env(**env_kw)
            obs = scenario(engine, env, *args)
        out[root] = (obs, env.files(), env)
    (want, want_files, _), (got, got_files, env) = \
        out["quickwit_tpu"], out["quickwit_tpu_torch"]
    assert got == want
    for kind, w, g in zip(("metastore", "splits"), want_files, got_files):
        assert sorted(g) == sorted(w), kind
        for path in w:
            assert g[path] == w[path], (kind, path)
    return got, env


# --- scenarios -----------------------------------------------------------

def scenario_end_to_end(e, env):
    counters = env.pipeline(e.sources.VecSource(make_docs(250))) \
        .run_to_completion()
    assert counters.num_docs_processed == 250
    assert counters.num_splits_published == 1
    [split] = env.published()
    md = split.metadata
    assert md.num_docs == 250
    assert md.time_range_start == 1000 * 1_000_000
    assert md.tags == {"tenant:0", "tenant:1", "tenant:2"}
    count = env.count(md.split_id, lambda Q: Q.Term("tenant", "1"))
    assert count == sum(1 for i in range(250) if i % 3 == 1)
    top = env.hits(md.split_id, lambda Q: Q.Term("body", "common"),
                   max_hits=5)
    return (vars(counters), listed(env.published()), count, top)


def scenario_splits_on_target(e, env):
    env.pipeline(e.sources.VecSource(make_docs(250)), target=100) \
        .run_to_completion()
    splits = env.published()
    assert sum(s.metadata.num_docs for s in splits) == 250
    assert sorted(s.metadata.num_docs for s in splits) == [50, 100, 100]
    return listed(splits)


def scenario_crash_replay_is_exactly_once(e, env):
    docs = make_docs(300)
    env.pipeline(e.sources.VecSource(docs), target=100).run_to_completion()
    # restart: a new pipeline, the same source, the same checkpoint store
    counters = env.pipeline(e.sources.VecSource(docs), target=100) \
        .run_to_completion()
    assert counters.num_docs_processed == 0
    assert sum(s.metadata.num_docs for s in env.published()) == 300
    return (vars(counters), listed(env.published()),
            env.metastore.source_checkpoint("logs:01", "src").to_dict())


def scenario_invalid_docs_dropped(e, env):
    docs = make_docs(10) + [{"ts": "not-a-ts", "body": 1}] * 5
    counters = env.pipeline(e.sources.VecSource(docs)).run_to_completion()
    assert (counters.num_docs_processed, counters.num_docs_invalid) == (10, 5)
    # the checkpoint covers the bad docs too: a replay reads nothing
    replay = env.pipeline(e.sources.VecSource(docs)).run_to_completion()
    assert replay.num_docs_processed == 0
    return vars(counters), vars(replay), listed(env.published())


def scenario_only_invalid_docs_advance_checkpoint(e, env):
    docs = [{"ts": "bad", "body": 1}] * 3
    counters = env.pipeline(e.sources.VecSource(docs)).run_to_completion()
    assert counters.num_docs_invalid == 3 and env.published() == []
    return (vars(counters),
            env.metastore.source_checkpoint("logs:01", "src").to_dict())


def scenario_file_source_checkpoint(e, env, path):
    with open(path, "w") as f:
        for doc in make_docs(100):
            f.write(json.dumps(doc) + "\n")
        f.write("{not json\n")
    first = env.pipeline(e.sources.make_source(
        "file", {"filepath": str(path)})).run_to_completion()
    assert (first.num_docs_processed, first.num_docs_invalid) == (100, 1)
    # appended docs: a rerun indexes only the new tail
    with open(path, "a") as f:
        for doc in make_docs(20, start=100):
            f.write(json.dumps(doc) + "\n")
    second = env.pipeline(e.sources.make_source(
        "file", {"filepath": str(path)})).run_to_completion()
    assert second.num_docs_processed == 20
    return vars(first), vars(second), listed(env.published())


def scenario_transform(e, env):
    dm = e.dm
    mapper = dm.DocMapper(field_mappings=[
        dm.FieldMapping("level", dm.FieldType.TEXT, tokenizer="raw",
                        fast=True),
        dm.FieldMapping("body", dm.FieldType.TEXT)],
        default_search_fields=("body",))
    docs = [{"severity": "warn", "body": "keep me"},
            {"severity": "debug", "body": "drop me"},
            {"severity": 13, "body": "invalid: uppercase(int)"}]
    transform = e.transform.Transform(
        'if .severity == "debug" { drop() }\n'
        '.level = uppercase(.severity)\ndel(.severity)')
    counters = env.pipeline(e.sources.VecSource(docs), mapper=mapper,
                            transform=transform).run_to_completion()
    assert (counters.num_docs_processed, counters.num_docs_invalid) == (1, 1)
    [split] = env.published()
    reader = env.open(split.metadata.split_id)
    return vars(counters), reader.fetch_docs([0])


def scenario_publish_fault_then_replay(e, env):
    """An error at the publish boundary publishes nothing and leaves the
    checkpoint where it was; the replay publishes every doc once."""
    injector = e.faults.FaultInjector(seed=7, rules=[e.faults.FaultRule(
        operation="indexing.publish", kind="error", max_fires=1)])
    before = e.metrics.FAULTS_INJECTED_TOTAL.get(op="indexing.publish",
                                                 kind="error")
    docs = make_docs(300)
    with pytest.raises(e.faults.InjectedFault):
        env.pipeline(e.sources.VecSource(docs), target=100,
                     fault_injector=injector).run_to_completion()
    assert env.published() == []
    staged = listed(env.splits("Staged"))
    assert e.metrics.FAULTS_INJECTED_TOTAL.get(
        op="indexing.publish", kind="error") == before + 1
    counters = env.pipeline(e.sources.VecSource(docs), target=100) \
        .run_to_completion()
    assert counters.num_docs_processed == 300
    assert sum(s.metadata.num_docs for s in env.published()) == 300
    return staged, vars(counters), listed(env.published())


def scenario_stage_and_upload_faults(e, env):
    out = []
    for op in ("indexing.stage", "indexing.upload"):
        injector = e.faults.FaultInjector(seed=3, rules=[
            e.faults.FaultRule(operation=op, kind="error", max_fires=1)])
        with pytest.raises(e.faults.InjectedFault):
            env.pipeline(e.sources.VecSource(make_docs(50)),
                         fault_injector=injector).run_to_completion()
        assert env.published() == []
        out.append((op, listed(env.splits()), injector.schedule()))
    return out


def scenario_partitions(e, env):
    """One writer per partition id, all published in one commit."""
    dm = e.dm
    mapper = dm.DocMapper(
        field_mappings=list(e.mapper.field_mappings),
        timestamp_field="ts", partition_key="tenant",
        max_num_partitions=2, default_search_fields=("body",))
    counters = env.pipeline(e.sources.VecSource(make_docs(60)),
                            mapper=mapper).run_to_completion()
    splits = env.published()
    assert sum(s.metadata.num_docs for s in splits) == 60
    return vars(counters), sorted(
        (s.metadata.partition_id, s.metadata.num_docs) for s in splits)


SCENARIOS = [
    scenario_end_to_end,
    scenario_splits_on_target,
    scenario_crash_replay_is_exactly_once,
    scenario_invalid_docs_dropped,
    scenario_only_invalid_docs_advance_checkpoint,
    scenario_transform,
    scenario_publish_fault_then_replay,
    scenario_stage_and_upload_faults,
    scenario_partitions,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[len("scenario_"):]
                              for s in SCENARIOS])
def test_pipeline_scenario_matches_jax(scenario, python_paths):
    run_both(scenario)


def test_file_source_checkpoint_matches_jax(python_paths, tmp_path):
    run_both(scenario_file_source_checkpoint, tmp_path / "docs.ndjson")


def test_ingest_source_drains_wal_shards(python_paths, tmp_path):
    """`IngestSource` over two WAL shards: one pass publishes every record
    with a checkpoint per shard; a second pass reads nothing."""
    def scenario(e, env, wal_root):
        ingester = e.ingest.Ingester(str(wal_root / e.root), fsync=False)
        router = e.ingest.IngestRouter(ingester, shards_per_source=2)
        for b in range(6):
            router.ingest("logs:01", make_docs(20, start=20 * b))
        source_id = e.router.INGEST_V2_SOURCE_ID
        source = e.sources.IngestSource(ingester, "logs:01", source_id)
        assert sorted(source.partition_ids()) == ["shard-00", "shard-01"]
        first = env.pipeline(source, target=40, batch=40,
                             source_id=source_id).run_to_completion()
        again = env.pipeline(
            e.sources.IngestSource(ingester, "logs:01", source_id),
            target=40, batch=40, source_id=source_id).run_to_completion()
        assert first.num_docs_processed == 120
        assert again.num_docs_processed == 0
        return (vars(first), listed(env.published()),
                env.metastore.source_checkpoint("logs:01",
                                                source_id).to_dict())

    run_both(scenario, tmp_path, sources=("src", "_ingest-source"))


def test_make_source_matches_jax(tmp_path):
    path = tmp_path / "d.ndjson"
    path.write_text("{}\n")
    for root in PACKAGES:
        sources = importlib.import_module(f"{root}.indexing.sources")
        vec = sources.make_source("vec", {"docs": [{"a": 1}],
                                          "partition_id": "p"})
        assert type(vec).__name__ == "VecSource"
        assert vec.partition_ids() == ["p"]
        assert type(sources.make_source(
            "file", {"filepath": str(path)})).__name__ == "FileSource"
        assert type(sources.make_source("void", {})).__name__ == \
            "VoidSource"
        with pytest.raises(ValueError, match="unknown source type"):
            sources.make_source("nope", {})
        with pytest.raises(NotImplementedError):
            sources.make_source("pulsar", {})


@pytest.mark.parametrize("source_type,params,module,cls", [
    ("kafka", {"topic": "t",
               "client_params": {"bootstrap.servers": "127.0.0.1:1"}},
     "kafka", "KafkaSource"),
    ("kinesis", {"stream_name": "s", "endpoint": "http://127.0.0.1:1"},
     "kinesis", "KinesisSource"),
    ("sqs", {"queue_url": "http://127.0.0.1:1/q",
             "endpoint": "http://127.0.0.1:1"}, "sqs", "SqsFileSource"),
])
def test_make_source_builds_external_sources(source_type, params, module,
                                             cls):
    """The Kafka, Kinesis and SQS branches return the port's own sources,
    as the JAX package's return its sources, and building one connects to
    nothing (port 1 has no listener)."""
    for root in PACKAGES:
        sources = importlib.import_module(f"{root}.indexing.sources")
        source = sources.make_source(source_type, params)
        want = getattr(importlib.import_module(f"{root}.indexing.{module}"),
                       cls)
        assert type(source) is want
        client = source.client
        assert (client._conn is None if source_type != "kafka"
                else not client._socks)
        source.close()
