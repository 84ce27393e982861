"""The port's file-backed metastore against the JAX package's, byte for byte.

One script of metastore operations (the pattern of `tests/test_metastore.py`:
create, stage, publish with checkpoint deltas, list with time, tag and state
filters, replace, mark and delete, sources, retention, delete tasks, shard
chains, templates, a reload by a second instance) runs in both packages over
a RAM storage, under a `FakeClock` and a seeded RNG installed through each
package's `common/clock.py` seams (split ids come from `new_split_id`, the
timestamps from `wall_time`). After every step the two packages must have
written the same files with the same bytes and returned the same outcome
(the result's dict, or the error's kind and message). Split metadata
carries what must survive the JSON round trip: `column_bounds` tuples of
u64 (past 2^63), i64 and f64 bounds, time ranges in microseconds and
frozenset tags.
"""

import importlib
import random

import pytest

SEED = 23


class Engine:
    def __init__(self, name: str):
        root = "quickwit_tpu" if name == "jax" else "quickwit_tpu_torch"

        def mod(path):
            return importlib.import_module(f"{root}.{path}")

        self.name = name
        self.ms = mod("metastore")
        self.checkpoint = mod("metastore.checkpoint")
        self.split_md = mod("models.split_metadata")
        self.index_md = mod("models.index_metadata")
        self.dm = mod("models.doc_mapper")
        self.clock = mod("common.clock")
        self.storage = mod("storage")
        self.uri = mod("common.uri")
        self.ids: dict[str, str] = {}

    def index(self, index_id="logs", uid_suffix="01"):
        dm = self.dm
        mapper = dm.DocMapper(
            field_mappings=[
                dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                                input_formats=("unix_timestamp",)),
                dm.FieldMapping("body", dm.FieldType.TEXT),
                dm.FieldMapping("tenant", dm.FieldType.U64, fast=True)],
            timestamp_field="ts", tag_fields=("tenant",))
        config = self.index_md.IndexConfig(
            index_id=index_id, index_uri=f"ram:///indexes/{index_id}",
            doc_mapper=mapper)
        return self.index_md.IndexMetadata(
            index_uid=f"{index_id}:{uid_suffix}", index_config=config,
            sources={"src1": self.index_md.SourceConfig("src1", "vec")})

    def split(self, name, n, index_uid="logs:01"):
        """Split `name` (the n-th of the script): a fresh id from the RNG
        seam, a time range, a tenant tag and column bounds of each numeric
        kind."""
        split_id = self.split_md.new_split_id()
        self.ids[name] = split_id
        return self.split_md.SplitMetadata(
            split_id=split_id, index_uid=index_uid, source_id="src1",
            num_docs=100 + n, uncompressed_docs_size_bytes=1000 * n,
            footprint_bytes=4096 + n,
            time_range_start=1_600_000_000_000_000 + n * 1_000_000,
            time_range_end=1_600_000_000_000_000 + n * 1_000_000 + 999_999,
            tags=frozenset({f"tenant:{n % 2}", "source:vec"}),
            create_timestamp=int(self.clock.wall_time()),
            column_bounds={"tenant": (n % 2, 2**63 + n),
                           "delta": (-2**40 - n, n),
                           "latency": (0.5 * n, 1e300)})

    def delta(self, start, end):
        c = self.checkpoint
        start = c.BEGINNING if start is None else c.offset_position(start)
        return c.CheckpointDelta.from_range("p0", start,
                                            c.offset_position(end))

    def query(self, **kw):
        if "states" in kw:
            kw["states"] = [self.split_md.SplitState(s) for s in kw["states"]]
        return self.ms.ListSplitsQuery(index_uids=["logs:01"], **kw)


def listed(splits):
    return [s.to_dict() for s in splits]


def ids(engine, *names):
    return [engine.ids[n] for n in names]


STEPS = [
    ("create_index", lambda e, m: m.create_index(e.index())),
    ("create_index_twice", lambda e, m: m.create_index(e.index())),
    ("create_second_index",
     lambda e, m: m.create_index(e.index("other", "07"))),
    ("index_metadata", lambda e, m: m.index_metadata("logs").to_dict()),
    ("stage_s1_s2", lambda e, m: m.stage_splits(
        "logs:01", [e.split("s1", 1), e.split("s2", 2)])),
    ("publish_with_delta", lambda e, m: m.publish_splits(
        "logs:01", ids(e, "s1", "s2"), source_id="src1",
        checkpoint_delta=e.delta(None, 100))),
    ("stage_s3", lambda e, m: m.stage_splits("logs:01",
                                             [e.split("s3", 3)])),
    ("replayed_delta_rejected", lambda e, m: m.publish_splits(
        "logs:01", ids(e, "s3"), source_id="src1",
        checkpoint_delta=e.delta(None, 100))),
    ("publish_next_delta", lambda e, m: m.publish_splits(
        "logs:01", ids(e, "s3"), source_id="src1",
        checkpoint_delta=e.delta(100, 250))),
    ("source_checkpoint",
     lambda e, m: m.source_checkpoint("logs:01", "src1").to_dict()),
    ("publish_unknown_split",
     lambda e, m: m.publish_splits("logs:01", ["nope"])),
    ("publish_twice", lambda e, m: m.publish_splits("logs:01",
                                                    ids(e, "s1"))),
    ("stage_on_unknown_uid", lambda e, m: m.stage_splits(
        "logs:99", [e.split("bad", 9, index_uid="logs:99")])),
    ("list_all", lambda e, m: listed(m.list_splits(e.query()))),
    ("list_time_range", lambda e, m: listed(m.list_splits(e.query(
        time_range_start=1_600_000_002_000_000,
        time_range_end=1_600_000_003_500_000)))),
    ("list_time_end_exclusive", lambda e, m: listed(m.list_splits(e.query(
        time_range_end=1_600_000_002_000_000)))),
    ("list_tags", lambda e, m: listed(m.list_splits(e.query(
        required_tags={"tenant:1"})))),
    ("list_published", lambda e, m: listed(m.list_splits(e.query(
        states=["Published"])))),
    ("stage_merged", lambda e, m: m.stage_splits(
        "logs:01", [e.split("merged", 4)])),
    ("publish_replacing", lambda e, m: m.publish_splits(
        "logs:01", ids(e, "merged"), replaced_split_ids=ids(e, "s1", "s2"))),
    ("list_marked", lambda e, m: listed(m.list_splits(e.query(
        states=["MarkedForDeletion"])))),
    ("delete_published_refused",
     lambda e, m: m.delete_splits("logs:01", ids(e, "s3"))),
    ("mark_s3", lambda e, m: m.mark_splits_for_deletion("logs:01",
                                                        ids(e, "s3"))),
    ("delete_marked", lambda e, m: m.delete_splits(
        "logs:01", ids(e, "s1", "s2", "s3"))),
    ("add_source", lambda e, m: m.add_source(
        "logs:01", e.index_md.SourceConfig("src2", "file",
                                           {"filepath": "/x"}))),
    ("add_source_twice", lambda e, m: m.add_source(
        "logs:01", e.index_md.SourceConfig("src2", "file"))),
    ("toggle_source", lambda e, m: m.toggle_source("logs:01", "src2",
                                                   False)),
    ("reset_source_checkpoint",
     lambda e, m: m.reset_source_checkpoint("logs:01", "src1")),
    ("delete_source", lambda e, m: m.delete_source("logs:01", "src2")),
    ("retention", lambda e, m: m.update_retention_policy(
        "logs:01", e.index_md.RetentionPolicy(period_seconds=60))),
    ("delete_task_1", lambda e, m: m.create_delete_task(
        "logs:01", {"type": "term", "field": "body", "value": "x"})),
    ("delete_task_2", lambda e, m: m.create_delete_task(
        "logs:01", {"type": "term", "field": "body", "value": "y"})),
    ("list_delete_tasks", lambda e, m: m.list_delete_tasks("logs:01", 1)),
    ("last_delete_opstamp", lambda e, m: m.last_delete_opstamp("logs:01")),
    ("update_delete_opstamp", lambda e, m: m.update_splits_delete_opstamp(
        "logs:01", ids(e, "merged"), 2)),
    ("shard_chain", lambda e, m: m.record_shard_chain(
        "logs:01", "src1", "shard-0", "node-0", "node-1")),
    ("read_shard_chain",
     lambda e, m: m.shard_chain("logs:01", "src1", "shard-0")),
    ("template", lambda e, m: m.create_index_template(
        {"template_id": "t1", "index_id_patterns": ["logs-*"],
         "priority": 3})),
    ("bad_template", lambda e, m: m.create_index_template(
        {"template_id": "t2", "index_id_patterns": []})),
    ("find_template", lambda e, m: m.find_index_template("logs-2024")),
    ("delete_template", lambda e, m: m.delete_index_template("t1")),
    ("delete_missing_template", lambda e, m: m.delete_index_template("t1")),
    ("list_indexes", lambda e, m: [i.to_dict() for i in m.list_indexes()]),
    ("reload", lambda e, m: (
        listed(e.ms.FileBackedMetastore(m.storage).list_splits(e.query())),
        e.ms.FileBackedMetastore(m.storage).index_metadata("logs").to_dict())),
    ("delete_index", lambda e, m: m.delete_index("other:07")),
    ("deleted_index_not_found", lambda e, m: m.index_metadata("other")),
]


def run_script(engine):
    """Every step's (outcome, files after it), under the seams."""
    storage = engine.storage.RamStorage(
        engine.uri.Uri.parse("ram:///metastore-parity"))
    records = {}
    with engine.clock.use_clock(engine.clock.FakeClock()), \
            engine.clock.use_rng(random.Random(SEED)):
        metastore = engine.ms.FileBackedMetastore(storage)
        for name, step in STEPS:
            engine.clock.get_clock().advance(1.25)
            try:
                outcome = ("ok", step(engine, metastore))
            except engine.ms.MetastoreError as exc:
                outcome = ("error", exc.kind, str(exc))
            files = {path: storage.get_all(path)
                     for path in sorted(storage.list_files())}
            records[name] = (outcome, files)
    return records


@pytest.fixture(scope="module")
def scripts():
    return run_script(Engine("jax")), run_script(Engine("torch"))


@pytest.mark.parametrize("step", [name for name, _ in STEPS])
def test_metastore_step_matches_jax(scripts, step):
    want, got = scripts[0][step], scripts[1][step]
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for path in want[1]:
        assert got[1][path] == want[1][path], path


def test_the_script_exercises_its_outcomes(scripts):
    """The script meets the outcomes it is there for: typed errors where
    the protocol refuses, and the JSON round trip of every bound kind."""
    _, got = scripts
    errors = {name: rec[0][1] for name, rec in got.items()
              if rec[0][0] == "error"}
    assert errors == {
        "create_index_twice": "already_exists",
        "replayed_delta_rejected": "failed_precondition",
        "publish_unknown_split": errors["publish_unknown_split"],
        "publish_twice": "failed_precondition",
        "stage_on_unknown_uid": "not_found",
        "delete_published_refused": errors["delete_published_refused"],
        "add_source_twice": errors["add_source_twice"],
        "bad_template": "invalid_argument",
        "delete_missing_template": "not_found",
        "deleted_index_not_found": "not_found",
    }
    splits = got["list_all"][0][1]
    assert len(splits) == 3
    bounds = splits[0]["metadata"]["column_bounds"]
    assert bounds["tenant"][1] > 2**63 and bounds["delta"][0] < -2**40
    assert len(got["list_time_range"][0][1]) == 2
    assert len(got["list_tags"][0][1]) == 2
    assert len(got["list_marked"][0][1]) == 2
