"""The port's SQL metastore (`metastore/sql.py`) against the JAX package's.

The SQL cases of `tests/test_metastore.py` run against the port's
`SqlMetastore`: the backend suite (create, lifecycle, the publish
protocol, replacement, exactly-once checkpoints, time and tag pruning,
deletion, sources, retention, delete tasks, uid checks), a reopen, the
transactional publish and a port node on `sqlite://`. Then the file
format: a database either package writes is read by the other with equal
listings, and a port node serves searches over a database the JAX
package filled.
"""

import pytest

from quickwit_tpu_torch.metastore import (
    CheckpointDelta, ListSplitsQuery, MetastoreError, SqlMetastore,
)
from quickwit_tpu_torch.metastore.checkpoint import BEGINNING, offset_position
from quickwit_tpu_torch.models import DocMapper, FieldMapping, FieldType, SplitMetadata
from quickwit_tpu_torch.models.index_metadata import IndexConfig, IndexMetadata, SourceConfig
from quickwit_tpu_torch.models.split_metadata import SplitState


def make_index_metadata(index_id="test-index"):
    mapper = DocMapper(field_mappings=[FieldMapping("body", FieldType.TEXT)])
    config = IndexConfig(index_id=index_id, index_uri=f"ram:///indexes/{index_id}",
                         doc_mapper=mapper)
    return IndexMetadata(index_uid=f"{index_id}:01", index_config=config,
                         sources={"src1": SourceConfig("src1", "vec")})


@pytest.fixture
def metastore(tmp_path):
    """The backend suite of `tests/test_metastore.py` (reference:
    metastore_test_suite! macro, quickwit-metastore/src/tests/mod.rs:208),
    on the port's SQL backend."""
    ms = SqlMetastore(str(tmp_path / "metastore.db"))
    ms.create_index(make_index_metadata())
    return ms


def split_md(split_id, index_uid="test-index:01", num_docs=100):
    return SplitMetadata(split_id=split_id, index_uid=index_uid, num_docs=num_docs,
                         source_id="src1")


def test_create_index_twice_fails(metastore):
    with pytest.raises(MetastoreError) as exc:
        metastore.create_index(make_index_metadata())
    assert exc.value.kind == "already_exists"


def test_index_lifecycle(metastore):
    assert metastore.index_metadata("test-index").index_uid == "test-index:01"
    assert len(metastore.list_indexes()) == 1
    metastore.delete_index("test-index:01")
    assert metastore.list_indexes() == []
    with pytest.raises(MetastoreError):
        metastore.index_metadata("test-index")


def test_publish_protocol(metastore):
    uid = "test-index:01"
    metastore.stage_splits(uid, [split_md("s1"), split_md("s2")])
    metastore.publish_splits(uid, ["s1", "s2"])
    published = metastore.list_splits(
        ListSplitsQuery(index_uids=[uid], states=[SplitState.PUBLISHED]))
    assert len(published) == 2
    # publishing a non-staged split fails
    with pytest.raises(MetastoreError) as exc:
        metastore.publish_splits(uid, ["s1"])
    assert exc.value.kind == "failed_precondition"
    # publishing an unknown split fails
    with pytest.raises(MetastoreError):
        metastore.publish_splits(uid, ["nope"])


def test_publish_with_replacement(metastore):
    uid = "test-index:01"
    metastore.stage_splits(uid, [split_md("s1"), split_md("s2")])
    metastore.publish_splits(uid, ["s1", "s2"])
    metastore.stage_splits(uid, [split_md("merged")])
    metastore.publish_splits(uid, ["merged"], replaced_split_ids=["s1", "s2"])
    published = metastore.list_splits(
        ListSplitsQuery(index_uids=[uid], states=[SplitState.PUBLISHED]))
    assert [s.metadata.split_id for s in published] == ["merged"]
    marked = metastore.list_splits(
        ListSplitsQuery(index_uids=[uid], states=[SplitState.MARKED_FOR_DELETION]))
    assert {s.metadata.split_id for s in marked} == {"s1", "s2"}


def test_exactly_once_checkpoint(metastore):
    uid = "test-index:01"
    delta1 = CheckpointDelta.from_range("p0", BEGINNING, offset_position(100))
    metastore.stage_splits(uid, [split_md("s1")])
    metastore.publish_splits(uid, ["s1"], source_id="src1", checkpoint_delta=delta1)
    # replaying the same delta is rejected (exactly-once)
    metastore.stage_splits(uid, [split_md("s2")])
    with pytest.raises(MetastoreError) as exc:
        metastore.publish_splits(uid, ["s2"], source_id="src1",
                                 checkpoint_delta=delta1)
    assert exc.value.kind == "failed_precondition"
    # and the failed publish did NOT publish the split (atomicity)
    staged = metastore.list_splits(
        ListSplitsQuery(index_uids=[uid], states=[SplitState.STAGED]))
    assert [s.metadata.split_id for s in staged] == ["s2"]
    # the contiguous next delta works
    delta2 = CheckpointDelta.from_range("p0", offset_position(100), offset_position(200))
    metastore.publish_splits(uid, ["s2"], source_id="src1", checkpoint_delta=delta2)
    checkpoint = metastore.source_checkpoint(uid, "src1")
    assert checkpoint.position_for("p0") == offset_position(200)


def test_list_splits_time_and_tag_pruning(metastore):
    uid = "test-index:01"
    s1 = SplitMetadata("s1", uid, num_docs=10, time_range_start=0,
                       time_range_end=999, tags=frozenset({"tenant_id:1"}))
    s2 = SplitMetadata("s2", uid, num_docs=10, time_range_start=1000,
                       time_range_end=1999, tags=frozenset({"tenant_id:2"}))
    metastore.stage_splits(uid, [s1, s2])
    metastore.publish_splits(uid, ["s1", "s2"])
    hits = metastore.list_splits(ListSplitsQuery(
        index_uids=[uid], time_range_start=1500, time_range_end=3000))
    assert [s.metadata.split_id for s in hits] == ["s2"]
    # end is exclusive
    hits = metastore.list_splits(ListSplitsQuery(index_uids=[uid], time_range_end=1000))
    assert [s.metadata.split_id for s in hits] == ["s1"]
    hits = metastore.list_splits(ListSplitsQuery(
        index_uids=[uid], required_tags={"tenant_id:2"}))
    assert [s.metadata.split_id for s in hits] == ["s2"]


def test_delete_splits_lifecycle(metastore):
    uid = "test-index:01"
    metastore.stage_splits(uid, [split_md("s1")])
    metastore.publish_splits(uid, ["s1"])
    with pytest.raises(MetastoreError):
        metastore.delete_splits(uid, ["s1"])  # published: refuse
    metastore.mark_splits_for_deletion(uid, ["s1"])
    metastore.delete_splits(uid, ["s1"])
    assert metastore.list_splits(ListSplitsQuery(index_uids=[uid])) == []


def test_sources(metastore):
    uid = "test-index:01"
    metastore.add_source(uid, SourceConfig("src2", "file", {"filepath": "/x"}))
    assert "src2" in metastore.index_metadata("test-index").sources
    with pytest.raises(MetastoreError):
        metastore.add_source(uid, SourceConfig("src2", "file"))
    metastore.toggle_source(uid, "src2", False)
    assert not metastore.index_metadata("test-index").sources["src2"].enabled
    metastore.delete_source(uid, "src2")
    assert "src2" not in metastore.index_metadata("test-index").sources


def test_update_retention_policy_persists_and_refresh(metastore):
    from quickwit_tpu_torch.models.index_metadata import RetentionPolicy
    uid = "test-index:01"
    metastore.update_retention_policy(uid, RetentionPolicy(period_seconds=60))
    metastore.refresh()  # survives a forced cache drop
    got = metastore.index_metadata("test-index").index_config.retention
    assert got is not None and got.period_seconds == 60
    metastore.update_retention_policy(uid, None)
    metastore.refresh()
    assert metastore.index_metadata("test-index").index_config.retention is None


def test_delete_tasks(metastore):
    uid = "test-index:01"
    op1 = metastore.create_delete_task(uid, {"type": "term", "field": "f", "value": "x"})
    op2 = metastore.create_delete_task(uid, {"type": "term", "field": "f", "value": "y"})
    assert op2 > op1
    assert metastore.last_delete_opstamp(uid) == op2
    tasks = metastore.list_delete_tasks(uid, opstamp_start=op1)
    assert len(tasks) == 1 and tasks[0]["opstamp"] == op2


def test_index_uid_mismatch_rejected(metastore):
    with pytest.raises(MetastoreError) as exc:
        metastore.stage_splits("test-index:99", [split_md("s1", "test-index:99")])
    assert exc.value.kind == "not_found"


def test_sql_metastore_survives_reopen(tmp_path):
    db = str(tmp_path / "reopen.db")
    ms1 = SqlMetastore(db)
    ms1.create_index(make_index_metadata())
    ms1.stage_splits("test-index:01", [split_md("s1")])
    ms1.publish_splits("test-index:01", ["s1"])
    del ms1

    ms2 = SqlMetastore(db)
    assert ms2.index_metadata("test-index").index_uid == "test-index:01"
    splits = ms2.list_splits(ListSplitsQuery(index_uids=["test-index:01"]))
    assert [s.metadata.split_id for s in splits] == ["s1"]
    assert splits[0].state is SplitState.PUBLISHED


def test_sql_publish_is_transactional(tmp_path):
    """A failing checkpoint apply must leave splits untouched (the SQL
    transaction is the atomicity boundary, like the reference's Postgres
    publish)."""
    ms = SqlMetastore(str(tmp_path / "tx.db"))
    ms.create_index(make_index_metadata())
    ms.stage_splits("test-index:01", [split_md("s1")])
    delta = CheckpointDelta.from_range("p1", BEGINNING, offset_position(10))
    ms.publish_splits("test-index:01", ["s1"], source_id="src1",
                      checkpoint_delta=delta)
    ms.stage_splits("test-index:01", [split_md("s2")])
    # overlapping delta: must fail and NOT publish s2
    with pytest.raises(MetastoreError):
        ms.publish_splits("test-index:01", ["s2"], source_id="src1",
                          checkpoint_delta=CheckpointDelta.from_range(
                              "p1", offset_position(5), offset_position(15)))
    splits = {s.metadata.split_id: s.state for s in ms.list_splits(
        ListSplitsQuery(index_uids=["test-index:01"]))}
    assert splits["s2"] is SplitState.STAGED


def test_node_runs_on_sqlite_metastore(tmp_path):
    from quickwit_tpu_torch.serve import Node, NodeConfig
    node = Node(NodeConfig(
        node_id="sql-node", rest_port=0,
        metastore_uri=f"sqlite://{tmp_path}/node-ms.db",
        default_index_root_uri="ram:///sqlms/indexes",
        data_dir=str(tmp_path / "data"), wal_fsync=False, device="cpu"))
    assert isinstance(node.metastore, SqlMetastore)
    node.index_service.create_index({
        "index_id": "sq", "doc_mapping": {"field_mappings": [
            {"name": "body", "type": "text"}],
            "default_search_fields": ["body"]}})
    node.ingest("sq", [{"body": "sqlite backed doc"}], commit="force")
    response = node.root_searcher.search(
        __import__("quickwit_tpu_torch.search.models",
                   fromlist=["SearchRequest"]).SearchRequest(
            index_ids=["sq"],
            query_ast=__import__("quickwit_tpu_torch.query.parser",
                                 fromlist=["parse_query_string"]
                                 ).parse_query_string("body:sqlite"),
            max_hits=5))
    assert response.num_hits == 1


# --- one database file, two packages -----------------------------------------

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def package(root):
    import importlib
    from types import SimpleNamespace

    def mod(path):
        return importlib.import_module(f"{root}.{path}")
    return SimpleNamespace(
        sql=mod("metastore.sql"), base=mod("metastore.base"),
        checkpoint=mod("metastore.checkpoint"), models=mod("models"),
        index=mod("models.index_metadata"),
        split=mod("models.split_metadata"))


def fill(q, db):
    """A script of writes through `q`'s `SqlMetastore`: two indexes,
    staged, published (with a checkpoint), replaced, marked and deleted
    splits with time ranges, tags and column bounds, sources, retention,
    delete tasks, a shard chain and a template."""
    ms = q.sql.SqlMetastore(db)
    for index_id in ("logs", "traces"):
        mapper = q.models.DocMapper(field_mappings=[
            q.models.FieldMapping("body", q.models.FieldType.TEXT),
            q.models.FieldMapping("n", q.models.FieldType.U64, fast=True)])
        ms.create_index(q.index.IndexMetadata(
            index_uid=f"{index_id}:01", index_config=q.index.IndexConfig(
                index_id=index_id, index_uri=f"file:///data/{index_id}",
                doc_mapper=mapper),
            sources={"src1": q.index.SourceConfig("src1", "vec")}))
    uid = "logs:01"
    splits = [q.models.SplitMetadata(
        split_id=f"s{i}", index_uid=uid, num_docs=100 + i,
        source_id="src1", time_range_start=1_000_000 * i,
        time_range_end=1_000_000 * i + 999_999,
        tags=frozenset({f"tenant:{i % 2}"}),
        column_bounds={"n": (i, 2**63 + i)}) for i in range(5)]
    ms.stage_splits(uid, splits)
    cp = q.checkpoint
    ms.publish_splits(uid, ["s0", "s1", "s2"], source_id="src1",
                      checkpoint_delta=cp.CheckpointDelta.from_range(
                          "p0", cp.BEGINNING, cp.offset_position(300)))
    ms.publish_splits(uid, ["s3"], replaced_split_ids=["s0"])
    ms.mark_splits_for_deletion(uid, ["s1"])
    ms.delete_splits(uid, ["s1"])
    ms.add_source(uid, q.index.SourceConfig("src2", "file",
                                            {"filepath": "/x"}))
    ms.toggle_source(uid, "src2", False)
    ms.update_retention_policy(uid, q.index.RetentionPolicy(
        period_seconds=3600))
    ms.create_delete_task(uid, {"type": "term", "field": "body",
                                "value": "x"})
    ms.create_delete_task(uid, {"type": "term", "field": "body",
                                "value": "y"})
    ms.record_shard_chain(uid, "src1", "shard-0", leader="a", follower="b")
    ms.create_index_template({"template_id": "t1",
                              "index_id_patterns": ["logs-*"]})
    ms.delete_index("traces:01")


def listing(q, db):
    """What `q`'s `SqlMetastore` reads back from `db`."""
    ms = q.sql.SqlMetastore(db)
    uid = "logs:01"
    return {
        "indexes": [m.to_dict() for m in ms.list_indexes()],
        "splits": [(s.state.value, s.metadata.to_dict(),
                    s.update_timestamp, s.publish_timestamp)
                   for s in ms.list_splits(q.base.ListSplitsQuery(
                       index_uids=[uid]))],
        "published_in_range": [s.metadata.split_id for s in ms.list_splits(
            q.base.ListSplitsQuery(
                index_uids=[uid], time_range_start=2_500_000,
                required_tags={"tenant:1"},
                states=[q.split.SplitState.PUBLISHED]))],
        "checkpoint": ms.source_checkpoint(uid, "src1").to_dict(),
        "delete_tasks": ms.list_delete_tasks(uid, opstamp_start=0),
        "last_opstamp": ms.last_delete_opstamp(uid),
        "chain": ms.shard_chain(uid, "src1", "shard-0"),
        "templates": ms.list_index_templates(),
    }


@pytest.mark.parametrize("writer", PACKAGES)
def test_a_database_reads_the_same_in_both_packages(tmp_path, writer):
    db = str(tmp_path / f"{writer}.db")
    fill(package(writer), db)
    jax_view = listing(package("quickwit_tpu"), db)
    port_view = listing(package("quickwit_tpu_torch"), db)
    assert port_view == jax_view
    assert [(s[0], s[1]["split_id"]) for s in port_view["splits"]] == [
        ("MarkedForDeletion", "s0"), ("Published", "s2"),
        ("Published", "s3"), ("Staged", "s4")]
    assert port_view["published_in_range"] == ["s3"]
    assert len(port_view["delete_tasks"]) == 2


def test_both_packages_write_equal_rows(tmp_path):
    """The same script gives the same rows in each package's database,
    but for the wall-clock timestamps the SQL backend stamps rows with."""
    import sqlite3

    def rows(db):
        conn = sqlite3.connect(db)
        try:
            tables = [r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "ORDER BY name")]
            return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                              key=repr) for t in tables}
        finally:
            conn.close()

    import json as _json

    def without_clock(value):
        if isinstance(value, str) and value.startswith("{"):
            value = _json.loads(value)
        if isinstance(value, dict):
            return {k: without_clock(v) for k, v in value.items()
                    if not k.endswith("_timestamp")}
        if isinstance(value, (list, tuple)):
            return [without_clock(v) for v in value]
        return value

    out = {}
    for root in PACKAGES:
        db = str(tmp_path / f"rows-{root}.db")
        fill(package(root), db)
        out[root] = without_clock(rows(db))
    assert out["quickwit_tpu_torch"] == out["quickwit_tpu"]


def test_port_node_serves_a_database_the_jax_node_filled(tmp_path):
    """A JAX node ingests into `sqlite://` + a `file://` index root; a
    port node on the CPU over the same database and files answers the
    same searches."""
    from quickwit_tpu.query.parser import parse_query_string as j_parse
    from quickwit_tpu.search.models import SearchRequest as JRequest
    from quickwit_tpu.serve import Node as JNode, NodeConfig as JConfig
    from quickwit_tpu_torch.query.parser import parse_query_string
    from quickwit_tpu_torch.search.models import SearchRequest
    from quickwit_tpu_torch.serve import Node, NodeConfig
    from test_torch_rest_api import force_python_paths

    common = dict(rest_port=0, metastore_uri=f"sqlite://{tmp_path}/ms.db",
                  default_index_root_uri=f"file://{tmp_path}/idx",
                  wal_fsync=False)
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        jax_node = JNode(JConfig(node_id="jax-sql", **common,
                                 data_dir=str(tmp_path / "jax")))
        jax_node.index_service.create_index({
            "index_id": "sq", "doc_mapping": {"field_mappings": [
                {"name": "body", "type": "text"},
                {"name": "n", "type": "u64", "fast": True}],
                "default_search_fields": ["body"]}})
        for batch in range(3):
            jax_node.ingest("sq", [{"body": f"sqlite doc w{i % 4}",
                                    "n": batch * 100 + i}
                                   for i in range(40)], commit="force")
    port_node = Node(NodeConfig(node_id="port-sql", **common,
                                data_dir=str(tmp_path / "port"),
                                device="cpu"))
    assert isinstance(port_node.metastore, SqlMetastore)
    assert ([m.to_dict() for m in port_node.metastore.list_indexes()]
            == [m.to_dict() for m in jax_node.metastore.list_indexes()])
    for query, kw in (("body:sqlite", {"max_hits": 5}),
                      ("body:w3", {"max_hits": 3, "aggs": {"by_n": {
                          "histogram": {"field": "n", "interval": 50}}}})):
        want = jax_node.root_searcher.search(JRequest(
            index_ids=["sq"], query_ast=j_parse(query), **kw))
        got = port_node.root_searcher.search(SearchRequest(
            index_ids=["sq"], query_ast=parse_query_string(query), **kw))
        assert got.num_hits == want.num_hits > 0
        assert ([(h.split_id, h.doc_id) for h in got.hits]
                == [(h.split_id, h.doc_id) for h in want.hits])
        assert got.aggregations == want.aggregations
