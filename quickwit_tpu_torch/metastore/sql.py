"""SQL metastore backend (sqlite3).

Role of the reference's `PostgresqlMetastore`
(`quickwit-metastore/src/metastore/postgres/metastore.rs:97`): the
second, transactional metastore implementation behind the same
`Metastore` interface — SQL transactions give the atomic
publish-splits/checkpoint cut-over instead of the file-backed
state-machine's compare-and-swap on an object-store file. This image
carries no Postgres server, so the stdlib `sqlite3` plays the SQL
engine; the schema and transaction layout translate to Postgres
directly (the reference's migrations create the same four tables:
indexes / splits / shards|checkpoints / delete_tasks).

Concurrency: one connection guarded by an RLock; every mutation is a
single `BEGIN IMMEDIATE` transaction so multi-process deployments
pointing at one database file serialize through sqlite's file locking,
and readers see only committed state (WAL mode).

Counterpart of the JAX package's `metastore/sql.py`, with the same schema
and row encoding: a database file either package writes is read by the
other. A node opens it for a `sqlite://<path>` metastore URI.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Iterable, Optional

from ..models.index_metadata import IndexMetadata, SourceConfig
from ..models.split_metadata import Split, SplitState
from .base import ListSplitsQuery, Metastore, MetastoreError
from .checkpoint import (CheckpointDelta, IncompatibleCheckpointDelta,
                         SourceCheckpoint)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS indexes (
    index_id  TEXT PRIMARY KEY,
    index_uid TEXT NOT NULL UNIQUE,
    metadata  TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS splits (
    index_uid TEXT NOT NULL,
    split_id  TEXT NOT NULL,
    state     TEXT NOT NULL,
    split     TEXT NOT NULL,
    PRIMARY KEY (index_uid, split_id)
);
CREATE INDEX IF NOT EXISTS splits_by_state ON splits (index_uid, state);
CREATE TABLE IF NOT EXISTS checkpoints (
    index_uid  TEXT NOT NULL,
    source_id  TEXT NOT NULL,
    checkpoint TEXT NOT NULL,
    PRIMARY KEY (index_uid, source_id)
);
CREATE TABLE IF NOT EXISTS shard_chains (
    index_uid TEXT NOT NULL,
    source_id TEXT NOT NULL,
    shard_id  TEXT NOT NULL,
    leader    TEXT NOT NULL,
    follower  TEXT,
    PRIMARY KEY (index_uid, source_id, shard_id)
);
CREATE TABLE IF NOT EXISTS delete_tasks (
    index_uid TEXT NOT NULL,
    opstamp   INTEGER NOT NULL,
    task      TEXT NOT NULL,
    PRIMARY KEY (index_uid, opstamp)
);
CREATE TABLE IF NOT EXISTS templates (
    template_id TEXT PRIMARY KEY,
    template    TEXT NOT NULL
);
"""


class SqlMetastore(Metastore):
    def __init__(self, db_path: str):
        if db_path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(db_path)),
                        exist_ok=True)
        # isolation_level=None: NO implicit transactions — every mutation
        # runs inside an explicit BEGIN IMMEDIATE (see _txn) so the
        # precondition SELECTs of publish_splits hold the write lock for
        # the whole check-then-act, across PROCESSES sharing the db file
        self._conn = sqlite3.connect(db_path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA busy_timeout=10000")
        self._conn.executescript(_SCHEMA)
        # qwlint: disable-next-line=QW008 - metastore leaf lock; pure dict/file
        # ops inside its critical sections
        self._lock = threading.RLock()

    # --- helpers ------------------------------------------------------
    def _tx(self):
        return self._lock

    class _Txn:
        def __init__(self, conn):
            self._conn = conn

        def __enter__(self):
            try:
                self._conn.execute("BEGIN IMMEDIATE")
            except sqlite3.OperationalError as exc:
                raise MetastoreError(f"metastore busy: {exc}",
                                     kind="unavailable") from exc
            return self._conn

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self._conn.execute("COMMIT")
            else:
                self._conn.execute("ROLLBACK")
            return False

    def _txn(self):
        return SqlMetastore._Txn(self._conn)

    def _index_row_by_uid(self, index_uid: str) -> IndexMetadata:
        index_id = index_uid.split(":", 1)[0]
        row = self._conn.execute(
            "SELECT index_uid, metadata FROM indexes WHERE index_id = ?",
            (index_id,)).fetchone()
        if row is None:
            raise MetastoreError(f"index {index_id!r} not found",
                                 kind="not_found")
        if row[0] != index_uid:
            raise MetastoreError(
                f"index uid mismatch: {index_uid!r} (current incarnation: "
                f"{row[0]!r})", kind="not_found")
        return IndexMetadata.from_dict(json.loads(row[1]))

    def _save_metadata(self, metadata: IndexMetadata) -> None:
        self._conn.execute(
            "UPDATE indexes SET metadata = ? WHERE index_uid = ?",
            (json.dumps(metadata.to_dict()), metadata.index_uid))

    # --- index lifecycle ----------------------------------------------
    def create_index(self, index_metadata: IndexMetadata) -> None:
        with self._tx():
            try:
                with self._txn():
                    self._conn.execute(
                        "INSERT INTO indexes (index_id, index_uid, metadata)"
                        " VALUES (?, ?, ?)",
                        (index_metadata.index_id, index_metadata.index_uid,
                         json.dumps(index_metadata.to_dict())))
                    for source_id in index_metadata.sources:
                        self._conn.execute(
                            "INSERT OR IGNORE INTO checkpoints VALUES "
                            "(?, ?, ?)",
                            (index_metadata.index_uid, source_id,
                             json.dumps(SourceCheckpoint().to_dict())))
            except sqlite3.IntegrityError:
                raise MetastoreError(
                    f"index {index_metadata.index_id!r} already exists",
                    kind="already_exists")

    def delete_index(self, index_uid: str) -> None:
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            for table in ("splits", "checkpoints", "shard_chains",
                          "delete_tasks"):
                self._conn.execute(
                    f"DELETE FROM {table} WHERE index_uid = ?",  # noqa: S608
                    (index_uid,))
            self._conn.execute(
                "DELETE FROM indexes WHERE index_uid = ?", (index_uid,))

    def index_metadata(self, index_id: str) -> IndexMetadata:
        with self._tx():
            row = self._conn.execute(
                "SELECT metadata FROM indexes WHERE index_id = ?",
                (index_id,)).fetchone()
            if row is None:
                raise MetastoreError(f"index {index_id!r} not found",
                                     kind="not_found")
            return IndexMetadata.from_dict(json.loads(row[0]))

    def index_metadata_by_uid(self, index_uid: str) -> IndexMetadata:
        with self._tx():
            return self._index_row_by_uid(index_uid)

    def list_indexes(self) -> list[IndexMetadata]:
        with self._tx():
            rows = self._conn.execute(
                "SELECT metadata FROM indexes ORDER BY index_id").fetchall()
            return [IndexMetadata.from_dict(json.loads(r[0])) for r in rows]

    # --- sources ------------------------------------------------------
    def add_source(self, index_uid: str, source: SourceConfig) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            if source.source_id in metadata.sources:
                raise MetastoreError(
                    f"source {source.source_id!r} already exists",
                    kind="already_exists")
            metadata.sources[source.source_id] = source
            self._save_metadata(metadata)
            self._conn.execute(
                "INSERT OR IGNORE INTO checkpoints VALUES (?, ?, ?)",
                (index_uid, source.source_id,
                 json.dumps(SourceCheckpoint().to_dict())))

    def delete_source(self, index_uid: str, source_id: str) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            if metadata.sources.pop(source_id, None) is None:
                raise MetastoreError(f"source {source_id!r} not found",
                                     kind="not_found")
            self._save_metadata(metadata)
            self._conn.execute(
                "DELETE FROM checkpoints WHERE index_uid = ? AND "
                "source_id = ?", (index_uid, source_id))

    def update_retention_policy(self, index_uid: str, retention) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            metadata.index_config.retention = retention
            self._save_metadata(metadata)

    def update_index_config(self, index_uid: str, index_config) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            metadata.index_config = index_config
            self._save_metadata(metadata)

    def toggle_source(self, index_uid: str, source_id: str,
                      enable: bool) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            source = metadata.sources.get(source_id)
            if source is None:
                raise MetastoreError(f"source {source_id!r} not found",
                                     kind="not_found")
            source.enabled = enable
            self._save_metadata(metadata)

    def reset_source_checkpoint(self, index_uid: str, source_id: str) -> None:
        with self._tx(), self._txn():
            metadata = self._index_row_by_uid(index_uid)
            if source_id not in metadata.sources:
                raise MetastoreError(f"source {source_id!r} not found",
                                     kind="not_found")
            self._conn.execute(
                "INSERT OR REPLACE INTO checkpoints VALUES (?, ?, ?)",
                (index_uid, source_id,
                 json.dumps(SourceCheckpoint().to_dict())))

    def source_checkpoint(self, index_uid: str,
                          source_id: str) -> SourceCheckpoint:
        with self._tx():
            self._index_row_by_uid(index_uid)
            row = self._conn.execute(
                "SELECT checkpoint FROM checkpoints WHERE index_uid = ? "
                "AND source_id = ?", (index_uid, source_id)).fetchone()
            if row is None:
                return SourceCheckpoint()
            return SourceCheckpoint.from_dict(json.loads(row[0]))

    # --- replication chain registry -----------------------------------
    def record_shard_chain(self, index_uid: str, source_id: str,
                           shard_id: str, leader: str,
                           follower: Optional[str]) -> None:
        with self._tx(), self._txn():
            self._index_row_by_uid(index_uid)
            self._conn.execute(
                "INSERT OR REPLACE INTO shard_chains VALUES (?, ?, ?, ?, ?)",
                (index_uid, source_id, shard_id, leader, follower))

    def shard_chain(self, index_uid: str, source_id: str,
                    shard_id: str) -> Optional[dict]:
        with self._tx():
            self._index_row_by_uid(index_uid)
            row = self._conn.execute(
                "SELECT leader, follower FROM shard_chains WHERE "
                "index_uid = ? AND source_id = ? AND shard_id = ?",
                (index_uid, source_id, shard_id)).fetchone()
            if row is None:
                return None
            return {"leader": row[0], "follower": row[1]}

    # --- splits -------------------------------------------------------
    def stage_splits(self, index_uid: str, split_metadatas) -> None:
        now = int(time.time())
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            for md in split_metadatas:
                row = self._conn.execute(
                    "SELECT state FROM splits WHERE index_uid = ? AND "
                    "split_id = ?", (index_uid, md.split_id)).fetchone()
                if row is not None and row[0] != SplitState.STAGED.value:
                    raise MetastoreError(
                        f"split {md.split_id!r} exists in state {row[0]}",
                        kind="failed_precondition")
                split = Split(metadata=md, state=SplitState.STAGED,
                              update_timestamp=now)
                self._conn.execute(
                    "INSERT OR REPLACE INTO splits VALUES (?, ?, ?, ?)",
                    (index_uid, md.split_id, SplitState.STAGED.value,
                     json.dumps(split.to_dict())))

    def publish_splits(self, index_uid: str, staged_split_ids: list[str],
                       replaced_split_ids: Iterable[str] = (),
                       source_id: Optional[str] = None,
                       checkpoint_delta: Optional[CheckpointDelta] = None
                       ) -> None:
        now = int(time.time())
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            # one transaction: all-or-nothing cut-over
            splits = {}
            for split_id in staged_split_ids:
                row = self._conn.execute(
                    "SELECT state, split FROM splits WHERE index_uid = ?"
                    " AND split_id = ?",
                    (index_uid, split_id)).fetchone()
                if row is None:
                    raise MetastoreError(
                        f"split {split_id!r} not found", kind="not_found")
                if row[0] != SplitState.STAGED.value:
                    raise MetastoreError(
                        f"split {split_id!r} is {row[0]}, not staged",
                        kind="failed_precondition")
                splits[split_id] = Split.from_dict(json.loads(row[1]))
            replaced = list(replaced_split_ids)
            for split_id in replaced:
                row = self._conn.execute(
                    "SELECT state, split FROM splits WHERE index_uid = ?"
                    " AND split_id = ?",
                    (index_uid, split_id)).fetchone()
                if row is None or row[0] != SplitState.PUBLISHED.value:
                    raise MetastoreError(
                        f"replaced split {split_id!r} is not published",
                        kind="failed_precondition")
                splits[split_id] = Split.from_dict(json.loads(row[1]))
            if checkpoint_delta is not None and not checkpoint_delta.is_empty:
                if source_id is None:
                    raise MetastoreError(
                        "checkpoint delta requires source_id")
                row = self._conn.execute(
                    "SELECT checkpoint FROM checkpoints WHERE "
                    "index_uid = ? AND source_id = ?",
                    (index_uid, source_id)).fetchone()
                checkpoint = (SourceCheckpoint.from_dict(
                    json.loads(row[0])) if row else SourceCheckpoint())
                try:
                    checkpoint.try_apply_delta(checkpoint_delta)
                except IncompatibleCheckpointDelta as exc:
                    raise MetastoreError(
                        str(exc), kind="failed_precondition") from exc
                self._conn.execute(
                    "INSERT OR REPLACE INTO checkpoints VALUES (?, ?, ?)",
                    (index_uid, source_id,
                     json.dumps(checkpoint.to_dict())))
            for split_id in staged_split_ids:
                split = splits[split_id]
                split.state = SplitState.PUBLISHED
                split.update_timestamp = now
                split.publish_timestamp = now
                self._conn.execute(
                    "UPDATE splits SET state = ?, split = ? WHERE "
                    "index_uid = ? AND split_id = ?",
                    (split.state.value, json.dumps(split.to_dict()),
                     index_uid, split_id))
            for split_id in replaced:
                split = splits[split_id]
                split.state = SplitState.MARKED_FOR_DELETION
                split.update_timestamp = now
                self._conn.execute(
                    "UPDATE splits SET state = ?, split = ? WHERE "
                    "index_uid = ? AND split_id = ?",
                    (split.state.value, json.dumps(split.to_dict()),
                     index_uid, split_id))

    def list_splits(self, query: ListSplitsQuery) -> list[Split]:
        with self._tx():
            if query.index_uids is not None:
                if not query.index_uids:
                    return []
                for uid in query.index_uids:
                    self._index_row_by_uid(uid)
                placeholders = ",".join("?" * len(query.index_uids))
                rows = self._conn.execute(
                    f"SELECT split FROM splits WHERE index_uid IN "  # noqa: S608
                    f"({placeholders})", tuple(query.index_uids)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT split FROM splits").fetchall()
            splits = [Split.from_dict(json.loads(r[0])) for r in rows]
            return sorted((s for s in splits if query.matches(s)),
                          key=lambda s: s.metadata.split_id)

    def mark_splits_for_deletion(self, index_uid: str,
                                 split_ids: Iterable[str]) -> None:
        now = int(time.time())
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            for split_id in split_ids:
                row = self._conn.execute(
                    "SELECT split FROM splits WHERE index_uid = ? AND "
                    "split_id = ?", (index_uid, split_id)).fetchone()
                if row is None:
                    continue
                split = Split.from_dict(json.loads(row[0]))
                if split.state is not SplitState.MARKED_FOR_DELETION:
                    split.state = SplitState.MARKED_FOR_DELETION
                    split.update_timestamp = now
                    self._conn.execute(
                        "UPDATE splits SET state = ?, split = ? WHERE "
                        "index_uid = ? AND split_id = ?",
                        (split.state.value, json.dumps(split.to_dict()),
                         index_uid, split_id))

    def delete_splits(self, index_uid: str,
                      split_ids: Iterable[str]) -> None:
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            for split_id in split_ids:
                row = self._conn.execute(
                    "SELECT state FROM splits WHERE index_uid = ? AND "
                    "split_id = ?", (index_uid, split_id)).fetchone()
                if row is None:
                    continue
                if row[0] == SplitState.PUBLISHED.value:
                    raise MetastoreError(
                        f"cannot delete published split {split_id!r}",
                        kind="failed_precondition")
                self._conn.execute(
                    "DELETE FROM splits WHERE index_uid = ? AND "
                    "split_id = ?", (index_uid, split_id))

    # --- delete tasks -------------------------------------------------
    def create_delete_task(self, index_uid: str, query_ast_json: dict) -> int:
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            row = self._conn.execute(
                "SELECT COALESCE(MAX(opstamp), 0) FROM delete_tasks "
                "WHERE index_uid = ?", (index_uid,)).fetchone()
            opstamp = int(row[0]) + 1
            task = {"opstamp": opstamp,
                    "create_timestamp": int(time.time()),
                    "query_ast": query_ast_json}
            self._conn.execute(
                "INSERT INTO delete_tasks VALUES (?, ?, ?)",
                (index_uid, opstamp, json.dumps(task)))
            return opstamp

    def list_delete_tasks(self, index_uid: str,
                          opstamp_start: int = 0) -> list[dict]:
        with self._tx():
            self._index_row_by_uid(index_uid)
            rows = self._conn.execute(
                "SELECT task FROM delete_tasks WHERE index_uid = ? AND "
                "opstamp > ? ORDER BY opstamp",
                (index_uid, opstamp_start)).fetchall()
            return [json.loads(r[0]) for r in rows]

    def last_delete_opstamp(self, index_uid: str) -> int:
        with self._tx():
            self._index_row_by_uid(index_uid)
            row = self._conn.execute(
                "SELECT COALESCE(MAX(opstamp), 0) FROM delete_tasks WHERE "
                "index_uid = ?", (index_uid,)).fetchone()
            return int(row[0])

    def update_splits_delete_opstamp(self, index_uid: str,
                                     split_ids: Iterable[str],
                                     opstamp: int) -> None:
        with self._tx(), self._txn():
            # the existence/incarnation check runs INSIDE the transaction:
            # BEGIN IMMEDIATE holds the write lock across the whole
            # check-then-act even between processes
            self._index_row_by_uid(index_uid)
            for split_id in split_ids:
                row = self._conn.execute(
                    "SELECT split FROM splits WHERE index_uid = ? AND "
                    "split_id = ?", (index_uid, split_id)).fetchone()
                if row is None:
                    continue
                split = Split.from_dict(json.loads(row[0]))
                split.metadata.delete_opstamp = opstamp
                self._conn.execute(
                    "UPDATE splits SET split = ? WHERE index_uid = ? "
                    "AND split_id = ?",
                    (json.dumps(split.to_dict()), index_uid, split_id))

    # --- index templates ----------------------------------------------
    def create_index_template(self, template: dict) -> None:
        self.validate_template(template)
        with self._tx(), self._txn():
            self._conn.execute(
                "INSERT OR REPLACE INTO templates VALUES (?, ?)",
                (template["template_id"], json.dumps(template)))

    def list_index_templates(self) -> list[dict]:
        with self._tx():
            rows = self._conn.execute(
                "SELECT template FROM templates ORDER BY template_id"
            ).fetchall()
            return [json.loads(r[0]) for r in rows]

    def delete_index_template(self, template_id: str) -> None:
        with self._tx(), self._txn():
            cursor = self._conn.execute(
                "DELETE FROM templates WHERE template_id = ?",
                (template_id,))
            if cursor.rowcount == 0:
                raise MetastoreError(f"template {template_id!r} not found",
                                     kind="not_found")

