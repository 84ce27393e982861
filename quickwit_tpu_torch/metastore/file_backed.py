"""File-backed metastore: per-index JSON state on object storage.

Role of the reference's `FileBackedMetastore`
(`quickwit-metastore/src/metastore/file_backed/mod.rs:154`): each index's
full state (metadata, sources, splits, checkpoints, delete tasks) serializes
to one JSON object at `{index_id}/metastore.json`; writes go through an
in-process per-index lock and land with a version counter for
lost-update detection; an `indexes.json` manifest lists live indexes
(reference `manifest.rs`).

Suited to a single metastore node per cluster (like the reference's
file-backed mode); the write-proxying via the control plane keeps other
nodes' views coherent (`control_plane_metastore.rs`).
"""

from __future__ import annotations

import json
import threading
from typing import Iterable, Optional

from ..common.clock import monotonic, wall_time
from ..models.index_metadata import IndexMetadata, SourceConfig
from ..models.split_metadata import Split, SplitMetadata, SplitState
from ..storage.base import Storage, StorageError
from .base import ListSplitsQuery, Metastore, MetastoreError
from .checkpoint import CheckpointDelta, IncompatibleCheckpointDelta, SourceCheckpoint

MANIFEST_PATH = "indexes.json"
TEMPLATES_PATH = "templates.json"


def _state_path(index_id: str) -> str:
    return f"{index_id}/metastore.json"


class _IndexState:
    """In-memory image of one index's metastore file."""

    def __init__(self, metadata: IndexMetadata):
        self.loaded_at = monotonic()
        self.metadata = metadata
        self.splits: dict[str, Split] = {}
        self.checkpoints: dict[str, SourceCheckpoint] = {}
        # source_id -> shard_id -> {"leader": node, "follower": node|None}
        self.shard_chains: dict[str, dict[str, dict]] = {}
        self.delete_tasks: list[dict] = []
        self.last_delete_opstamp = 0
        self.version = 0
        self.discarded = False

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "metadata": self.metadata.to_dict(),
            "splits": [s.to_dict() for s in self.splits.values()],
            "checkpoints": {sid: cp.to_dict() for sid, cp in self.checkpoints.items()},
            "shard_chains": self.shard_chains,
            "delete_tasks": self.delete_tasks,
            "last_delete_opstamp": self.last_delete_opstamp,
        }

    @staticmethod
    def from_dict(d: dict) -> "_IndexState":
        state = _IndexState(IndexMetadata.from_dict(d["metadata"]))
        state.version = d.get("version", 0)
        for split_dict in d.get("splits", []):
            split = Split.from_dict(split_dict)
            state.splits[split.metadata.split_id] = split
        state.checkpoints = {
            sid: SourceCheckpoint.from_dict(cp)
            for sid, cp in d.get("checkpoints", {}).items()
        }
        state.shard_chains = d.get("shard_chains", {})
        state.delete_tasks = d.get("delete_tasks", [])
        state.last_delete_opstamp = d.get("last_delete_opstamp", 0)
        return state


class FileBackedMetastore(Metastore):
    def __init__(self, storage: Storage, polling_interval_secs: Optional[float] = 30.0):
        """`polling_interval_secs`: cached per-index state older than this is
        re-read from storage before serving reads, so other nodes' writes
        become visible (the reference's file-backed polling). Writes always
        persist immediately, so a reload never loses local mutations; like
        the reference, concurrent WRITERS on one index are not supported
        (single metastore-writer deployment)."""
        self.storage = storage
        # qwlint: disable-next-line=QW008 - metastore leaf lock; pure dict/file
        # ops inside its critical sections
        self._lock = threading.RLock()
        self._states: dict[str, _IndexState] = {}  # index_id -> state
        self._manifest: Optional[dict[str, str]] = None  # index_id -> index_uid
        self._manifest_loaded_at = 0.0
        self.polling_interval_secs = polling_interval_secs

    def refresh(self) -> None:
        """Invalidate the polling cache: the next read of the manifest or
        any index state re-fetches from storage, making other nodes'
        committed writes visible NOW (the GC orphan scan depends on this
        to never treat a just-staged split as an orphan). The cache is
        DROPPED, not just aged, so the contract also holds with
        polling_interval_secs=None (whose freshness check would otherwise
        serve any cached state forever)."""
        with self._lock:
            self._manifest = None
            self._manifest_loaded_at = 0.0
            self._states.clear()

    # --- manifest ----------------------------------------------------------
    def _load_manifest(self) -> dict[str, str]:
        stale = (self._manifest is not None
                 and self.polling_interval_secs is not None
                 and monotonic() - self._manifest_loaded_at
                 > self.polling_interval_secs)
        if self._manifest is None or stale:
            try:
                self._manifest = json.loads(self.storage.get_all(MANIFEST_PATH))
            except StorageError:
                if self._manifest is None:
                    self._manifest = {}
            self._manifest_loaded_at = monotonic()
        return self._manifest

    def _save_manifest(self) -> None:
        self.storage.put(MANIFEST_PATH,
                         json.dumps(self._manifest, indent=1).encode())

    # --- state io ----------------------------------------------------------
    def _load_state(self, index_id: str) -> _IndexState:
        state = self._states.get(index_id)
        fresh = (state is not None and not state.discarded
                 and (self.polling_interval_secs is None
                      or monotonic() - state.loaded_at
                      < self.polling_interval_secs))
        if fresh:
            return state
        try:
            raw = self.storage.get_all(_state_path(index_id))
        except StorageError:
            if state is not None and not state.discarded:
                # Distinguish "another node deleted the index" from a
                # transient storage blip: a fresh manifest read that no
                # longer lists the index means deleted — drop the cache.
                try:
                    manifest = json.loads(self.storage.get_all(MANIFEST_PATH))
                except StorageError:
                    return state  # storage blip: keep serving the cache
                self._manifest = manifest
                self._manifest_loaded_at = monotonic()
                if index_id in manifest:
                    return state  # index exists, state read blipped
                self._states.pop(index_id, None)
            raise MetastoreError(f"index {index_id!r} not found", kind="not_found")
        state = _IndexState.from_dict(json.loads(raw))
        self._states[index_id] = state
        return state

    def _save_state(self, state: _IndexState) -> None:
        # Optimistic lost-update detection (reference keeps a version in the
        # per-index file for the same purpose): if the stored version moved
        # past the one we loaded, or the stored file belongs to a different
        # incarnation (deleted + recreated under the same id), another
        # writer raced us — fail the write instead of silently overwriting
        # their splits/checkpoints. Not a true CAS (storage has no
        # conditional put) but catches the common race; background writers
        # are additionally partitioned per index by rendezvous ownership
        # (serve/node.py). Skipped in explicit single-writer mode
        # (polling_interval_secs=None) to keep mutations one storage op.
        if self.polling_interval_secs is not None:
            index_id = state.metadata.index_id
            try:
                stored = json.loads(self.storage.get_all(_state_path(index_id)))
                stored_version = stored.get("version", 0)
                stored_uid = stored.get("metadata", {}).get("index_uid")
            except StorageError:
                stored_version, stored_uid = 0, None  # first write
            conflict = (stored_version > state.version
                        or (stored_uid is not None
                            and stored_uid != state.metadata.index_uid))
            if conflict:
                self._states.pop(index_id, None)  # force reload
                raise MetastoreError(
                    f"concurrent modification of index {index_id!r} detected "
                    f"(stored version {stored_version}, uid {stored_uid!r} vs "
                    f"loaded {state.version}, {state.metadata.index_uid!r}); "
                    f"retry", kind="failed_precondition")
        state.loaded_at = monotonic()  # our write IS the latest state
        state.version += 1
        self.storage.put(_state_path(state.metadata.index_id),
                         json.dumps(state.to_dict()).encode())

    def _state_by_uid(self, index_uid: str) -> _IndexState:
        index_id = index_uid.split(":", 1)[0]
        state = self._load_state(index_id)
        if state.metadata.index_uid != index_uid:
            raise MetastoreError(
                f"index uid mismatch: {index_uid!r} (current incarnation: "
                f"{state.metadata.index_uid!r})", kind="not_found")
        return state

    # --- index templates ---------------------------------------------------
    # (reference: quickwit-config/src/index_template/mod.rs — templates match
    # index-id patterns and seed auto-created indexes)
    def _load_templates(self) -> list[dict]:
        try:
            return json.loads(self.storage.get_all(TEMPLATES_PATH))
        except StorageError:
            return []

    def create_index_template(self, template: dict) -> None:
        self.validate_template(template)
        with self._lock:
            templates = [t for t in self._load_templates()
                         if t["template_id"] != template["template_id"]]
            templates.append(template)
            self.storage.put(TEMPLATES_PATH, json.dumps(templates).encode())

    def list_index_templates(self) -> list[dict]:
        with self._lock:
            return self._load_templates()

    def delete_index_template(self, template_id: str) -> None:
        with self._lock:
            templates = self._load_templates()
            kept = [t for t in templates if t["template_id"] != template_id]
            if len(kept) == len(templates):
                raise MetastoreError(f"template {template_id!r} not found",
                                     kind="not_found")
            self.storage.put(TEMPLATES_PATH, json.dumps(kept).encode())


    # --- index lifecycle ---------------------------------------------------
    def create_index(self, index_metadata: IndexMetadata) -> None:
        with self._lock:
            manifest = self._load_manifest()
            index_id = index_metadata.index_id
            if index_id in manifest:
                raise MetastoreError(f"index {index_id!r} already exists",
                                     kind="already_exists")
            state = _IndexState(index_metadata)
            for source_id in index_metadata.sources:
                state.checkpoints[source_id] = SourceCheckpoint()
            self._states[index_id] = state
            self._save_state(state)
            manifest[index_id] = index_metadata.index_uid
            self._save_manifest()

    def delete_index(self, index_uid: str) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            index_id = state.metadata.index_id
            manifest = self._load_manifest()
            manifest.pop(index_id, None)
            self._save_manifest()
            state.discarded = True
            self._states.pop(index_id, None)
            try:
                self.storage.delete(_state_path(index_id))
            except StorageError:
                pass

    def index_metadata(self, index_id: str) -> IndexMetadata:
        with self._lock:
            return self._load_state(index_id).metadata

    def index_metadata_by_uid(self, index_uid: str) -> IndexMetadata:
        with self._lock:
            return self._state_by_uid(index_uid).metadata

    def list_indexes(self) -> list[IndexMetadata]:
        with self._lock:
            manifest = self._load_manifest()
            out = []
            for index_id in sorted(manifest):
                try:
                    out.append(self._load_state(index_id).metadata)
                except MetastoreError:
                    continue
            return out

    # --- sources -----------------------------------------------------------
    def add_source(self, index_uid: str, source: SourceConfig) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            if source.source_id in state.metadata.sources:
                raise MetastoreError(f"source {source.source_id!r} already exists",
                                     kind="already_exists")
            state.metadata.sources[source.source_id] = source
            state.checkpoints.setdefault(source.source_id, SourceCheckpoint())
            self._save_state(state)

    def delete_source(self, index_uid: str, source_id: str) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            if state.metadata.sources.pop(source_id, None) is None:
                raise MetastoreError(f"source {source_id!r} not found", kind="not_found")
            state.checkpoints.pop(source_id, None)
            self._save_state(state)

    def update_retention_policy(self, index_uid: str, retention) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            state.metadata.index_config.retention = retention
            self._save_state(state)

    def update_index_config(self, index_uid: str, index_config) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            state.metadata.index_config = index_config
            self._save_state(state)

    def toggle_source(self, index_uid: str, source_id: str, enable: bool) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            source = state.metadata.sources.get(source_id)
            if source is None:
                raise MetastoreError(f"source {source_id!r} not found", kind="not_found")
            source.enabled = enable
            self._save_state(state)

    def reset_source_checkpoint(self, index_uid: str, source_id: str) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            if source_id not in state.metadata.sources:
                raise MetastoreError(f"source {source_id!r} not found",
                                     kind="not_found")
            state.checkpoints[source_id] = SourceCheckpoint()
            self._save_state(state)

    def source_checkpoint(self, index_uid: str, source_id: str) -> SourceCheckpoint:
        with self._lock:
            state = self._state_by_uid(index_uid)
            return SourceCheckpoint.from_dict(
                state.checkpoints.get(source_id, SourceCheckpoint()).to_dict())

    # --- replication chain registry ------------------------------------------
    def record_shard_chain(self, index_uid: str, source_id: str,
                           shard_id: str, leader: str,
                           follower: Optional[str]) -> None:
        # Chain changes are rare (follower re-pick, promotion) but must win
        # against a concurrently-drained checkpoint CAS: retry once through
        # a cache drop, like a node's next poll tick would.
        record = {"leader": leader, "follower": follower}
        for attempt in (0, 1):
            with self._lock:
                try:
                    state = self._state_by_uid(index_uid)
                    state.shard_chains.setdefault(source_id, {})[shard_id] = \
                        dict(record)
                    self._save_state(state)
                    return
                except MetastoreError as exc:
                    if attempt or exc.kind != "failed_precondition":
                        raise
                    self.refresh()

    def shard_chain(self, index_uid: str, source_id: str,
                    shard_id: str) -> Optional[dict]:
        with self._lock:
            state = self._state_by_uid(index_uid)
            record = state.shard_chains.get(source_id, {}).get(shard_id)
            return dict(record) if record is not None else None

    # --- splits --------------------------------------------------------------
    def stage_splits(self, index_uid: str, split_metadatas: list[SplitMetadata]) -> None:
        now = int(wall_time())
        with self._lock:
            state = self._state_by_uid(index_uid)
            for md in split_metadatas:
                existing = state.splits.get(md.split_id)
                if existing is not None and existing.state is not SplitState.STAGED:
                    raise MetastoreError(
                        f"split {md.split_id!r} exists in state {existing.state}",
                        kind="failed_precondition")
                state.splits[md.split_id] = Split(
                    metadata=md, state=SplitState.STAGED, update_timestamp=now)
            self._save_state(state)

    def publish_splits(
        self,
        index_uid: str,
        staged_split_ids: list[str],
        replaced_split_ids: Iterable[str] = (),
        source_id: Optional[str] = None,
        checkpoint_delta: Optional[CheckpointDelta] = None,
    ) -> None:
        now = int(wall_time())
        with self._lock:
            state = self._state_by_uid(index_uid)
            # validate everything before mutating anything (atomicity)
            for split_id in staged_split_ids:
                split = state.splits.get(split_id)
                if split is None:
                    raise MetastoreError(f"split {split_id!r} not found",
                                         kind="not_found")
                if split.state is not SplitState.STAGED:
                    raise MetastoreError(
                        f"split {split_id!r} is {split.state}, not staged",
                        kind="failed_precondition")
            replaced = list(replaced_split_ids)
            for split_id in replaced:
                split = state.splits.get(split_id)
                if split is None or split.state is not SplitState.PUBLISHED:
                    raise MetastoreError(
                        f"replaced split {split_id!r} is not published",
                        kind="failed_precondition")
            if checkpoint_delta is not None and not checkpoint_delta.is_empty:
                if source_id is None:
                    raise MetastoreError("checkpoint delta requires source_id")
                checkpoint = state.checkpoints.setdefault(source_id, SourceCheckpoint())
                try:
                    checkpoint.try_apply_delta(checkpoint_delta)
                except IncompatibleCheckpointDelta as exc:
                    raise MetastoreError(str(exc), kind="failed_precondition") from exc
            for split_id in staged_split_ids:
                split = state.splits[split_id]
                split.state = SplitState.PUBLISHED
                split.update_timestamp = now
                split.publish_timestamp = now
            for split_id in replaced:
                split = state.splits[split_id]
                split.state = SplitState.MARKED_FOR_DELETION
                split.update_timestamp = now
            self._save_state(state)

    def list_splits(self, query: ListSplitsQuery) -> list[Split]:
        with self._lock:
            if query.index_uids is not None:
                states = [self._state_by_uid(uid) for uid in query.index_uids]
            else:
                states = [self._load_state(i) for i in self._load_manifest()]
            out = []
            for state in states:
                out.extend(s for s in state.splits.values() if query.matches(s))
            return sorted(out, key=lambda s: s.metadata.split_id)

    def mark_splits_for_deletion(self, index_uid: str, split_ids: Iterable[str]) -> None:
        now = int(wall_time())
        with self._lock:
            state = self._state_by_uid(index_uid)
            for split_id in split_ids:
                split = state.splits.get(split_id)
                if split is None:
                    continue
                if split.state is not SplitState.MARKED_FOR_DELETION:
                    split.state = SplitState.MARKED_FOR_DELETION
                    split.update_timestamp = now
            self._save_state(state)

    def delete_splits(self, index_uid: str, split_ids: Iterable[str]) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            for split_id in split_ids:
                split = state.splits.get(split_id)
                if split is None:
                    continue
                if split.state is SplitState.PUBLISHED:
                    raise MetastoreError(
                        f"cannot delete published split {split_id!r}",
                        kind="failed_precondition")
                del state.splits[split_id]
            self._save_state(state)

    # --- delete tasks --------------------------------------------------------
    def create_delete_task(self, index_uid: str, query_ast_json: dict) -> int:
        with self._lock:
            state = self._state_by_uid(index_uid)
            state.last_delete_opstamp += 1
            opstamp = state.last_delete_opstamp
            state.delete_tasks.append({
                "opstamp": opstamp,
                "create_timestamp": int(wall_time()),
                "query_ast": query_ast_json,
            })
            self._save_state(state)
            return opstamp

    def list_delete_tasks(self, index_uid: str, opstamp_start: int = 0) -> list[dict]:
        with self._lock:
            state = self._state_by_uid(index_uid)
            return [t for t in state.delete_tasks if t["opstamp"] > opstamp_start]

    def last_delete_opstamp(self, index_uid: str) -> int:
        with self._lock:
            return self._state_by_uid(index_uid).last_delete_opstamp

    def update_splits_delete_opstamp(self, index_uid: str,
                                     split_ids: Iterable[str], opstamp: int) -> None:
        with self._lock:
            state = self._state_by_uid(index_uid)
            for split_id in split_ids:
                split = state.splits.get(split_id)
                if split is not None:
                    split.metadata.delete_opstamp = opstamp
            self._save_state(state)
