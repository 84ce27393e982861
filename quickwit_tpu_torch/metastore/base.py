"""Metastore service interface.

Role of the reference's `MetastoreService` gRPC API
(`quickwit-proto/protos/quickwit/metastore.proto:93-232`): index/source/split
metadata with the atomic publish protocol. Implementations:
`FileBackedMetastore` (object-storage JSON, reference
`file_backed/mod.rs:154`); a SQL backend is the reference's production
option and a future backend here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..models.index_metadata import IndexMetadata, SourceConfig
from ..models.split_metadata import Split, SplitMetadata, SplitState
from .checkpoint import CheckpointDelta


class MetastoreError(Exception):
    def __init__(self, message: str, kind: str = "internal"):
        super().__init__(message)
        self.kind = kind  # not_found | already_exists | failed_precondition | internal


@dataclass
class ListSplitsQuery:
    """Split-listing filter (reference: `ListSplitsQuery`); time-range and
    tag filters implement split pruning at plan time (`root.rs:1599`)."""
    index_uids: Optional[list[str]] = None
    states: Optional[list[SplitState]] = None
    time_range_start: Optional[int] = None   # micros, inclusive
    time_range_end: Optional[int] = None     # micros, exclusive
    required_tags: Optional[set[str]] = None
    mature_only: bool = False
    max_staleness_ts: Optional[int] = None

    def matches(self, split: Split) -> bool:
        if self.states is not None and split.state not in self.states:
            return False
        md = split.metadata
        if self.index_uids is not None and md.index_uid not in self.index_uids:
            return False
        end_incl = self.time_range_end - 1 if self.time_range_end is not None else None
        if not md.overlaps_time_range(self.time_range_start, end_incl):
            return False
        if not md.matches_tags(self.required_tags):
            return False
        if self.mature_only and not md.is_mature():
            return False
        return True


class Metastore:
    """Abstract metastore. All methods raise MetastoreError on failure."""

    # --- index lifecycle -------------------------------------------------
    def create_index(self, index_metadata: IndexMetadata) -> None:
        raise NotImplementedError

    def delete_index(self, index_uid: str) -> None:
        raise NotImplementedError

    def index_metadata(self, index_id: str) -> IndexMetadata:
        raise NotImplementedError

    def index_metadata_by_uid(self, index_uid: str) -> IndexMetadata:
        raise NotImplementedError

    def list_indexes(self) -> list[IndexMetadata]:
        raise NotImplementedError

    def refresh(self) -> None:
        """Drop any cached state so the next read reflects what other
        nodes have durably written. Backends with live reads (SQL) need
        nothing; the file-backed store invalidates its polling cache.
        Safety-critical readers (GC orphan scan) call this before acting
        on absence."""

    def update_retention_policy(self, index_uid: str, retention) -> None:
        """Persist a retention-policy change (reference `update_index`
        subset: retention only; other settings are immutable here)."""
        raise NotImplementedError

    def update_index_config(self, index_uid: str, index_config) -> None:
        """Persist a validated replacement IndexConfig (reference
        `update_index`, `metastore.proto` UpdateIndexRequest). The
        CALLER (IndexService.update_index) owns compatibility checks —
        append-only mapping changes, immutable index_id/uri."""
        raise NotImplementedError

    # --- sources -----------------------------------------------------------
    def add_source(self, index_uid: str, source: SourceConfig) -> None:
        raise NotImplementedError

    def delete_source(self, index_uid: str, source_id: str) -> None:
        raise NotImplementedError

    def toggle_source(self, index_uid: str, source_id: str, enable: bool) -> None:
        raise NotImplementedError

    def reset_source_checkpoint(self, index_uid: str, source_id: str) -> None:
        raise NotImplementedError

    # --- replication chain registry ----------------------------------------
    # Durable record of each shard's replication chain: which node leads the
    # shard and which node is the registered follower. The leader writes the
    # record BEFORE replicating the first batch to a new follower, and a
    # promotion rewrites it; failover may then promote ONLY the registered
    # follower — a replica copy that merely looks healthy (e.g. a crashed
    # follower that rejoined with a stale WAL) is not eligible. The qwmc
    # replication model (tools/qwmc/models.py) checks exhaustively that this
    # registry discipline is what makes promotion lose no acked record.
    def record_shard_chain(self, index_uid: str, source_id: str,
                           shard_id: str, leader: str,
                           follower: Optional[str]) -> None:
        raise NotImplementedError

    def shard_chain(self, index_uid: str, source_id: str,
                    shard_id: str) -> Optional[dict]:
        """Returns ``{"leader": node_id, "follower": node_id | None}`` or
        None when the shard never formed a replication chain."""
        raise NotImplementedError

    # --- splits ------------------------------------------------------------
    def stage_splits(self, index_uid: str, split_metadatas: list[SplitMetadata]) -> None:
        raise NotImplementedError

    def publish_splits(
        self,
        index_uid: str,
        staged_split_ids: list[str],
        replaced_split_ids: Iterable[str] = (),
        source_id: Optional[str] = None,
        checkpoint_delta: Optional[CheckpointDelta] = None,
    ) -> None:
        """Atomic cut-over: staged → published, replaced → marked-for-deletion,
        checkpoint advanced — all or nothing (reference `PublishSplits`)."""
        raise NotImplementedError

    def list_splits(self, query: ListSplitsQuery) -> list[Split]:
        raise NotImplementedError

    def mark_splits_for_deletion(self, index_uid: str, split_ids: Iterable[str]) -> None:
        raise NotImplementedError

    def delete_splits(self, index_uid: str, split_ids: Iterable[str]) -> None:
        """Only Staged or MarkedForDeletion splits may be deleted."""
        raise NotImplementedError

    # --- delete tasks (GDPR deletes, reference delete_task API) -----------
    def create_delete_task(self, index_uid: str, query_ast_json: dict) -> int:
        raise NotImplementedError

    def list_delete_tasks(self, index_uid: str, opstamp_start: int = 0) -> list[dict]:
        raise NotImplementedError

    def last_delete_opstamp(self, index_uid: str) -> int:
        raise NotImplementedError

    # --- index templates (shared logic; backends store/list/delete) -----
    @staticmethod
    def validate_template(template: dict) -> None:
        patterns = template.get("index_id_patterns")
        if (not isinstance(template.get("template_id"), str)
                or not isinstance(patterns, list) or not patterns
                or not all(isinstance(p, str) for p in patterns)):
            raise MetastoreError(
                "template requires a string template_id and a non-empty "
                "list of string index_id_patterns", kind="invalid_argument")

    def find_index_template(self, index_id: str):
        """Highest-priority template whose pattern matches (reference:
        index_template/mod.rs:35)."""
        import fnmatch
        candidates = [
            t for t in self.list_index_templates()
            if any(fnmatch.fnmatch(index_id, p)
                   for p in t["index_id_patterns"])
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda t: t.get("priority", 0))

    def list_index_templates(self) -> list[dict]:
        raise NotImplementedError

    def update_splits_delete_opstamp(self, index_uid: str,
                                     split_ids: Iterable[str], opstamp: int) -> None:
        raise NotImplementedError
