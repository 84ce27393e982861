"""Split metadata + lifecycle.

Role of the reference's `quickwit-metastore/src/split_metadata.rs`: the
metastore-side record of one immutable split — id, doc count, size, time
range, tags, delete opstamp, maturity — plus the Staged → Published →
MarkedForDeletion lifecycle enforced by the metastore.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

from ..common.clock import get_rng, wall_time


class SplitState(str, Enum):
    STAGED = "Staged"
    PUBLISHED = "Published"
    MARKED_FOR_DELETION = "MarkedForDeletion"


def new_split_id() -> str:
    # ULID-like: time-ordered prefix + random suffix (reference uses ULIDs).
    # Both components come from the process clock/rng seams: under the DST
    # harness split ids are then a pure function of the scenario seed, which
    # keeps rendezvous placement (hashed over split ids) replayable.
    return (f"{int(wall_time() * 1000):013d}-"
            f"{get_rng().getrandbits(48):012x}")


@dataclass
class SplitMetadata:
    split_id: str
    index_uid: str
    source_id: str = "_unknown"
    node_id: str = "_unknown"
    num_docs: int = 0
    uncompressed_docs_size_bytes: int = 0
    footprint_bytes: int = 0  # size of the .split file
    time_range_start: Optional[int] = None  # micros since epoch, inclusive
    time_range_end: Optional[int] = None    # inclusive
    tags: frozenset[str] = field(default_factory=frozenset)
    create_timestamp: int = 0
    maturity_timestamp: int = 0  # 0 == mature immediately
    delete_opstamp: int = 0
    num_merge_ops: int = 0
    doc_mapping_uid: str = "default"
    partition_id: int = 0
    # per-column min/max of the split's numeric fast columns — the
    # split-granular zonemap (reference: quickwit-parquet-engine
    # src/zonemap/): the root prunes splits whose bounds preclude a
    # required numeric predicate before any byte of them is fetched
    column_bounds: dict[str, tuple[Any, Any]] = field(default_factory=dict)

    def is_mature(self, now_ts: Optional[float] = None) -> bool:
        if self.maturity_timestamp == 0:
            return True
        return (now_ts if now_ts is not None else wall_time()) >= self.maturity_timestamp

    def overlaps_time_range(self, start_micros: Optional[int], end_micros: Optional[int]) -> bool:
        """Time pruning predicate (reference: ListSplitsQuery time filter)."""
        if self.time_range_start is None or self.time_range_end is None:
            return True  # splits without a time range can never be pruned
        if start_micros is not None and self.time_range_end < start_micros:
            return False
        if end_micros is not None and self.time_range_start > end_micros:
            return False
        return True

    def matches_tags(self, required_tags: Optional[set[str]]) -> bool:
        """Tag pruning: the split may contain a match only if every required
        tag is present (reference: `tag_pruning.rs` conservative predicate)."""
        if not required_tags:
            return True
        return required_tags.issubset(self.tags)

    def to_dict(self) -> dict[str, Any]:
        return {
            "split_id": self.split_id, "index_uid": self.index_uid,
            "source_id": self.source_id, "node_id": self.node_id,
            "num_docs": self.num_docs,
            "uncompressed_docs_size_bytes": self.uncompressed_docs_size_bytes,
            "footprint_bytes": self.footprint_bytes,
            "time_range_start": self.time_range_start,
            "time_range_end": self.time_range_end,
            "tags": sorted(self.tags),
            "create_timestamp": self.create_timestamp,
            "maturity_timestamp": self.maturity_timestamp,
            "delete_opstamp": self.delete_opstamp,
            "num_merge_ops": self.num_merge_ops,
            "doc_mapping_uid": self.doc_mapping_uid,
            "partition_id": self.partition_id,
            "column_bounds": {name: list(bounds) for name, bounds
                              in self.column_bounds.items()},
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SplitMetadata":
        return SplitMetadata(
            split_id=d["split_id"], index_uid=d["index_uid"],
            source_id=d.get("source_id", "_unknown"), node_id=d.get("node_id", "_unknown"),
            num_docs=d.get("num_docs", 0),
            uncompressed_docs_size_bytes=d.get("uncompressed_docs_size_bytes", 0),
            footprint_bytes=d.get("footprint_bytes", 0),
            time_range_start=d.get("time_range_start"),
            time_range_end=d.get("time_range_end"),
            tags=frozenset(d.get("tags", ())),
            create_timestamp=d.get("create_timestamp", 0),
            maturity_timestamp=d.get("maturity_timestamp", 0),
            delete_opstamp=d.get("delete_opstamp", 0),
            num_merge_ops=d.get("num_merge_ops", 0),
            doc_mapping_uid=d.get("doc_mapping_uid", "default"),
            partition_id=d.get("partition_id", 0),
            column_bounds={name: tuple(bounds) for name, bounds
                           in d.get("column_bounds", {}).items()},
        )


@dataclass
class Split:
    """A split + its lifecycle state, as stored by the metastore."""
    metadata: SplitMetadata
    state: SplitState = SplitState.STAGED
    update_timestamp: int = 0
    publish_timestamp: Optional[int] = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "metadata": self.metadata.to_dict(),
            "state": self.state.value,
            "update_timestamp": self.update_timestamp,
            "publish_timestamp": self.publish_timestamp,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Split":
        return Split(
            metadata=SplitMetadata.from_dict(d["metadata"]),
            state=SplitState(d["state"]),
            update_timestamp=d.get("update_timestamp", 0),
            publish_timestamp=d.get("publish_timestamp"),
        )
