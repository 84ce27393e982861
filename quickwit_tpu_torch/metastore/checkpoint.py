"""Source checkpoints — the exactly-once boundary between queue and index.

Role of the reference's `quickwit-metastore/src/checkpoint.rs:30-120`:
a `SourceCheckpoint` maps partition ids to positions; every publish carries a
`CheckpointDelta` whose `from` positions must exactly equal the current
checkpoint, otherwise the publish is rejected — replays after a crash are
deduplicated by this check, which is what makes indexing exactly-once.

Positions are strings ordered by (length, lexicographic) so zero-padded
numeric offsets order correctly (the reference's `Position` encoding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

BEGINNING = ""  # the position before any record


def position_gt(a: str, b: str) -> bool:
    """a > b under (length, lex) ordering; BEGINNING is smallest."""
    return (len(a), a) > (len(b), b)


def offset_position(offset: int) -> str:
    """Canonical position encoding for integer offsets (zero-padded,
    length-prefixed ordering-safe)."""
    return f"{offset:020d}"


class IncompatibleCheckpointDelta(ValueError):
    pass


@dataclass
class SourceCheckpoint:
    positions: dict[str, str] = field(default_factory=dict)

    def position_for(self, partition_id: str) -> str:
        return self.positions.get(partition_id, BEGINNING)

    def try_apply_delta(self, delta: "CheckpointDelta") -> None:
        """Validate-then-apply, atomically (validates all partitions first)."""
        for partition_id, (from_pos, to_pos) in delta.per_partition.items():
            current = self.position_for(partition_id)
            if from_pos != current:
                raise IncompatibleCheckpointDelta(
                    f"partition {partition_id!r}: delta starts at {from_pos!r} "
                    f"but checkpoint is at {current!r}")
            if position_gt(from_pos, to_pos):
                raise IncompatibleCheckpointDelta(
                    f"partition {partition_id!r}: delta goes backwards "
                    f"({from_pos!r} -> {to_pos!r})")
        for partition_id, (_, to_pos) in delta.per_partition.items():
            self.positions[partition_id] = to_pos

    def to_dict(self) -> dict[str, str]:
        return dict(self.positions)

    @staticmethod
    def from_dict(d: dict[str, str]) -> "SourceCheckpoint":
        return SourceCheckpoint(dict(d))


@dataclass
class CheckpointDelta:
    # partition_id -> (from_position_exclusive, to_position_inclusive)
    per_partition: dict[str, tuple[str, str]] = field(default_factory=dict)

    @staticmethod
    def from_range(partition_id: str, from_pos: str, to_pos: str) -> "CheckpointDelta":
        return CheckpointDelta({partition_id: (from_pos, to_pos)})

    def record(self, partition_id: str, from_pos: str, to_pos: str) -> None:
        if partition_id in self.per_partition:
            cur_from, cur_to = self.per_partition[partition_id]
            if cur_to != from_pos:
                raise IncompatibleCheckpointDelta(
                    f"partition {partition_id!r}: non-contiguous delta extension")
            self.per_partition[partition_id] = (cur_from, to_pos)
        else:
            self.per_partition[partition_id] = (from_pos, to_pos)

    def extend(self, other: "CheckpointDelta") -> None:
        for partition_id, (from_pos, to_pos) in other.per_partition.items():
            self.record(partition_id, from_pos, to_pos)

    @property
    def is_empty(self) -> bool:
        return not self.per_partition

    def to_dict(self) -> dict[str, list[str]]:
        return {p: [f, t] for p, (f, t) in self.per_partition.items()}

    @staticmethod
    def from_dict(d: dict[str, list[str]]) -> "CheckpointDelta":
        return CheckpointDelta({p: (v[0], v[1]) for p, v in d.items()})
