"""Ingest router: doc batches → WAL shards.

Role of the reference's `IngestRouter` + `RoutingTable`
(`quickwit-ingest/src/ingest_v2/router.rs:97`, `routing_table.rs`): front
door of the write path — resolve open shards for (index, source), spread
batches across them (round-robin over open shards), ask the control plane
for shards when none exist, and retry on closed shards (the workbench
logic, simplified to synchronous semantics).

Carried over whole from the JAX package's `ingest/router.py`.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .ingester import Ingester, ShardState

INGEST_V2_SOURCE_ID = "_ingest-source"
INGEST_API_SOURCE_ID = "_ingest-api-source"  # the v1 synchronous REST path

# sources whose checkpoints guard the built-in ingest paths against replay
INTERNAL_SOURCE_IDS = (INGEST_V2_SOURCE_ID, INGEST_API_SOURCE_ID)


@dataclass
class RoutingEntry:
    shard_ids: list[str] = field(default_factory=list)
    cursor: int = 0


class IngestRouter:
    def __init__(self, ingester: Ingester,
                 get_or_create_shards: Optional[Callable[[str, str], list[str]]] = None,
                 shards_per_source: int = 1,
                 shard_prefix: str = ""):
        self.ingester = ingester
        self.shards_per_source = shards_per_source
        # `shard_prefix` (normally the node id) keeps WAL shard ids unique
        # across nodes: each node drains its own local WAL into a shared
        # metastore, and per-shard checkpoint partitions must not collide
        # (the reference's ingest-v2 shards are cluster-global for the
        # same reason, control_plane.proto:65).
        self.shard_prefix = f"{shard_prefix}-" if shard_prefix else ""
        # control-plane hook: GetOrCreateOpenShards (control_plane.proto:65);
        # default: local static placement
        self.get_or_create_shards = get_or_create_shards or self._default_shards
        self._table: dict[tuple[str, str], RoutingEntry] = {}
        # qwlint: disable-next-line=QW008 - ingest WAL/router leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._lock = threading.Lock()

    def _default_shards(self, index_uid: str, source_id: str) -> list[str]:
        return [f"{self.shard_prefix}shard-{i:02d}"
                for i in range(self.shards_per_source)]

    def _entry(self, index_uid: str, source_id: str) -> RoutingEntry:
        key = (index_uid, source_id)
        with self._lock:
            entry = self._table.get(key)
            if entry is None or not entry.shard_ids:
                shard_ids = self.get_or_create_shards(index_uid, source_id)
                entry = RoutingEntry(shard_ids=list(shard_ids))
                self._table[key] = entry
            return entry

    def refresh(self, index_uid: str,
                source_id: str = INGEST_V2_SOURCE_ID) -> None:
        """Drop the cached shard list so the next batch re-resolves it —
        called after the control plane opens or closes shards (reference:
        routing-table invalidation on shard-set change)."""
        with self._lock:
            self._table.pop((index_uid, source_id), None)

    def ingest(self, index_uid: str, docs: list[dict[str, Any]],
               source_id: str = INGEST_V2_SOURCE_ID) -> dict[str, Any]:
        """Route one batch; returns {shard_id: (first, last)} positions."""
        if not docs:
            return {"positions": {}, "num_docs": 0}
        entry = self._entry(index_uid, source_id)
        last_error: Optional[Exception] = None
        for _ in range(len(entry.shard_ids)):
            with self._lock:
                shard_id = entry.shard_ids[entry.cursor % len(entry.shard_ids)]
                entry.cursor += 1
            try:
                first, last = self.ingester.persist(
                    index_uid, source_id, shard_id, docs)
                return {"positions": {shard_id: [first, last]},
                        "num_docs": len(docs)}
            except ValueError as exc:  # closed shard: drop from table, retry
                last_error = exc
                with self._lock:
                    if shard_id in entry.shard_ids:
                        entry.shard_ids.remove(shard_id)
                    if not entry.shard_ids:
                        # refill inside the lock so concurrent ingests never
                        # observe an empty shard list
                        entry.shard_ids = list(
                            self.get_or_create_shards(index_uid, source_id))
        raise RuntimeError(f"no open shard accepted the batch: {last_error}")
