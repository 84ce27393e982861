"""Ingester: hosts WAL shards.

Role of the reference's `Ingester` (`quickwit-ingest/src/ingest_v2/
ingester.rs:99`): persist doc batches durably into per-shard WAL queues,
serve fetch streams to the indexing source, truncate behind published
checkpoints, and recover shard state from disk on restart. Chained
replication (RF>1, `replication.rs`) is stubbed at the `replicate_to`
seam — the persist path invokes it for every batch so a follower client
slots in without protocol changes.

Carried over whole from the JAX package's `ingest/ingester.py`.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Optional

from .wal import RecordLog


class ReplicationGap(ValueError):
    """Follower is missing records before the offered batch; carries the
    follower's next position so the leader can backfill."""

    def __init__(self, message: str, have: int):
        super().__init__(message)
        self.have = have


class ShardState(str, Enum):
    OPEN = "open"
    CLOSED = "closed"  # no new writes; drains then gets deleted


@dataclass
class Shard:
    index_uid: str
    source_id: str
    shard_id: str
    log: RecordLog
    state: ShardState = ShardState.OPEN
    publish_position: int = 0  # truncation watermark
    # serializes persist+replicate as one critical section: replication
    # stays batch-ordered and a failed chain rolls the local tail back
    persist_lock: threading.Lock = field(default_factory=threading.Lock)
    # "leader" shards accept router writes and are drained by the indexer;
    # "replica" shards only accept replica_persist and sit out of drains
    # until promoted (reference: chained replication, replication.rs)
    role: str = "leader"
    # cumulative ingested payload bytes; the scaling arbiter turns deltas
    # of this into MiB/s (reference: per-shard ingestion-rate gossip)
    bytes_written: int = 0
    # positions below this are replication-chain committed and safe to
    # serve to fetch streams; maintained at every leadership event (shard
    # creation, recovery, promotion — where the full WAL is the
    # at-least-once committed floor — and each successful persist).
    # -1 = unset (replica shards; fetch falls back to the log head).
    # Without the clamp a fetch racing the persist critical section could
    # drain an appended-but-unreplicated tail that a failed chain then
    # rolls back, re-using the published positions for different
    # documents — the qwmc replication model's publish_from watermark
    # (tools/qwmc/models.py).
    committed_position: int = -1


def shard_queue_id(index_uid: str, source_id: str, shard_id: str) -> str:
    # ':' is not filesystem-friendly; '@' cannot occur in index ids, so the
    # encoding is reversible even for ids containing underscores
    return f"{index_uid.replace(':', '@')}/{source_id}/{shard_id}"


class Ingester:
    def __init__(self, wal_dir: str, fsync: bool = True,
                 replicate_to: Optional[Callable[
                     [str, str, str, int, list[bytes]], None]] = None,
                 fault_injector=None):
        self.wal_dir = wal_dir
        self.fsync = fsync
        self.replicate_to = replicate_to
        # chaos hook (common/faults.FaultInjector): threads into every
        # shard's RecordLog ("wal.fsync") and perturbs "ingest.replicate"
        # around the chained-replication hop — an error-kind rule there
        # exercises the rollback path exactly like a dropped follower
        self.fault_injector = fault_injector
        # on_truncate(index_uid, source_id, shard_id, position): leader-side
        # hook propagating truncation to the replica (space reclaim)
        self.on_truncate: Optional[Callable[[str, str, str, int],
                                            None]] = None
        self._shards: dict[str, Shard] = {}
        # qwlint: disable-next-line=QW008 - ingest WAL/router leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._lock = threading.Lock()
        self._recover()

    # --- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        if not os.path.isdir(self.wal_dir):
            return
        for index_dir in os.listdir(self.wal_dir):
            index_path = os.path.join(self.wal_dir, index_dir)
            if not os.path.isdir(index_path):
                continue
            for source_id in os.listdir(index_path):
                source_path = os.path.join(index_path, source_id)
                for shard_id in os.listdir(source_path):
                    queue_id = f"{index_dir}/{source_id}/{shard_id}"
                    index_uid = index_dir.replace("@", ":")
                    shard_dir = os.path.join(source_path, shard_id)
                    role = "leader"
                    role_path = os.path.join(shard_dir, "_role")
                    if os.path.exists(role_path):
                        with open(role_path) as f:
                            role = f.read().strip() or "leader"
                    shard = Shard(
                        index_uid=index_uid, source_id=source_id,
                        shard_id=shard_id, role=role,
                        log=RecordLog(shard_dir, fsync=self.fsync,
                                      fault_injector=self.fault_injector))
                    if role == "leader":
                        # recovery commits the durable tail (at-least-once:
                        # the chain may or may not have acked it)
                        shard.committed_position = shard.log.next_position
                    self._shards[queue_id] = shard

    # --- shard lifecycle ---------------------------------------------------
    def open_shard(self, index_uid: str, source_id: str, shard_id: str,
                   role: str = "leader") -> Shard:
        queue_id = shard_queue_id(index_uid, source_id, shard_id)
        with self._lock:
            shard = self._shards.get(queue_id)
            if shard is None:
                shard_dir = os.path.join(self.wal_dir, queue_id)
                shard = Shard(
                    index_uid=index_uid, source_id=source_id, shard_id=shard_id,
                    role=role,
                    log=RecordLog(shard_dir, fsync=self.fsync,
                                  fault_injector=self.fault_injector))
                if role != "leader":
                    self._write_role(shard_dir, role)
                else:
                    shard.committed_position = shard.log.next_position
                self._shards[queue_id] = shard
            return shard

    @staticmethod
    def _write_role(shard_dir: str, role: str) -> None:
        os.makedirs(shard_dir, exist_ok=True)
        with open(os.path.join(shard_dir, "_role"), "w") as f:
            f.write(role)

    def promote_replica(self, queue_id: str,
                        min_position: Optional[int] = None) -> bool:
        """Replica → leader (the leader ingester died; this copy takes over
        draining — reference: AdviseResetShards / shard re-open,
        ingest_controller.rs:204). Checkpoint continuity holds because the
        replica hosts the SAME shard id at the same WAL positions.

        `min_position` is the published checkpoint: a promoted log whose
        head is BEHIND it forward-resets to the checkpoint, or the new
        leader would hand already-consumed positions to fresh appends
        (qwmc's behind-checkpoint promotion counterexample — the old
        leader's recovery-committed tail published past this copy's head).
        Everything dropped by the reset sits below the checkpoint, hence
        is already published."""
        with self._lock:
            shard = self._shards.get(queue_id)
            if shard is None or shard.role == "leader":
                return False
            if (min_position is not None
                    and shard.log.next_position < min_position):
                shard.log.reset_to(min_position)
                shard.publish_position = max(shard.publish_position,
                                             min_position)
            shard.role = "leader"
            # everything a replica holds came through the chain: committed
            shard.committed_position = shard.log.next_position
            self._write_role(os.path.join(self.wal_dir, queue_id), "leader")
            return True

    def demote_to_replica(self, queue_id: str, position: int) -> bool:
        """Leader → replica, WAL reset at `position` (the published
        checkpoint): a node that crashed and rejoined after another copy
        was promoted still recovers its shard with the old leader role —
        qwmc's stale-leader-rejoin counterexample shows the split-brain
        re-uses published positions and loses an acked record. The
        registered chain (metastore.shard_chain) holds every acked
        record, so the stale content is redundant; keeping it would
        collide with positions the promoted leader hands out."""
        with self._lock:
            shard = self._shards.get(queue_id)
            if shard is None or shard.role != "leader":
                return False
            shard.role = "replica"
            self._write_role(os.path.join(self.wal_dir, queue_id), "replica")
            shard.log.reset_to(position)
            shard.publish_position = max(shard.publish_position, position)
            shard.committed_position = -1
            return True

    def replica_shards(self) -> list[tuple[str, Shard]]:
        with self._lock:
            return [(qid, s) for qid, s in self._shards.items()
                    if s.role == "replica"]

    def close_shard(self, index_uid: str, source_id: str, shard_id: str) -> None:
        shard = self._shards.get(shard_queue_id(index_uid, source_id, shard_id))
        if shard is not None:
            shard.state = ShardState.CLOSED

    def list_shards(self, index_uid: Optional[str] = None,
                    include_replicas: bool = False) -> list[Shard]:
        with self._lock:  # snapshot: persist/open_shard mutate concurrently
            shards = list(self._shards.values())
        return [s for s in shards
                if (index_uid is None or s.index_uid == index_uid)
                and (include_replicas or s.role == "leader")]

    def shard(self, index_uid: str, source_id: str, shard_id: str) -> Optional[Shard]:
        return self._shards.get(shard_queue_id(index_uid, source_id, shard_id))

    # --- persist / fetch / truncate ---------------------------------------
    def persist(self, index_uid: str, source_id: str, shard_id: str,
                docs: list[dict[str, Any]]) -> tuple[int, int]:
        """Durable append of a doc batch; returns (first, last) positions
        (reference: `ingester.rs:430,1117` persist)."""
        shard = self.open_shard(index_uid, source_id, shard_id)
        if shard.state is not ShardState.OPEN:
            raise ValueError(f"shard {shard_id!r} is closed")
        if shard.role != "leader":
            raise ValueError(f"shard {shard_id!r} is a replica")
        payloads = [json.dumps(d, separators=(",", ":")).encode() for d in docs]
        with shard.persist_lock:
            # one critical section per shard: replication sees batches in
            # WAL order, and a failed chain rolls the local tail back so
            # the ack means "durable on leader AND follower or neither"
            # (reference: replication.rs persist semantics; a client retry
            # after an error therefore cannot duplicate documents)
            state = shard.log.tail_state()
            first, last = shard.log.append_batch(payloads)
            if self.replicate_to is not None:
                try:
                    if self.fault_injector is not None:
                        self.fault_injector.perturb("ingest.replicate")
                    self.replicate_to(index_uid, source_id, shard.shard_id,
                                      first, payloads)
                except Exception:
                    shard.log.rollback_to(state)
                    raise
            shard.bytes_written += sum(len(p) for p in payloads)
            shard.committed_position = shard.log.next_position
        return first, last

    def replica_persist(self, index_uid: str, source_id: str, shard_id: str,
                        first_position: int, payloads: list[bytes]) -> int:
        """Follower side of chained replication: position-aligned append.
        Idempotent — records already present (leader retry) are skipped;
        a gap (missed batch) is an error the leader must handle."""
        shard = self.open_shard(index_uid, source_id, shard_id,
                                role="replica")
        if shard.role == "leader":
            raise ValueError(
                f"shard {shard_id!r} is led from this node; refusing to "
                "replicate onto it")
        next_position = shard.log.next_position
        if first_position > next_position:
            raise ReplicationGap(
                f"replication gap on {shard_id!r}: have {next_position}, "
                f"got batch at {first_position}", have=next_position)
        skip = next_position - first_position
        if skip >= len(payloads):
            return next_position - 1  # full batch already replicated
        shard.log.append_batch(payloads[skip:])
        return shard.log.next_position - 1

    def replica_reset(self, index_uid: str, source_id: str, shard_id: str,
                      position: int) -> None:
        """Restart a replica log at `position` — used when the leader's
        retained WAL no longer covers the follower's gap (the missing
        records are already published; the shared metastore checkpoint is
        the durability floor there)."""
        shard = self.open_shard(index_uid, source_id, shard_id,
                                role="replica")
        if shard.role == "leader":
            raise ValueError(f"shard {shard_id!r} is led from this node")
        shard.log.reset_to(position)

    def replica_truncate(self, index_uid: str, source_id: str,
                         shard_id: str, up_to_position: int) -> None:
        """Follower-side truncation behind the leader's published
        checkpoint (replica WALs must not grow without bound)."""
        shard = self.shard(index_uid, source_id, shard_id)
        if shard is not None and shard.role == "replica":
            shard.publish_position = max(shard.publish_position,
                                         up_to_position)
            shard.log.truncate(up_to_position)

    def fetch(self, index_uid: str, source_id: str, shard_id: str,
              from_position: int, max_records: int = 10_000
              ) -> list[tuple[int, dict[str, Any]]]:
        """Records from the WAL for the indexing source's fetch stream
        (reference: `fetch.rs` FetchStreamTask)."""
        shard = self.shard(index_uid, source_id, shard_id)
        if shard is None:
            return []
        records = shard.log.read_from(from_position, max_records)
        if shard.role == "leader" and shard.committed_position >= 0:
            # never serve past the replication-committed watermark (see
            # Shard.committed_position)
            records = [(pos, payload) for pos, payload in records
                       if pos < shard.committed_position]
        return [(pos, json.loads(payload)) for pos, payload in records]

    def truncate(self, index_uid: str, source_id: str, shard_id: str,
                 up_to_position: int) -> None:
        """Reclaim WAL space behind the published checkpoint
        (reference: TruncateShards / `shard_positions.rs`)."""
        shard = self.shard(index_uid, source_id, shard_id)
        if shard is not None:
            shard.publish_position = max(shard.publish_position, up_to_position)
            shard.log.truncate(up_to_position)
            if self.on_truncate is not None and shard.role == "leader":
                # propagate to the replica (best-effort: replicas re-derive
                # the watermark from the shared metastore at promotion)
                try:
                    self.on_truncate(index_uid, source_id, shard_id,
                                     up_to_position)
                except Exception:  # noqa: BLE001 - space reclaim only
                    pass

    # --- observability ------------------------------------------------------
    def shard_throughput_state(self) -> dict[str, dict[str, int]]:
        """Per-shard positions for the control plane's capacity decisions
        (reference: shard-capacity gossip broadcast)."""
        with self._lock:
            items = list(self._shards.items())
        return {
            queue_id: {"head": shard.log.next_position,
                       "published": shard.publish_position,
                       "open": int(shard.state is ShardState.OPEN),
                       "bytes": shard.bytes_written}
            for queue_id, shard in items
        }
