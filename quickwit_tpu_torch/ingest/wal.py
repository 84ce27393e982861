"""Segmented write-ahead record log.

Role of the reference's `mrecordlog` crate (the WAL under ingest-v2 shards):
an append-only, fsync'd, position-addressed record log with truncation.
Records live in segment files (`wal-{first_position:020d}.seg`); truncation
drops whole segments whose records are all below the truncate position —
exactly how the indexer's published checkpoint reclaims WAL space.

Record format per entry: u32 length | payload. Positions are record
ordinals (not byte offsets), monotonically increasing across segments.

Carried over whole from the JAX package's `ingest/wal.py`.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterator, Optional

_SEGMENT_MAX_BYTES = 8 << 20
_LEN = struct.Struct("<I")


class RecordLog:
    def __init__(self, directory: str, fsync: bool = True,
                 fault_injector=None):
        self.directory = directory
        self.fsync = fsync
        # chaos hook (common/faults.FaultInjector): perturbs "wal.fsync"
        # before each durability barrier — a latency rule models a slow
        # disk, an error rule a failed fsync the caller must surface
        self.fault_injector = fault_injector
        os.makedirs(directory, exist_ok=True)
        # qwlint: disable-next-line=QW008 - ingest WAL/router leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._lock = threading.Lock()
        # segments: sorted list of (first_position, path)
        self._segments: list[tuple[int, str]] = []
        self._active_file = None
        self._active_size = 0
        self.next_position = 0
        self._recover()

    # --- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        names = sorted(n for n in os.listdir(self.directory)
                       if n.startswith("wal-") and n.endswith(".seg"))
        for name in names:
            first = int(name[4:-4])
            self._segments.append((first, os.path.join(self.directory, name)))
        if not self._segments:
            return
        # count records of the last segment to find next_position; earlier
        # segments' record counts derive from their successors' first position
        last_first, last_path = self._segments[-1]
        count, consumed = self._scan_segment(last_path)
        # drop any torn tail write now: appends reopen this file in 'ab'
        # mode, and new records written after torn bytes would be misframed
        # by the stale partial header on replay
        if consumed < os.path.getsize(last_path):
            with open(last_path, "r+b") as f:
                f.truncate(consumed)
        self.next_position = last_first + count

    @staticmethod
    def _scan_segment(path: str) -> tuple[int, int]:
        """(record_count, byte_offset_after_last_complete_record)."""
        count, consumed = 0, 0
        with open(path, "rb") as f:
            while True:
                header = f.read(_LEN.size)
                if len(header) < _LEN.size:
                    return count, consumed
                (length,) = _LEN.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    return count, consumed
                count += 1
                consumed += _LEN.size + length

    # --- append ------------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Returns the position of the appended record."""
        with self._lock:
            if self._active_file is None or self._active_size > _SEGMENT_MAX_BYTES:
                self._roll()
            position = self.next_position
            data = _LEN.pack(len(payload)) + payload
            # perturb BEFORE the write: an error-kind "failed fsync" must
            # reject the record cleanly, not leave unaccounted bytes on disk
            if self.fault_injector is not None:
                self.fault_injector.perturb("wal.fsync")
            self._active_file.write(data)
            self._active_file.flush()
            if self.fsync:
                os.fsync(self._active_file.fileno())
            self._active_size += len(data)
            self.next_position += 1
            return position

    def append_batch(self, payloads: list[bytes]) -> tuple[int, int]:
        """(first_position, last_position) with a single fsync."""
        if not payloads:
            raise ValueError("empty batch")
        with self._lock:
            if self._active_file is None or self._active_size > _SEGMENT_MAX_BYTES:
                self._roll()
            first = self.next_position
            chunks = []
            for payload in payloads:
                chunks.append(_LEN.pack(len(payload)))
                chunks.append(payload)
            data = b"".join(chunks)
            if self.fault_injector is not None:
                self.fault_injector.perturb("wal.fsync")
            self._active_file.write(data)
            self._active_file.flush()
            if self.fsync:
                os.fsync(self._active_file.fileno())
            self._active_size += len(data)
            self.next_position += len(payloads)
            return first, self.next_position - 1

    def _roll(self) -> None:
        if self._active_file is not None:
            self._active_file.close()
        path = os.path.join(self.directory, f"wal-{self.next_position:020d}.seg")
        # a crash between a previous _roll() and the first append leaves an
        # empty last segment already registered under this path; re-registering
        # it would make read_from iterate the segment twice
        if not (self._segments and self._segments[-1][1] == path):
            self._segments.append((self.next_position, path))
        self._active_file = open(path, "ab")
        self._active_size = os.path.getsize(path)

    # --- read --------------------------------------------------------------
    @staticmethod
    def _iter_segment(path: str) -> Iterator[bytes]:
        with open(path, "rb") as f:
            while True:
                header = f.read(_LEN.size)
                if len(header) < _LEN.size:
                    return
                (length,) = _LEN.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    return  # torn tail write: ignore (crash recovery)
                yield payload

    def read_from(self, position: int, max_records: int = 10_000
                  ) -> list[tuple[int, bytes]]:
        """Records with position >= `position`, up to max_records."""
        with self._lock:
            segments = list(self._segments)
        out: list[tuple[int, bytes]] = []
        for i, (first, path) in enumerate(segments):
            next_first = segments[i + 1][0] if i + 1 < len(segments) else None
            if next_first is not None and next_first <= position:
                continue
            pos = first
            try:
                for payload in self._iter_segment(path):
                    if pos >= position:
                        out.append((pos, payload))
                        if len(out) >= max_records:
                            return out
                    pos += 1
            except FileNotFoundError:
                # concurrent truncate() unlinked this segment; its records
                # were all below the published checkpoint anyway
                continue
        return out

    # --- tail rollback (replication atomicity) -----------------------------
    def tail_state(self) -> tuple:
        """Opaque pre-append snapshot for `rollback_to` — taken by a caller
        holding the batch atomic (persist+replicate) critical section."""
        with self._lock:
            active_path = self._segments[-1][1] if self._segments else None
            # on-disk size, not _active_size: after recovery the active file
            # holds bytes appended before restart that _roll hasn't measured
            size = (os.path.getsize(active_path)
                    if active_path and os.path.exists(active_path) else 0)
            return (self.next_position, active_path, size,
                    len(self._segments))

    def rollback_to(self, state: tuple) -> None:
        """Undo appends made since `tail_state()` (same critical section —
        no interleaved appends): chained replication needs 'durable on both
        or neither', so a failed replication rolls the local tail back."""
        next_position, active_path, active_size, num_segments = state
        with self._lock:
            # drop any segment the rolled-back append created
            while len(self._segments) > num_segments:
                _, path = self._segments.pop()
                if self._active_file is not None:
                    self._active_file.close()
                    self._active_file = None
                if os.path.exists(path):
                    os.unlink(path)
            if num_segments == 0:
                if self._active_file is not None:
                    self._active_file.close()
                self._active_file = None
                self._active_size = 0
            elif active_path is not None and os.path.exists(active_path):
                if self._active_file is not None:
                    self._active_file.close()
                with open(active_path, "r+b") as f:
                    f.truncate(active_size)
                self._active_file = open(active_path, "ab")
                self._active_size = active_size
            self.next_position = next_position

    def reset_to(self, position: int) -> None:
        """Drop everything and restart the log at `position` (replica
        catch-up past the leader's truncation watermark)."""
        with self._lock:
            if self._active_file is not None:
                self._active_file.close()
                self._active_file = None
            for _, path in self._segments:
                if os.path.exists(path):
                    os.unlink(path)
            self._segments = []
            self._active_size = 0
            self.next_position = position

    # --- truncate ----------------------------------------------------------
    def truncate(self, up_to_position: int) -> int:
        """Drop segments entirely below `up_to_position` (exclusive).
        Returns number of segments removed."""
        removed = 0
        with self._lock:
            while len(self._segments) > 1:
                first, path = self._segments[0]
                next_first = self._segments[1][0]
                if next_first <= up_to_position:
                    os.unlink(path)
                    self._segments.pop(0)
                    removed += 1
                else:
                    break
        return removed

    def close(self) -> None:
        with self._lock:
            if self._active_file is not None:
                self._active_file.close()
                self._active_file = None
