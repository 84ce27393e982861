"""In-process Kafka broker speaking the wire protocol the source
consumes — the test double for `kafka.py` (same role as
`storage/fake_s3.py` for the S3 backend: the seam is exercised over a
REAL socket with REAL wire bytes, not a mock).

Serves ApiVersions v0, Metadata v0-1, ListOffsets v0-1, Fetch v0-4 from
an in-memory {topic: [partition logs]} store. Also accepts Produce-less
test seeding via `seed()`. Fault injection: `fail_next_fetches` makes
the next N Fetch responses return a retryable error code.

Carried over whole from the JAX package's `indexing/fake_kafka.py`.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from .kafka import EARLIEST, _Reader, _str, encode_record_batch


class FakeKafkaBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 node_id: int = 0):
        self._topics: dict[str, list[list[bytes]]] = {}
        self._batches: dict[tuple[str, int], list[tuple[int, bytes]]] = {}
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self._lock = threading.Lock()
        self.fail_next_fetches = 0
        self.node_id = node_id
        # multi-broker simulation: peers listed in metadata, and
        # partitions whose leader is another node — this broker then
        # refuses their Fetch/ListOffsets with NOT_LEADER
        self.peer_brokers: list["FakeKafkaBroker"] = []
        self.partition_leaders: dict[tuple[str, int], int] = {}
        self._truncated: dict[tuple[str, int], int] = {}
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(8)
        self.host, self.port = self._server.getsockname()
        self._running = True
        # qwlint: disable-next-line=QW003 - test-double broker accept
        # loop; serves no quickwit_tpu queries
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- test API
    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            self._topics[topic] = [[] for _ in range(partitions)]

    def seed(self, topic: str, partition: int, values: list[bytes]) -> None:
        """Append records (the producer side of the seam)."""
        with self._lock:
            log = self._topics[topic][partition]
            base = len(log)
            log.extend(values)
            self._batches.setdefault((topic, partition), []).append(
                (base, encode_record_batch(base, values)))

    def truncate_before(self, topic: str, partition: int,
                        offset: int) -> None:
        """Simulate retention: offsets below `offset` are gone; fetches
        below it return OFFSET_OUT_OF_RANGE."""
        with self._lock:
            self._truncated[(topic, partition)] = offset
            self._batches[(topic, partition)] = [
                (base, data) for base, data
                in self._batches.get((topic, partition), [])
                if base >= offset]

    def stop(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass

    # -- server loop
    def _serve(self) -> None:
        while self._running:
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return
            # qwlint: disable-next-line=QW003 - test-double connection
            # handler; no query context exists on this path
            # qwlint: disable-next-line=QW008 - indexing source loops and queue
            # test doubles outside the DST-raced path; rendezvous is
            # uninstrumentable real IO/time
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                size_raw = self._read_exact(conn, 4)
                if size_raw is None:
                    return
                size = struct.unpack(">i", size_raw)[0]
                frame = self._read_exact(conn, size)
                if frame is None:
                    return
                r = _Reader(frame)
                api_key = r.i16()
                api_version = r.i16()
                correlation = r.i32()
                r.string()  # client_id
                body = self._dispatch(api_key, api_version, r)
                response = struct.pack(">i", correlation) + body
                conn.sendall(struct.pack(">i", len(response)) + response)
        except (OSError, EOFError):
            pass
        finally:
            conn.close()

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        chunks = bytearray()
        while len(chunks) < n:
            chunk = conn.recv(n - len(chunks))
            if not chunk:
                return None
            chunks += chunk
        return bytes(chunks)

    # -- API handlers
    def _dispatch(self, api_key: int, api_version: int, r: _Reader) -> bytes:
        if api_key == 18:
            return self._api_versions()
        if api_key == 3:
            return self._metadata(r, api_version)
        if api_key == 2:
            return self._list_offsets(r)
        if api_key == 1:
            return self._fetch(r)
        # UNSUPPORTED_VERSION
        return struct.pack(">h", 35)

    def _api_versions(self) -> bytes:
        supported = [(18, 0, 0), (3, 0, 1), (2, 0, 1), (1, 0, 4)]
        out = struct.pack(">h", 0) + struct.pack(">i", len(supported))
        for key, lo, hi in supported:
            out += struct.pack(">hhh", key, lo, hi)
        return out

    def _metadata(self, r: _Reader, version: int) -> bytes:
        count = r.i32()
        with self._lock:
            names = (list(self._topics) if count < 0 else
                     [r.string() for _ in range(count)])
            brokers = [(self.node_id, self.host, self.port)] + [
                (b.node_id, b.host, b.port) for b in self.peer_brokers]
            out = struct.pack(">i", len(brokers))
            for node_id, host, port in brokers:
                out += struct.pack(">i", node_id) + _str(host) \
                    + struct.pack(">i", port)
                if version >= 1:
                    out += _str(None)            # rack
            if version >= 1:
                out += struct.pack(">i", self.node_id)  # controller_id
            out += struct.pack(">i", len(names))
            for name in names:
                exists = name in self._topics
                out += struct.pack(">h", 0 if exists else 3)  # UNKNOWN_TOPIC
                out += _str(name)
                if version >= 1:
                    out += struct.pack(">b", 0)  # is_internal
                partitions = self._topics.get(name, [])
                out += struct.pack(">i", len(partitions))
                for index in range(len(partitions)):
                    leader = self.partition_leaders.get(
                        (name, index), self.node_id)
                    out += struct.pack(">hiii", 0, index, leader, 1)
                    out += struct.pack(">i", leader)        # replicas [leader]
                    out += struct.pack(">ii", 1, leader)    # isr [leader]
            return out

    def _list_offsets(self, r: _Reader) -> bytes:
        r.i32()  # replica_id
        out_topics = []
        for _ in range(r.i32()):
            topic = r.string()
            partitions = []
            for _ in range(r.i32()):
                partition = r.i32()
                timestamp = r.i64()
                with self._lock:
                    log = self._topics.get(topic, [])
                    if partition >= len(log):
                        partitions.append((partition, 3, -1))
                        continue
                    if self.partition_leaders.get(
                            (topic, partition), self.node_id) != self.node_id:
                        partitions.append((partition, 6, -1))  # NOT_LEADER
                        continue
                    floor = self._truncated.get((topic, partition), 0)
                    offset = (floor if timestamp == EARLIEST
                              else len(log[partition]))
                partitions.append((partition, 0, offset))
            out_topics.append((topic, partitions))
        out = struct.pack(">i", len(out_topics))
        for topic, partitions in out_topics:
            out += _str(topic) + struct.pack(">i", len(partitions))
            for partition, error, offset in partitions:
                out += struct.pack(">ihqq", partition, error, -1, offset)
        return out

    def _fetch(self, r: _Reader) -> bytes:
        r.i32()  # replica_id
        r.i32()  # max_wait
        r.i32()  # min_bytes
        r.i32()  # max_bytes
        r.i8()   # isolation_level
        out_topics = []
        for _ in range(r.i32()):
            topic = r.string()
            partitions = []
            for _ in range(r.i32()):
                partition = r.i32()
                fetch_offset = r.i64()
                r.i32()  # partition max_bytes
                with self._lock:
                    if self.fail_next_fetches > 0:
                        self.fail_next_fetches -= 1
                        partitions.append((partition, 6, 0, b""))  # NOT_LEADER
                        continue
                    log = self._topics.get(topic, [])
                    if partition >= len(log):
                        partitions.append((partition, 3, 0, b""))
                        continue
                    if self.partition_leaders.get(
                            (topic, partition), self.node_id) != self.node_id:
                        partitions.append((partition, 6, 0, b""))
                        continue
                    if fetch_offset < self._truncated.get(
                            (topic, partition), 0):
                        partitions.append((partition, 1, 0, b""))  # OOR
                        continue
                    high = len(log[partition])
                    record_set = b"".join(
                        data for base, data
                        in self._batches.get((topic, partition), [])
                        if base + _batch_len(data) > fetch_offset)
                partitions.append((partition, 0, high, record_set))
            out_topics.append((topic, partitions))
        out = struct.pack(">i", 0)  # throttle
        out += struct.pack(">i", len(out_topics))
        for topic, partitions in out_topics:
            out += _str(topic) + struct.pack(">i", len(partitions))
            for partition, error, high, record_set in partitions:
                out += struct.pack(">ihqq", partition, error, high, high)
                out += struct.pack(">i", 0)  # aborted txns
                out += struct.pack(">i", len(record_set)) + record_set
        return out


def _batch_len(batch_data: bytes) -> int:
    """Number of records in one encoded batch (trailing numRecords of the
    fixed header)."""
    # header: baseOffset(8) batchLength(4) leaderEpoch(4) magic(1) crc(4)
    # attributes(2) lastOffsetDelta(4) ... numRecords at offset 57-4? Use
    # lastOffsetDelta + 1 at fixed offset 23.
    last_offset_delta = struct.unpack_from(">i", batch_data, 23)[0]
    return last_offset_delta + 1
