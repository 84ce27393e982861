"""Kafka source speaking the real Kafka wire protocol on stdlib sockets.

Role of the reference's `kafka_source.rs` (librdkafka-backed): consume
doc batches from Kafka topic partitions with per-partition checkpoint
positions flowing through the exactly-once `CheckpointDelta` publish
protocol. This build has no client SDK, so the protocol itself is
implemented here — the classic (non-flexible) encoding of the four APIs
a checkpointed consumer needs:

  ApiVersions(18) v0 · Metadata(3) v1 · ListOffsets(2) v1 · Fetch(1) v4

Offsets come from OUR metastore checkpoint (never Kafka consumer-group
state), exactly like the reference: quickwit stores partition offsets in
the `SourceCheckpoint` and replays from there after any crash, making
Kafka→split ingestion exactly-once (`checkpoint.rs:30`). Consumer-group
coordination is intentionally absent — the control plane assigns
(source, partition) work, so group rebalancing has no role.

RecordBatch v2 (magic=2) decoding with CRC32C verification; gzip
compression (attributes&7==1) handled; other codecs raise clearly.

Carried over whole from the JAX package's `indexing/kafka.py`.
"""

from __future__ import annotations

import gzip
import io
import socket
import struct
import threading
from typing import Any, Iterator, Optional

# --- primitive codecs (classic protocol: big-endian, i16-length strings) ---


def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode()
    return struct.pack(">h", len(raw)) + raw


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        if len(out) != n:
            raise EOFError("short kafka frame")
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self.take(n).decode()

    def raw_bytes(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self.take(n)

    def varzig(self) -> int:
        """Zigzag varint (record fields)."""
        shift = 0
        value = 0
        while True:
            b = self.take(1)[0]
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (value >> 1) ^ -(value & 1)


def _varzig(value: int) -> bytes:
    value = (value << 1) ^ (value >> 63) if value < 0 else value << 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# --- CRC32C (Castagnoli) — RecordBatch v2 integrity --------------------------

_CRC32C_TABLE = []


def _crc32c_table():
    if not _CRC32C_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            _CRC32C_TABLE.append(crc)
    return _CRC32C_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- record batches ----------------------------------------------------------


def encode_record_batch(base_offset: int, records: list[bytes],
                        first_timestamp: int = 0) -> bytes:
    """One RecordBatch v2 of null-key records (producer side — the fake
    broker and tests)."""
    body = bytearray()
    for i, value in enumerate(records):
        rec = bytearray()
        rec += b"\x00"                       # attributes
        rec += _varzig(0)                    # timestampDelta
        rec += _varzig(i)                    # offsetDelta
        rec += _varzig(-1)                   # null key
        rec += _varzig(len(value)) + value
        rec += _varzig(0)                    # headers
        body += _varzig(len(rec)) + bytes(rec)
    after_crc = (
        struct.pack(">hiqqqhii", 0, len(records) - 1, first_timestamp,
                    first_timestamp, -1, -1, -1, len(records))
        + bytes(body))
    crc = crc32c(after_crc)
    batch_tail = struct.pack(">ibI", 0, 2, crc) + after_crc
    return struct.pack(">qi", base_offset, len(batch_tail)) + batch_tail


def decode_record_batches(data: bytes) -> list[tuple[int, bytes]]:
    """(offset, value) pairs from a Fetch record_set (may hold several
    concatenated batches; a trailing partial batch is ignored, as per
    the protocol)."""
    out: list[tuple[int, bytes]] = []
    pos = 0
    while pos + 12 <= len(data):
        base_offset, batch_len = struct.unpack_from(">qi", data, pos)
        if pos + 12 + batch_len > len(data):
            break  # partial trailing batch
        batch = data[pos + 12: pos + 12 + batch_len]
        pos += 12 + batch_len
        r = _Reader(batch)
        r.i32()              # partitionLeaderEpoch
        magic = r.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        crc = r.u32()
        after_crc = batch[r.pos:]
        if crc32c(after_crc) != crc:
            raise ValueError("record batch CRC32C mismatch")
        attributes = r.i16()
        if attributes & 0x20:
            continue  # control batch: transaction markers, not documents
        r.i32()              # lastOffsetDelta
        r.i64()              # firstTimestamp
        r.i64()              # maxTimestamp
        r.i64()              # producerId
        r.i16()              # producerEpoch
        r.i32()              # baseSequence
        num_records = r.i32()
        payload = batch[r.pos:]
        codec = attributes & 0x07
        if codec == 1:
            payload = gzip.decompress(payload)
        elif codec != 0:
            raise ValueError(
                f"unsupported kafka compression codec {codec} "
                "(none and gzip are handled)")
        rr = _Reader(payload)
        for _ in range(num_records):
            rec_len = rr.varzig()
            rec = _Reader(rr.take(rec_len))
            rec.i8()                     # attributes
            rec.varzig()                 # timestampDelta
            offset_delta = rec.varzig()
            key_len = rec.varzig()
            if key_len >= 0:
                rec.take(key_len)
            val_len = rec.varzig()
            value = rec.take(val_len) if val_len >= 0 else b""
            out.append((base_offset + offset_delta, value))
    return out


# --- wire client -------------------------------------------------------------

EARLIEST = -2
LATEST = -1


class KafkaProtocolError(RuntimeError):
    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


OFFSET_OUT_OF_RANGE = 1


class _KafkaApiError(Exception):
    """Internal typed API error (carries the Kafka error code so the
    leader-retry logic can distinguish NOT_LEADER from the rest)."""

    def __init__(self, code: int, api: str, topic: str, partition: int):
        super().__init__(f"{api} error {code} on {topic}/{partition}")
        self.code = code


class KafkaWireClient:
    """Minimal Kafka client (the four consumer APIs) with partition-
    leader routing: Metadata's broker/leader map directs ListOffsets and
    Fetch to the partition's leader connection; NOT_LEADER errors
    refresh the metadata and retry once. Requests are serialized per
    client (a pipeline turn drains partitions sequentially, matching the
    reference source's single consumer poll loop)."""

    def __init__(self, bootstrap_servers: list[str], client_id: str = "qwtpu",
                 timeout: float = 10.0):
        self.bootstrap = bootstrap_servers
        self.client_id = client_id
        self.timeout = timeout
        self._socks: dict[str, socket.socket] = {}   # "host:port" -> conn
        self._brokers: dict[int, str] = {}           # node_id -> "host:port"
        self._leaders: dict[tuple[str, int], int] = {}
        self._correlation = 0
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self._lock = threading.Lock()

    # -- connection management
    def _connect(self, address: Optional[str] = None) -> tuple[str, socket.socket]:
        if address is not None:
            sock = self._socks.get(address)
            if sock is not None:
                return address, sock
            host, _, port = address.rpartition(":")
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=self.timeout)
            except OSError as exc:
                raise KafkaProtocolError(
                    f"cannot reach broker {address}: {exc}") from exc
            self._socks[address] = sock
            return address, sock
        if self._socks:
            return next(iter(self._socks.items()))
        last_err: Optional[Exception] = None
        for server in self.bootstrap:
            try:
                return self._connect(server)
            except KafkaProtocolError as exc:
                last_err = exc
        raise KafkaProtocolError(
            f"cannot reach any bootstrap server {self.bootstrap}: {last_err}")

    def close(self) -> None:
        for sock in self._socks.values():
            try:
                sock.close()
            except OSError:
                pass
        self._socks.clear()

    def _drop(self, address: str) -> None:
        sock = self._socks.pop(address, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _leader_address(self, topic: str, partition: int) -> Optional[str]:
        leader = self._leaders.get((topic, partition))
        if leader is None:
            return None
        return self._brokers.get(leader)

    def _roundtrip(self, api_key: int, api_version: int, body: bytes,
                   address: Optional[str] = None) -> _Reader:
        with self._lock:
            self._correlation += 1
            correlation = self._correlation
            header = (struct.pack(">hhi", api_key, api_version, correlation)
                      + _str(self.client_id))
            frame = header + body
            address, sock = self._connect(address)
            try:
                sock.sendall(struct.pack(">i", len(frame)) + frame)
                raw = self._read_frame(sock)
            except OSError as exc:
                self._drop(address)
                raise KafkaProtocolError(f"kafka io error: {exc}") from exc
            r = _Reader(raw)
            got = r.i32()
            if got != correlation:
                self._drop(address)
                raise KafkaProtocolError(
                    f"correlation mismatch: {got} != {correlation}")
            return r

    def _read_frame(self, sock: socket.socket) -> bytes:
        size_raw = self._read_exact(sock, 4)
        size = struct.unpack(">i", size_raw)[0]
        return self._read_exact(sock, size)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        chunks = bytearray()
        while len(chunks) < n:
            chunk = sock.recv(n - len(chunks))
            if not chunk:
                raise OSError("connection closed by broker")
            chunks += chunk
        return bytes(chunks)

    # -- APIs
    def api_versions(self) -> dict[int, tuple[int, int]]:
        r = self._roundtrip(18, 0, b"")
        error = r.i16()
        if error:
            raise KafkaProtocolError(f"ApiVersions error {error}")
        out = {}
        for _ in range(r.i32()):
            key, lo, hi = r.i16(), r.i16(), r.i16()
            out[key] = (lo, hi)
        return out

    def metadata(self, topics: Optional[list[str]] = None) -> dict[str, Any]:
        body = struct.pack(">i", -1) if topics is None else (
            struct.pack(">i", len(topics))
            + b"".join(_str(t) for t in topics))
        r = self._roundtrip(3, 1, body)
        brokers = []
        for _ in range(r.i32()):
            node_id = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            brokers.append({"node_id": node_id, "host": host, "port": port})
        r.i32()  # controller_id
        out_topics = {}
        for _ in range(r.i32()):
            error = r.i16()
            name = r.string()
            r.i8()  # is_internal
            partitions = []
            for _ in range(r.i32()):
                p_error = r.i16()
                index = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                partitions.append({"partition": index, "leader": leader,
                                   "error": p_error})
            out_topics[name] = {"error": error, "partitions": partitions}
        # refresh the routing tables
        self._brokers = {b["node_id"]: f"{b['host']}:{b['port']}"
                         for b in brokers}
        for name, topic_meta in out_topics.items():
            for p in topic_meta["partitions"]:
                self._leaders[(name, p["partition"])] = p["leader"]
        return {"brokers": brokers, "topics": out_topics}

    _NOT_LEADER = 6

    def list_offsets(self, topic: str, partitions: list[int],
                     timestamp: int = EARLIEST) -> dict[int, int]:
        out: dict[int, int] = {}
        for partition in partitions:
            out[partition] = self._with_leader_retry(
                topic, partition,
                lambda addr, p=partition: self._list_offsets_one(
                    topic, p, timestamp, addr))
        return out

    def _list_offsets_one(self, topic: str, partition: int, timestamp: int,
                          address: Optional[str]) -> int:
        body = (struct.pack(">i", -1) + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iq", partition, timestamp))
        r = self._roundtrip(2, 1, body, address=address)
        offset = -1
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                error = r.i16()
                r.i64()  # timestamp
                offset = r.i64()
                if error:
                    raise _KafkaApiError(error, "ListOffsets",
                                         topic, partition)
        return offset

    def _with_leader_retry(self, topic: str, partition: int, call):
        """Run `call(leader_address)`; on NOT_LEADER (or a missing
        route), refresh metadata and retry once against the new leader."""
        address = self._leader_address(topic, partition)
        try:
            return call(address)
        except _KafkaApiError as exc:
            if exc.code != self._NOT_LEADER:
                raise KafkaProtocolError(str(exc), code=exc.code) from exc
            self.metadata([topic])
            new_address = self._leader_address(topic, partition)
            if new_address == address:
                raise KafkaProtocolError(str(exc), code=exc.code) from exc
            try:
                return call(new_address)
            except _KafkaApiError as exc2:
                raise KafkaProtocolError(str(exc2), code=exc2.code) from exc2

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 4 << 20, max_wait_ms: int = 100
              ) -> tuple[list[tuple[int, bytes]], int]:
        """((offset, value) records, high_watermark)."""
        return self._with_leader_retry(
            topic, partition,
            lambda addr: self._fetch_one(topic, partition, offset,
                                         max_bytes, max_wait_ms, addr))

    def _fetch_one(self, topic: str, partition: int, offset: int,
                   max_bytes: int, max_wait_ms: int,
                   address: Optional[str]) -> tuple[list[tuple[int, bytes]], int]:
        body = (struct.pack(">iiii", -1, max_wait_ms, 1, max_bytes)
                + struct.pack(">b", 0)          # isolation_level
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iqi", partition, offset, max_bytes))
        r = self._roundtrip(1, 4, body, address=address)
        r.i32()  # throttle_time
        records: list[tuple[int, bytes]] = []
        high_watermark = 0
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                error = r.i16()
                high_watermark = r.i64()
                r.i64()  # last_stable_offset
                aborted = r.i32()
                for _ in range(max(aborted, 0)):
                    r.i64()
                    r.i64()
                record_set = r.raw_bytes() or b""
                if error:
                    raise _KafkaApiError(error, "Fetch", topic, partition)
                # brokers return the whole batch CONTAINING the requested
                # offset; records before it are the consumer's to skip
                records.extend(
                    (off, value)
                    for off, value in decode_record_batches(record_set)
                    if off >= offset)
        return records, high_watermark


# --- the Source --------------------------------------------------------------


class KafkaSource:
    """Checkpointed Kafka topic source (reference `kafka_source.rs`).

    Partitions map to checkpoint partition ids "{topic}:{partition}";
    positions are THE NEXT OFFSET TO READ (Kafka convention). Each
    pipeline turn drains every partition up to its current high
    watermark — bounded work per turn, so the indexing pipeline's
    commit/turn machinery paces consumption (the reference's poll loop
    with its batch deadline plays this role)."""

    def __init__(self, bootstrap_servers: list[str], topic: str,
                 client_id: str = "qwtpu-source",
                 max_fetch_bytes: int = 4 << 20):
        self.topic = topic
        self.client = KafkaWireClient(bootstrap_servers, client_id)
        self.max_fetch_bytes = max_fetch_bytes
        self._partitions: Optional[list[int]] = None

    def close(self) -> None:
        self.client.close()

    def _topic_partitions(self) -> list[int]:
        if self._partitions is None:
            meta = self.client.metadata([self.topic])
            topic_meta = meta["topics"].get(self.topic)
            if topic_meta is None or topic_meta["error"]:
                raise KafkaProtocolError(
                    f"topic {self.topic!r} not available: {topic_meta}")
            self._partitions = sorted(
                p["partition"] for p in topic_meta["partitions"])
        return self._partitions

    def partition_ids(self) -> list[str]:
        return [f"{self.topic}:{p}" for p in self._topic_partitions()]

    def batches(self, checkpoint, batch_num_docs: int = 10_000):
        import json as _json

        from ..metastore.checkpoint import (
            BEGINNING, CheckpointDelta, offset_position)
        from .sources import SourceBatch

        partitions = self._topic_partitions()
        earliest = self.client.list_offsets(self.topic, partitions, EARLIEST)
        # snapshot the drain target per pass: under continuous production
        # the live high watermark keeps moving, and chasing it would make
        # a "pass" unbounded — the next tick picks up from here
        latest = self.client.list_offsets(self.topic, partitions, LATEST)
        for partition in partitions:
            partition_id = f"{self.topic}:{partition}"
            position = checkpoint.position_for(partition_id)
            offset = (earliest[partition] if position == BEGINNING
                      else int(position))
            target = latest[partition]
            while offset < target:
                try:
                    records, _high = self.client.fetch(
                        self.topic, partition, offset,
                        max_bytes=self.max_fetch_bytes)
                except KafkaProtocolError as exc:
                    if exc.code == OFFSET_OUT_OF_RANGE:
                        # refresh the floor first: retention may have
                        # truncated DURING this pass, making the snapshot
                        # taken at pass start stale
                        earliest[partition] = self.client.list_offsets(
                            self.topic, [partition], EARLIEST)[partition]
                        if earliest[partition] > offset:
                            # retention truncated past the checkpoint:
                            # resume at the earliest retained offset (the
                            # records in between are gone —
                            # auto.offset.reset=earliest semantics; the
                            # checkpoint jump is the honest record of loss)
                            offset = earliest[partition]
                            continue
                    raise
                records = [(off, v) for off, v in records if off < target]
                if not records:
                    break
                docs = []
                for _off, value in records[:batch_num_docs]:
                    try:
                        docs.append(_json.loads(value))
                    except (ValueError, UnicodeDecodeError):
                        docs.append({"_malformed":
                                     value.decode("utf-8", "replace")})
                taken = records[:batch_num_docs]
                next_offset = taken[-1][0] + 1
                # the delta always starts at the STORED position — after a
                # retention reset it spans the truncated hole, keeping the
                # exactly-once chain contiguous
                delta = CheckpointDelta.from_range(
                    partition_id, position, offset_position(next_offset))
                yield SourceBatch(docs, delta)
                position = offset_position(next_offset)
                offset = next_offset
