"""Document sources.

Role of the reference's `Source` trait + implementations
(`quickwit-indexing/src/source/mod.rs:242`): pull-based batch emitters with
per-partition checkpoint positions. Implemented: `VecSource` (tests),
`FileSource` (ndjson, one partition per file), `VoidSource`, and the
ingest-WAL source lives in `ingest/` (shard fetch streams). Kafka/Kinesis/
Pulsar/SQS are interface-compatible stubs raising a clear error (their SDKs
are not in this image; the queue-source coordinator pattern of the reference
maps onto `Source` one-to-one).

Carried over whole from the JAX package's `indexing/sources.py`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from ..metastore.checkpoint import (
    BEGINNING, CheckpointDelta, SourceCheckpoint, offset_position,
)


@dataclass
class SourceBatch:
    docs: list[dict]
    checkpoint_delta: CheckpointDelta
    force_commit: bool = False


class Source:
    """Pull-based source: `batches()` yields until exhausted (bounded
    sources) or forever (streaming sources)."""

    def batches(self, checkpoint: SourceCheckpoint,
                batch_num_docs: int = 10_000) -> Iterator[SourceBatch]:
        raise NotImplementedError

    def partition_ids(self) -> list[str]:
        return []


class VecSource(Source):
    """In-memory doc list, single partition (reference `vec_source.rs`)."""

    def __init__(self, docs: list[dict], partition_id: str = "vec"):
        self.docs = docs
        self.partition_id = partition_id

    def batches(self, checkpoint: SourceCheckpoint,
                batch_num_docs: int = 10_000) -> Iterator[SourceBatch]:
        position = checkpoint.position_for(self.partition_id)
        start = int(position) if position != BEGINNING else 0
        for begin in range(start, len(self.docs), batch_num_docs):
            end = min(begin + batch_num_docs, len(self.docs))
            # positions count processed docs: from == previous batch's end
            delta = CheckpointDelta.from_range(
                self.partition_id,
                BEGINNING if begin == 0 else offset_position(begin),
                offset_position(end))
            yield SourceBatch(self.docs[begin:end], delta)

    def partition_ids(self) -> list[str]:
        return [self.partition_id]


class FileSource(Source):
    """One ndjson file = one partition; position = byte offset
    (reference `file_source.rs`)."""

    def __init__(self, path: str):
        self.path = path
        self.partition_id = f"file:{os.path.abspath(path)}"

    def batches(self, checkpoint: SourceCheckpoint,
                batch_num_docs: int = 10_000) -> Iterator[SourceBatch]:
        position = checkpoint.position_for(self.partition_id)
        start_offset = int(position) if position != BEGINNING else 0
        with open(self.path, "rb") as f:
            f.seek(start_offset)
            docs: list[dict] = []
            batch_start = start_offset
            while True:
                line = f.readline()
                if not line:
                    break
                stripped = line.strip()
                if stripped:
                    try:
                        docs.append(json.loads(stripped))
                    except json.JSONDecodeError:
                        docs.append({"_malformed": stripped.decode("utf-8", "replace")})
                if len(docs) >= batch_num_docs:
                    end_offset = f.tell()
                    yield self._batch(docs, batch_start, end_offset)
                    docs, batch_start = [], end_offset
            if docs:
                yield self._batch(docs, batch_start, f.tell())

    def _batch(self, docs: list[dict], start: int, end: int) -> SourceBatch:
        delta = CheckpointDelta.from_range(
            self.partition_id,
            BEGINNING if start == 0 else offset_position(start),
            offset_position(end))
        return SourceBatch(docs, delta)

    def partition_ids(self) -> list[str]:
        return [self.partition_id]


class VoidSource(Source):
    def batches(self, checkpoint: SourceCheckpoint,
                batch_num_docs: int = 10_000) -> Iterator[SourceBatch]:
        return iter(())


_UNSUPPORTED = {"pulsar", "gcp_pubsub"}


def parse_source_config(spec: Any) -> "Any":
    """Validated spec dict -> SourceConfig — the ONE place the REST
    route and the CLI share for defaults + config-time transform-script
    validation (reference: `source_config/mod.rs` deserialization).
    Raises ValueError (HTTP 400 at the REST boundary)."""
    from ..models.index_metadata import SourceConfig
    from .transform import transform_from_source_params
    if not isinstance(spec, dict):
        raise ValueError("source config must be a JSON/YAML object")
    if not isinstance(spec.get("source_id"), str):
        raise ValueError("source requires a string source_id")
    source = SourceConfig(
        source_id=spec["source_id"],
        source_type=spec.get("source_type", "vec"),
        params=spec.get("params", {}),
        enabled=spec.get("enabled", True))
    # reject bad transform scripts at config time, not ingest time
    transform_from_source_params(source.params)
    return source


def make_source(source_type: str, params: dict[str, Any],
                resolver=None) -> Source:
    """`resolver`: storage resolver for sources that FETCH notified
    objects (sqs); ignored by stream sources."""
    if source_type == "vec":
        return VecSource(params.get("docs", []), params.get("partition_id", "vec"))
    if source_type == "file":
        return FileSource(params["filepath"])
    if source_type == "void":
        return VoidSource()
    if source_type == "kafka":
        # reference SourceParams::Kafka shape: topic + librdkafka-style
        # client_params carrying bootstrap.servers
        from .kafka import KafkaSource
        servers = (params.get("client_params", {})
                   .get("bootstrap.servers")
                   or params.get("bootstrap_servers"))
        if not servers:
            raise ValueError(
                "kafka source requires client_params[\"bootstrap.servers\"]")
        if isinstance(servers, str):
            servers = [s.strip() for s in servers.split(",") if s.strip()]
        if "topic" not in params:
            raise ValueError("kafka source requires a topic")
        return KafkaSource(servers, params["topic"])
    if source_type == "kinesis":
        # reference SourceParams::Kinesis shape: stream_name + region;
        # endpoint override for non-AWS deployments (and the wire fake)
        from ..storage.s3 import S3Config
        from .kinesis import KinesisSource
        if "stream_name" not in params:
            raise ValueError("kinesis source requires a stream_name")
        # credentials: environment first (AWS_ACCESS_KEY_ID / ... — the
        # normal deployment shape), explicit params override (tests,
        # non-AWS endpoints)
        import dataclasses
        base = S3Config.from_env()
        region = params.get("region") or base.region or "us-east-1"
        endpoint = (params.get("endpoint")
                    or f"https://kinesis.{region}.amazonaws.com")
        config = dataclasses.replace(
            base, region=region,
            access_key=params.get("access_key", base.access_key),
            secret_key=params.get("secret_key", base.secret_key),
            session_token=params.get("session_token", base.session_token))
        return KinesisSource(endpoint, params["stream_name"], config)
    if source_type == "sqs":
        # reference SourceParams::Sqs shape: queue_url (+ region);
        # notifications carry the files to ingest
        import dataclasses

        from ..storage.s3 import S3Config
        from .sqs import SqsFileSource
        if "queue_url" not in params:
            raise ValueError("sqs source requires a queue_url")
        base = S3Config.from_env()
        region = params.get("region") or base.region or "us-east-1"
        endpoint = (params.get("endpoint")
                    or f"https://sqs.{region}.amazonaws.com")
        config = dataclasses.replace(
            base, region=region,
            access_key=params.get("access_key", base.access_key),
            secret_key=params.get("secret_key", base.secret_key),
            session_token=params.get("session_token", base.session_token))
        return SqsFileSource(endpoint, params["queue_url"], config,
                             resolver=resolver)
    if source_type in _UNSUPPORTED:
        raise NotImplementedError(
            f"source type {source_type!r} requires an external client SDK not "
            "available in this build; use 'file', 'vec', 'kafka', or the "
            "ingest API")
    raise ValueError(f"unknown source type {source_type!r}")


class IngestSource(Source):
    """WAL-shard source: streams records from the local Ingester's shards of
    one (index, source) with per-shard checkpoint positions (reference:
    `quickwit-indexing/src/source/ingest/mod.rs` reading ingester fetch
    streams; partitions == shard queue ids, positions == WAL record
    positions)."""

    def __init__(self, ingester, index_uid: str, source_id: str):
        self.ingester = ingester
        self.index_uid = index_uid
        self.source_id = source_id

    def partition_ids(self) -> list[str]:
        return [s.shard_id for s in self.ingester.list_shards(self.index_uid)
                if s.source_id == self.source_id]

    def batches(self, checkpoint: SourceCheckpoint,
                batch_num_docs: int = 10_000) -> Iterator[SourceBatch]:
        for shard in list(self.ingester.list_shards(self.index_uid)):
            if shard.source_id != self.source_id:
                continue
            current = checkpoint.position_for(shard.shard_id)
            start = 0 if current == BEGINNING else int(current)
            from_pos = current
            while True:
                records = self.ingester.fetch(
                    self.index_uid, self.source_id, shard.shard_id,
                    from_position=start, max_records=batch_num_docs)
                if not records:
                    break
                docs = [doc for _, doc in records]
                last = records[-1][0]
                delta = CheckpointDelta.from_range(
                    shard.shard_id, from_pos, offset_position(last + 1))
                yield SourceBatch(docs, delta)
                start = last + 1
                from_pos = offset_position(start)
