"""SQS file-notification source speaking the real SQS JSON API.

Role of the reference's queue-source framework
(`quickwit-indexing/src/source/queue_sources/coordinator.rs:1`, the SQS
notification source): queue messages carry OBJECT NOTIFICATIONS (S3
event records or raw object URIs); the source fetches each notified
file through the storage layer, indexes its ndjson rows, and the file
URI becomes a checkpoint partition at EOF — at-least-once queue
delivery + checkpoint dedupe = exactly-once indexing, exactly the
reference's `QueueSharedState` design.

Message acknowledgment is garbage collection, not correctness: a
message is deleted only once the checkpoint PROVES its file published
(so a crash between indexing and deleting re-delivers the message, the
checkpoint shows the file done, and the message is deleted then). The
visibility timeout is the redelivery mechanism; no state lives in SQS.

Wire protocol: the AmazonSQS JSON target protocol (x-amz-json-1.0 +
SigV4, shared `AwsJsonClient` machinery) — ReceiveMessage /
DeleteMessageBatch; no SDK.

Carried over whole from the JAX package's `indexing/sqs.py`.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Iterator, Optional

from ..storage.s3 import S3Config
from .aws_json import AwsApiError, AwsJsonClient  # noqa: F401 - AwsApiError re-exported

logger = logging.getLogger(__name__)

# checkpoint position for a fully-indexed file, mirroring the
# reference's Position::Eof — padded above 20 chars so it orders AFTER
# every intermediate "%020d" chunk position under the checkpoint's
# (length, lexicographic) ordering
EOF_POSITION = "~" * 20 + "eof"


class SqsError(AwsApiError):
    pass


class SqsWireClient(AwsJsonClient):
    service = "sqs"
    target_prefix = "AmazonSQS"
    content_type = "application/x-amz-json-1.0"
    retryable_types = ("RequestThrottled",
                       "OverLimit")
    error_class = SqsError

    def receive(self, queue_url: str, max_messages: int = 10
                ) -> list[dict[str, Any]]:
        out = self.call("ReceiveMessage", {
            "QueueUrl": queue_url,
            "MaxNumberOfMessages": max(1, min(max_messages, 10)),
            "WaitTimeSeconds": 0,
        })
        return out.get("Messages", []) or []

    def delete_batch(self, queue_url: str,
                     handles: list[tuple[str, str]]) -> None:
        """handles: (message_id, receipt_handle) pairs, ≤10 per call.
        Deduplicated by message id — SQS rejects a whole batch whose
        entry Ids are not distinct."""
        unique = list({message_id: (message_id, handle)
                       for message_id, handle in handles}.values())
        for i in range(0, len(unique), 10):
            chunk = unique[i:i + 10]
            self.call("DeleteMessageBatch", {
                "QueueUrl": queue_url,
                "Entries": [{"Id": message_id, "ReceiptHandle": handle}
                            for message_id, handle in chunk],
            })


def notified_uris(body: str) -> list[str]:
    """Object URIs out of one message body: an S3 event notification
    (Records[].s3.bucket/object), an SNS envelope wrapping one, or a raw
    URI per line (the reference accepts raw paths too)."""
    try:
        payload = json.loads(body)
    except ValueError:
        payload = None
    if isinstance(payload, dict):
        if "Records" not in payload and isinstance(payload.get("Message"),
                                                   str):
            return notified_uris(payload["Message"])  # SNS envelope
        uris = []
        for record in payload.get("Records", []):
            s3 = record.get("s3") or {}
            bucket = (s3.get("bucket") or {}).get("name")
            key = (s3.get("object") or {}).get("key")
            if bucket and key:
                from urllib.parse import unquote_plus
                uris.append(f"s3://{bucket}/{unquote_plus(key)}")
        return uris
    return [line.strip() for line in body.splitlines() if line.strip()]


class SqsFileSource:
    """Checkpointed SQS notification source. Each notified file is a
    checkpoint partition; its position jumps BEGINNING → EOF when its
    rows publish. Bounded work per pass: at most `max_messages_per_pass`
    messages are received per batches() call."""

    def __init__(self, endpoint: str, queue_url: str, config: S3Config,
                 resolver=None, max_messages_per_pass: int = 50):
        self.queue_url = queue_url
        self.client = SqsWireClient(endpoint, config)
        from ..storage.base import StorageResolver
        self.resolver = resolver or StorageResolver.default()
        self.max_messages_per_pass = max_messages_per_pass
        # message_id -> (receipt_handle, {file uris}): a message deletes
        # only once EVERY file it notified reaches EOF in the checkpoint
        # (a multi-file message must not lose a sibling whose indexing is
        # still pending)
        self._pending_acks: dict[str, tuple[str, set]] = {}

    def close(self) -> None:
        self.client.close()

    def partition_ids(self) -> list[str]:
        return []  # partitions materialize per notified file

    def _read_file(self, uri: str) -> "Optional[list[dict]]":
        from ..common.uri import Uri
        try:
            parsed = Uri.parse(uri)
            parent, _, name = uri.rpartition("/")
            storage = self.resolver.resolve(parent or str(parsed))
            raw = storage.get_all(name)
        except Exception as exc:  # noqa: BLE001 - poisoned notification
            logger.warning("sqs-notified file %s unreadable: %s", uri, exc)
            return None
        docs = []
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                docs.append(json.loads(line))
            except ValueError:
                docs.append({"_malformed":
                             line.decode("utf-8", "replace")
                             if isinstance(line, bytes) else line})
        return docs

    def _ack_published(self, checkpoint) -> None:
        done = [
            (message_id, handle)
            for message_id, (handle, uris) in self._pending_acks.items()
            if all(checkpoint.position_for(uri) == EOF_POSITION
                   for uri in uris)
        ]
        if done:
            self.client.delete_batch(self.queue_url, done)
            for message_id, _h in done:
                self._pending_acks.pop(message_id, None)

    def batches(self, checkpoint, batch_num_docs: int = 10_000
                ) -> Iterator[Any]:
        from ..metastore.checkpoint import BEGINNING, CheckpointDelta
        from .sources import SourceBatch

        # garbage-collect messages whose files a PREVIOUS pass published
        # (ack-after-publish: the checkpoint is the proof)
        self._ack_published(checkpoint)

        received = 0
        immediate_deletes: list[tuple[str, str]] = []
        # per-PASS emit guard: a message redelivered within one pass must
        # not double-yield a file. ACROSS passes the checkpoint governs —
        # a file yielded but never published (failed pipeline pass) re-
        # emits safely because nothing was applied.
        emitted: set[str] = set()
        while received < self.max_messages_per_pass:
            messages = self.client.receive(
                self.queue_url,
                min(10, self.max_messages_per_pass - received))
            if not messages:
                break
            received += len(messages)
            for message in messages:
                message_id = message.get("MessageId", "")
                receipt = message.get("ReceiptHandle", "")
                uris = notified_uris(message.get("Body", ""))
                if not uris:
                    # no object notifications at all (s3:TestEvent and
                    # the like): delete, or it redelivers forever and
                    # starves real notifications out of the receive slots
                    immediate_deletes.append((message_id, receipt))
                    continue
                tracked = False
                for uri in uris:
                    position = checkpoint.position_for(uri)
                    if position == EOF_POSITION or uri in emitted:
                        continue  # published, or yielded this pass
                    docs = self._read_file(uri)
                    if docs is None:
                        continue  # unreadable: visibility timeout retries
                    emitted.add(uri)
                    if not tracked:
                        self._pending_acks[message_id] = (receipt,
                                                          set(uris))
                        tracked = True
                    # crash-mid-file resume: an intermediate "%020d"
                    # position is the doc offset to continue from
                    start0 = 0 if position == BEGINNING else int(position)
                    for start in range(start0, max(len(docs), start0 + 1),
                                       batch_num_docs):
                        chunk = docs[start:start + batch_num_docs]
                        is_last = start + batch_num_docs >= len(docs)
                        delta = CheckpointDelta.from_range(
                            uri, BEGINNING if start == 0
                            else f"{start:020d}",
                            EOF_POSITION if is_last
                            else f"{start + batch_num_docs:020d}")
                        yield SourceBatch(chunk, delta)
                if not tracked and all(
                        checkpoint.position_for(u) == EOF_POSITION
                        for u in uris):
                    # crash-after-publish replay: every file in this
                    # message is provably published — delete it now
                    immediate_deletes.append((message_id, receipt))
        if immediate_deletes:
            self.client.delete_batch(self.queue_url, immediate_deletes)
        # files that published DURING this pass ack on the NEXT pass
        # (the checkpoint object is the pass-start snapshot; the metastore
        # applied the deltas at publish time)
