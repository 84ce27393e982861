"""Wire-accurate in-process Kinesis fake for tests.

Speaks the same x-amz-json-1.1 target protocol the real service does —
ListShards / GetShardIterator / GetRecords — over stdlib HTTP, and
VERIFIES SigV4 request signatures (service "kinesis") with the identical
canonicalization the real endpoint applies, so the client's signing path
is tested end-to-end (the role localstack plays for the reference's
`sqs_tests.rs`). Producer-side helpers (`put_record`) exist for tests;
they are not part of the consumer protocol under test.

Fault injection: `fail_requests` makes the next N calls return 500
(client retry behavior), `empty_pages` forces GetRecords to return empty
pages while behind (Kinesis semantics tests).

Carried over whole from the JAX package's `indexing/fake_kinesis.py`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ..storage.s3 import _sign


class FakeKinesisServer:
    def __init__(self, access_key: str = "", secret_key: str = "",
                 num_shards: int = 2):
        self.access_key = access_key
        self.secret_key = secret_key
        self.num_shards = num_shards
        # stream -> shard_id -> list[(sequence_number:int, data:bytes)]
        self.streams: dict[str, dict[str, list[tuple[int, bytes]]]] = {}
        self._sequence = 10**20  # realistic magnitude, strictly increasing
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self.lock = threading.Lock()
        self.request_log: list[str] = []
        self.fail_requests = 0
        self.throttle_requests = 0  # next N calls: throughput-exceeded 400
        self.empty_pages = 0
        self.auth_failures = 0
        self.records_page_limit: Optional[int] = None  # force small pages
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # noqa: D102 - silence
                pass

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/x-amz-json-1.1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _check_auth(self, body: bytes) -> bool:
                if not server.secret_key:
                    return True
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("AWS4-HMAC-SHA256 "):
                    return False
                try:
                    fields = dict(
                        part.strip().split("=", 1)
                        for part in auth[len("AWS4-HMAC-SHA256 "):]
                        .split(","))
                    credential = fields["Credential"]
                    signed_headers = fields["SignedHeaders"]
                    signature = fields["Signature"]
                    _akid, datestamp, region, service, _term = \
                        credential.split("/")
                except (KeyError, ValueError):
                    return False
                if service != "kinesis":
                    return False
                names = signed_headers.split(";")
                canonical_headers = "".join(
                    f"{n}:{(self.headers.get(n) or '').strip()}\n"
                    for n in names)
                payload_sha = self.headers.get("x-amz-content-sha256", "")
                canonical_request = "\n".join([
                    "POST", "/", "", canonical_headers, signed_headers,
                    payload_sha])
                scope = f"{datestamp}/{region}/{service}/aws4_request"
                string_to_sign = "\n".join([
                    "AWS4-HMAC-SHA256",
                    self.headers.get("x-amz-date", ""), scope,
                    hashlib.sha256(canonical_request.encode()).hexdigest()])
                key = _sign(f"AWS4{server.secret_key}".encode(), datestamp)
                key = _sign(key, region)
                key = _sign(key, service)
                key = _sign(key, "aws4_request")
                expected = hmac.new(key, string_to_sign.encode(),
                                    hashlib.sha256).hexdigest()
                if not hmac.compare_digest(expected, signature):
                    server.auth_failures += 1
                    return False
                if hashlib.sha256(body).hexdigest() != payload_sha:
                    server.auth_failures += 1
                    return False
                return True

            def do_POST(self):  # noqa: N802 - stdlib naming
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                target = self.headers.get("X-Amz-Target", "")
                action = target.split(".")[-1]
                with server.lock:
                    server.request_log.append(action)
                    if server.fail_requests > 0:
                        server.fail_requests -= 1
                        return self._reply(500, {
                            "__type": "InternalFailure"})
                    if server.throttle_requests > 0:
                        server.throttle_requests -= 1
                        return self._reply(400, {
                            "__type": "ProvisionedThroughputExceeded"
                                      "Exception",
                            "message": "Rate exceeded"})
                if not self._check_auth(body):
                    return self._reply(400, {
                        "__type": "IncompleteSignatureException",
                        "message": "signature mismatch"})
                try:
                    payload = json.loads(body) if body else {}
                except ValueError:
                    return self._reply(400, {
                        "__type": "SerializationException"})
                handler = getattr(server, f"_api_{action}", None)
                if handler is None:
                    return self._reply(400, {
                        "__type": "UnknownOperationException",
                        "message": f"unknown action {action!r}"})
                try:
                    with server.lock:
                        out = handler(payload)
                except KeyError as exc:
                    return self._reply(400, {
                        "__type": "ResourceNotFoundException",
                        "message": str(exc)})
                except ValueError as exc:
                    return self._reply(400, {
                        "__type": "InvalidArgumentException",
                        "message": str(exc)})
                return self._reply(200, out)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._httpd.server_port}"

    def start(self) -> "FakeKinesisServer":
        # qwlint: disable-next-line=QW003 - test-double HTTP server; no
        # query context exists on this path
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- producer-side test helpers ----------------------------------------
    def create_stream(self, stream: str,
                      num_shards: Optional[int] = None) -> None:
        with self.lock:
            shards = num_shards or self.num_shards
            self.streams[stream] = {
                f"shardId-{i:012d}": [] for i in range(shards)}

    def add_shard(self, stream: str) -> str:
        """Simulate a scale-up reshard: one more shard appears."""
        with self.lock:
            shards = self.streams[stream]
            shard_id = f"shardId-{len(shards):012d}"
            shards[shard_id] = []
            return shard_id

    def put_record(self, stream: str, data: bytes,
                   shard: Optional[int] = None) -> str:
        """Append one record; returns its sequence number. Without an
        explicit shard, records round-robin (test determinism beats the
        real service's partition-key hashing here)."""
        with self.lock:
            shards = self.streams[stream]
            shard_ids = sorted(shards)
            if shard is None:
                shard = sum(len(r) for r in shards.values()) % len(shard_ids)
            self._sequence += 1
            shards[shard_ids[shard]].append((self._sequence, data))
            return str(self._sequence)

    # -- the consumer APIs --------------------------------------------------
    def _api_ListShards(self, payload: dict) -> dict:  # noqa: N802
        stream = payload.get("StreamName")
        if stream not in self.streams:
            raise KeyError(f"stream {stream!r} not found")
        return {"Shards": [{"ShardId": sid}
                           for sid in sorted(self.streams[stream])]}

    def _api_GetShardIterator(self, payload: dict) -> dict:  # noqa: N802
        stream = payload["StreamName"]
        shard_id = payload["ShardId"]
        if shard_id not in self.streams.get(stream, {}):
            raise KeyError(f"shard {shard_id!r} not found")
        kind = payload["ShardIteratorType"]
        if kind == "TRIM_HORIZON":
            after = 0
        elif kind == "AFTER_SEQUENCE_NUMBER":
            after = int(payload["StartingSequenceNumber"])
        elif kind == "AT_SEQUENCE_NUMBER":
            after = int(payload["StartingSequenceNumber"]) - 1
        elif kind == "LATEST":
            records = self.streams[stream][shard_id]
            after = records[-1][0] if records else 0
        else:
            raise ValueError(f"iterator type {kind!r} not supported")
        token = base64.b64encode(json.dumps(
            {"s": stream, "h": shard_id, "a": after}).encode()).decode()
        return {"ShardIterator": token}

    def _api_GetRecords(self, payload: dict) -> dict:  # noqa: N802
        token = json.loads(base64.b64decode(payload["ShardIterator"]))
        limit = int(payload.get("Limit", 10_000))
        if self.records_page_limit is not None:
            limit = min(limit, self.records_page_limit)
        records = self.streams[token["s"]][token["h"]]
        pending = [(seq, data) for seq, data in records
                   if seq > token["a"]]
        if self.empty_pages > 0 and pending:
            self.empty_pages -= 1
            page = []
        else:
            page = pending[:limit]
        last = page[-1][0] if page else token["a"]
        next_token = base64.b64encode(json.dumps(
            {"s": token["s"], "h": token["h"], "a": last}).encode()).decode()
        behind = len(pending) - len(page)
        return {
            "Records": [{
                "SequenceNumber": str(seq),
                "Data": base64.b64encode(data).decode(),
                "ApproximateArrivalTimestamp": 0,
                "PartitionKey": "pk",
            } for seq, data in page],
            "NextShardIterator": next_token,
            "MillisBehindLatest": 1000 if behind > 0 else 0,
        }
