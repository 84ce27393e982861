"""Wire-accurate in-process SQS fake for tests (the localstack role the
reference's `sqs_tests.rs` plays). Speaks the AmazonSQS x-amz-json-1.0
target protocol — ReceiveMessage / DeleteMessageBatch — with SigV4
verification (service "sqs") via the same canonicalization the real
endpoint applies, plus visibility-timeout semantics so redelivery paths
are testable.

Carried over whole from the JAX package's `indexing/fake_sqs.py`.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..storage.s3 import _sign


class FakeSqsServer:
    def __init__(self, access_key: str = "", secret_key: str = "",
                 visibility_timeout: float = 30.0):
        self.access_key = access_key
        self.secret_key = secret_key
        self.visibility_timeout = visibility_timeout
        # message_id -> {"body", "receipt", "invisible_until"}
        self.messages: dict[str, dict] = {}
        self.deleted: list[str] = []
        # qwlint: disable-next-line=QW008 - indexing source loops and queue
        # test doubles outside the DST-raced path; rendezvous is
        # uninstrumentable real IO/time
        self.lock = threading.Lock()
        self.request_log: list[str] = []
        self.fail_requests = 0
        self.auth_failures = 0
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # noqa: D102 - silence
                pass

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/x-amz-json-1.0")
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
                if service != "sqs":
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
                if not hmac.compare_digest(expected, signature) \
                        or hashlib.sha256(body).hexdigest() != payload_sha:
                    server.auth_failures += 1
                    return False
                return True

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                action = self.headers.get("X-Amz-Target",
                                          "").split(".")[-1]
                with server.lock:
                    server.request_log.append(action)
                    if server.fail_requests > 0:
                        server.fail_requests -= 1
                        return self._reply(500, {"__type": "InternalFailure"})
                if not self._check_auth(body):
                    return self._reply(400, {
                        "__type": "IncompleteSignatureException",
                        "message": "signature mismatch"})
                payload = json.loads(body) if body else {}
                handler = getattr(server, f"_api_{action}", None)
                if handler is None:
                    return self._reply(400, {
                        "__type": "UnknownOperationException",
                        "message": f"unknown action {action!r}"})
                with server.lock:
                    out = handler(payload)
                return self._reply(200, out)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._httpd.server_port}"

    @property
    def queue_url(self) -> str:
        return f"{self.endpoint}/000000000000/test-queue"

    def start(self) -> "FakeSqsServer":
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

    # -- producer-side test helper -----------------------------------------
    def send_message(self, body: str) -> str:
        with self.lock:
            message_id = uuid.uuid4().hex
            self.messages[message_id] = {
                "body": body, "receipt": uuid.uuid4().hex,
                "invisible_until": 0.0}
            return message_id

    def visible_count(self) -> int:
        with self.lock:
            return len(self.messages)

    def make_visible_all(self) -> None:
        """Test seam: expire every in-flight visibility timeout (what
        wall-clock passage does on the real service)."""
        with self.lock:
            for m in self.messages.values():
                m["invisible_until"] = 0.0

    # -- consumer APIs -------------------------------------------------------
    def _api_ReceiveMessage(self, payload: dict) -> dict:  # noqa: N802
        now = time.monotonic()
        limit = int(payload.get("MaxNumberOfMessages", 1))
        out = []
        for message_id, m in self.messages.items():
            if m["invisible_until"] > now:
                continue
            m["invisible_until"] = now + self.visibility_timeout
            m["receipt"] = uuid.uuid4().hex  # fresh handle per delivery
            out.append({"MessageId": message_id,
                        "ReceiptHandle": m["receipt"],
                        "Body": m["body"]})
            if len(out) >= limit:
                break
        return {"Messages": out}

    def _api_DeleteMessageBatch(self, payload: dict) -> dict:  # noqa: N802
        successful, failed = [], []
        for entry in payload.get("Entries", []):
            message_id = entry["Id"]
            m = self.messages.get(message_id)
            if m is not None and m["receipt"] == entry.get("ReceiptHandle"):
                del self.messages[message_id]
                self.deleted.append(message_id)
                successful.append({"Id": message_id})
            else:
                failed.append({"Id": message_id, "Code": "ReceiptHandleIsInvalid",
                               "SenderFault": True})
        return {"Successful": successful, "Failed": failed}
