"""Shared AWS JSON-protocol client (Kinesis, SQS) on stdlib HTTP.

One copy of the signed-call machinery: x-amz-json target protocol over a
persistent `http.client` connection, SigV4 via the canonical signer from
storage/s3.py, and the retry envelope (transient 5xx + service throttle
types back off and retry; a dead kept-alive connection re-dials once per
attempt).

Carried over whole from the JAX package's `indexing/aws_json.py`.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import time
from typing import Any, Optional
from urllib.parse import urlparse

from ..storage.s3 import S3Config, sigv4_headers


class AwsApiError(RuntimeError):
    def __init__(self, message: str, error_type: Optional[str] = None):
        super().__init__(message)
        self.error_type = error_type


class AwsJsonClient:
    """Subclasses set `service` (SigV4 scope), `target_prefix`
    ("Kinesis_20131202" / "AmazonSQS"), `content_type`,
    `retryable_types` (service throttle __type names), and
    `error_class` (the service-specific AwsApiError subclass every
    failure surfaces as)."""

    service = "aws"
    target_prefix = ""
    content_type = "application/x-amz-json-1.1"
    retryable_types: tuple[str, ...] = ()
    error_class = AwsApiError
    _RETRYABLE_STATUS = (500, 502, 503, 504)
    _MAX_ATTEMPTS = 3

    def __init__(self, endpoint: str, config: S3Config,
                 timeout: float = 30.0):
        parsed = urlparse(endpoint if "//" in endpoint
                          else f"http://{endpoint}")
        self.scheme = parsed.scheme or "http"
        self.host = parsed.hostname or endpoint
        self.port = parsed.port or (443 if self.scheme == "https" else 80)
        self.config = config
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            cls = (http.client.HTTPSConnection if self.scheme == "https"
                   else http.client.HTTPConnection)
            self._conn = cls(self.host, self.port, timeout=self.timeout)
        return self._conn

    def call(self, action: str, payload: dict[str, Any]) -> dict[str, Any]:
        body = json.dumps(payload).encode()
        host_header = (self.host if self.port in (80, 443)
                       else f"{self.host}:{self.port}")
        headers = sigv4_headers(
            "POST", host_header, "/", [],
            hashlib.sha256(body).hexdigest(), self.config,
            extra_headers={
                "content-type": self.content_type,
                "x-amz-target": f"{self.target_prefix}.{action}",
            },
            service=self.service)
        last_error: Optional[AwsApiError] = None
        for attempt in range(1, self._MAX_ATTEMPTS + 1):
            try:
                conn = self._connection()
                conn.request("POST", "/", body=body, headers=headers)
                response = conn.getresponse()
                raw = response.read()
            except (http.client.HTTPException, OSError) as exc:
                self.close()
                last_error = self.error_class(
                    f"{self.service} transport error: {exc}")
                if attempt == self._MAX_ATTEMPTS:
                    raise last_error
                time.sleep(0.05 * attempt)
                continue
            try:
                decoded = json.loads(raw) if raw else {}
            except ValueError:
                decoded = {}  # proxy HTML error page etc: status rules
            if response.status == 200:
                return decoded
            error_type = (decoded.get("__type") or "").split("#")[-1]
            last_error = self.error_class(
                decoded.get("message") or decoded.get("Message")
                or f"{self.service} call {action} failed: "
                   f"{response.status}",
                error_type=error_type or None)
            if (response.status in self._RETRYABLE_STATUS
                    or error_type in self.retryable_types) \
                    and attempt < self._MAX_ATTEMPTS:
                time.sleep(0.05 * attempt)
                continue
            raise last_error
        raise last_error  # unreachable; keeps the type checker honest
