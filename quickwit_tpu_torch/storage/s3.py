"""S3-compatible object storage on the Python stdlib.

Role of the reference's
`quickwit-storage/src/object_storage/s3_compatible_storage.rs:1`: the
primary production backend — splits, metastore files, and WAL snapshots
all live in a bucket; searchers stay stateless because every byte is a
ranged GET away. The reference uses the AWS SDK; this image has no SDK,
so the S3 REST API is spoken directly over `http.client` with SigV4
request signing built from `hmac`/`hashlib` (the protocol is small:
canonical request → string-to-sign → derived signing key).

Works against AWS S3 and any S3-compatible endpoint (MinIO, the
in-process `fake_s3` test server) via path-style addressing.

Concurrency: one pooled HTTP connection per (thread, endpoint) —
`http.client` connections are not thread-safe, and the warmup path
issues ranged GETs from a thread pool.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import socket
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Iterable, Optional

from ..common.uri import Uri
from .base import StorageError
from .http_object import HttpObjectStorage

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
_RETRYABLE_STATUS = (500, 502, 503, 504)
_MAX_ATTEMPTS = 3
_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


@dataclass
class S3Config:
    """Connection/credential config, resolved from the environment by
    default (the same variables the AWS SDK reads)."""
    endpoint: str = ""          # e.g. "http://127.0.0.1:9000"; "" = AWS
    region: str = "us-east-1"
    access_key: str = ""
    secret_key: str = ""
    session_token: Optional[str] = None
    request_timeout_secs: float = 30.0

    @staticmethod
    def from_env(env: Optional[dict] = None) -> "S3Config":
        env = env if env is not None else os.environ
        return S3Config(
            endpoint=env.get("QW_S3_ENDPOINT", env.get("AWS_ENDPOINT_URL", "")),
            region=env.get("AWS_REGION", env.get("AWS_DEFAULT_REGION",
                                                 "us-east-1")),
            access_key=env.get("AWS_ACCESS_KEY_ID", ""),
            secret_key=env.get("AWS_SECRET_ACCESS_KEY", ""),
            session_token=env.get("AWS_SESSION_TOKEN"),
        )


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(method: str, host: str, canonical_uri: str,
                  query: list[tuple[str, str]], payload_sha256: str,
                  config: S3Config,
                  now: Optional[datetime.datetime] = None,
                  extra_headers: Optional[dict[str, str]] = None,
                  service: str = "s3") -> dict[str, str]:
    """AWS Signature Version 4 for one request. Returns the headers to
    send (including Authorization). Exposed for direct testing against
    the published AWS test vectors, and reused by other AWS-API clients
    (Kinesis source) via `service`."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    headers = {"host": host, "x-amz-content-sha256": payload_sha256,
               "x-amz-date": amz_date}
    if config.session_token:
        headers["x-amz-security-token"] = config.session_token
    if extra_headers:
        headers.update({k.lower(): v for k, v in extra_headers.items()})

    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query))
    signed_names = sorted(headers)
    canonical_headers = "".join(f"{k}:{headers[k].strip()}\n"
                                for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_sha256])

    scope = f"{datestamp}/{config.region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    key = _sign(f"AWS4{config.secret_key}".encode(), datestamp)
    key = _sign(key, config.region)
    key = _sign(key, service)
    key = _sign(key, "aws4_request")
    signature = hmac.new(key, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()

    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={config.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return headers


class S3CompatibleStorage(HttpObjectStorage):
    """`Storage` over the S3 REST API with SigV4 and path-style
    addressing. URI shape: `s3://bucket/prefix`. Connection pool, retry
    loop, and read paths live in HttpObjectStorage; this class adds the
    SigV4 signing hook and S3-specific operations."""

    service_name = "s3"

    def __init__(self, uri: Uri, config: Optional[S3Config] = None):
        self.config = config or S3Config.from_env()
        super().__init__(uri, self.config.request_timeout_secs)
        parts = uri.path.lstrip("/").split("/", 1)
        self.bucket = parts[0]
        self.prefix = parts[1].strip("/") if len(parts) > 1 else ""
        if not self.bucket:
            raise StorageError(f"s3 uri has no bucket: {uri}")
        self._init_endpoint(self.config.endpoint or
                            f"https://s3.{self.config.region}.amazonaws.com")

    @property
    def _root_segment(self) -> str:
        return self.bucket

    def _sign_headers(self, method, resource_path, query, body,
                      extra_headers):
        payload_sha = hashlib.sha256(body).hexdigest() if body \
            else _EMPTY_SHA256
        return sigv4_headers(method, self._host_header, resource_path,
                             query, payload_sha, self.config,
                             extra_headers=extra_headers)

    # --- Storage impl ----------------------------------------------------
    def put(self, path: str, payload: bytes) -> None:
        status, _, data = self._request("PUT", self._key(path), body=payload)
        self._check(status, data, "PUT", path)

    def bulk_delete(self, paths: Iterable[str]) -> None:
        """Multi-object delete (`POST /?delete`), 1000 keys per request —
        the reference's `bulk_delete` batches identically."""
        paths = list(paths)
        for i in range(0, len(paths), 1000):
            chunk = paths[i:i + 1000]
            objects = "".join(
                f"<Object><Key>{self._escape(self._key(p))}</Key></Object>"
                for p in chunk)
            body = (f"<Delete><Quiet>true</Quiet>{objects}</Delete>"
                    ).encode()
            content_md5 = self._content_md5(body)
            status, _, data = self._request(
                "POST", "", query=[("delete", "")], body=body,
                extra_headers={"content-md5": content_md5})
            self._check(status, data, "POST ?delete", f"{len(chunk)} keys")
            # quiet mode: body only contains <Error> entries
            if b"<Error>" in data:
                root = ET.fromstring(data)
                errors = [e.findtext(f"{_NS}Key") or e.findtext("Key")
                          for e in root.iter() if e.tag.endswith("Error")]
                errors = [e for e in errors if e]
                if errors:
                    raise StorageError(f"bulk delete failed for {errors}")

    @staticmethod
    def _escape(text: str) -> str:
        return (text.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    @staticmethod
    def _content_md5(body: bytes) -> str:
        import base64
        return base64.b64encode(hashlib.md5(body).digest()).decode()

    def list_files(self) -> list[str]:
        """ListObjectsV2 with pagination; returns keys relative to the
        prefix (the resolver roots each index at its own prefix)."""
        out: list[str] = []
        token: Optional[str] = None
        prefix = f"{self.prefix}/" if self.prefix else ""
        while True:
            query = [("list-type", "2"), ("prefix", prefix),
                     ("max-keys", "1000")]
            if token:
                query.append(("continuation-token", token))
            status, _, data = self._request("GET", "", query=query)
            self._check(status, data, "LIST", prefix)
            root = ET.fromstring(data)
            for contents in (list(root.iter(f"{_NS}Contents"))
                             or list(root.iter("Contents"))):
                key = (contents.findtext(f"{_NS}Key")
                       or contents.findtext("Key") or "")
                if key and not key.endswith("/"):
                    out.append(key[len(prefix):])
            token = (root.findtext(f"{_NS}NextContinuationToken")
                     or root.findtext("NextContinuationToken"))
            truncated = (root.findtext(f"{_NS}IsTruncated")
                         or root.findtext("IsTruncated"))
            if truncated != "true" or not token:
                break
        return sorted(out)
