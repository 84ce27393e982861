"""Shared machinery for HTTP object-storage backends (S3, Azure, GCS).

One copy of the per-thread connection pool, the bounded retry loop with
exponential backoff and connection recycling, path validation, status→
StorageError mapping, and the ranged/whole-object read paths — the
backends differ only in how a request is SIGNED (`_sign_headers`) and in
service-specific operations (put headers, delete semantics, listing)."""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.parse
from typing import Optional

from ..common.uri import Uri
from .base import Storage, StorageError

_RETRYABLE_STATUS = (500, 502, 503, 504)
_MAX_ATTEMPTS = 3


class HttpObjectStorage(Storage):
    """Base for storage backends speaking HTTP to an object service.
    Subclasses set `service_name`, `_root_segment` (bucket/container),
    `prefix`, endpoint fields via `_init_endpoint`, and implement
    `_sign_headers`."""

    service_name = "object"

    def __init__(self, uri: Uri, timeout_secs: float):
        super().__init__(uri)
        self._timeout_secs = timeout_secs
        self._local = threading.local()

    def _init_endpoint(self, endpoint: str) -> None:
        parsed = urllib.parse.urlparse(endpoint)
        self._secure = parsed.scheme == "https"
        self._host = parsed.hostname or ""
        self._port = parsed.port or (443 if self._secure else 80)
        self._host_header = parsed.netloc

    # --- connection pool (one per thread) ------------------------------
    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self._secure
                   else http.client.HTTPConnection)
            conn = cls(self._host, self._port, timeout=self._timeout_secs)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None

    # --- shared request plumbing ----------------------------------------
    def _key(self, path: str) -> str:
        if path.startswith("/") or ".." in path.split("/"):
            raise StorageError(f"invalid object path: {path!r}")
        return f"{self.prefix}/{path}" if self.prefix else path

    def _sign_headers(self, method: str, resource_path: str,
                      query: list[tuple[str, str]], body: bytes,
                      extra_headers: Optional[dict[str, str]]
                      ) -> dict[str, str]:
        raise NotImplementedError

    def _resource_path(self, key: str) -> str:
        root = self._root_segment
        return "/" + urllib.parse.quote(
            f"{root}/{key}" if key else root, safe="/-_.~")

    def _request(self, method: str, key: str,
                 query: Optional[list[tuple[str, str]]] = None,
                 body: bytes = b"",
                 extra_headers: Optional[dict[str, str]] = None
                 ) -> tuple[int, dict[str, str], bytes]:
        query = query or []
        resource_path = self._resource_path(key)
        last_error: Optional[Exception] = None
        for attempt in range(_MAX_ATTEMPTS):
            headers = self._sign_headers(method, resource_path, query,
                                         body, extra_headers)
            target = resource_path
            if query:
                target += "?" + urllib.parse.urlencode(sorted(query))
            try:
                conn = self._connection()
                conn.request(method, target, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                resp_headers = {k.lower(): v for k, v in resp.getheaders()}
            except (OSError, http.client.HTTPException,
                    socket.timeout) as exc:
                self._drop_connection()
                last_error = exc
                time.sleep(0.05 * (2 ** attempt))
                continue
            if status in _RETRYABLE_STATUS:
                last_error = StorageError(
                    f"{self.service_name} {method} {key}: HTTP {status}",
                    kind="internal")
                time.sleep(0.05 * (2 ** attempt))
                continue
            return status, resp_headers, data
        raise StorageError(
            f"{self.service_name} {method} {key} failed after "
            f"{_MAX_ATTEMPTS} attempts: {last_error}",
            kind="timeout" if isinstance(last_error, socket.timeout)
            else "internal")

    def _check(self, status: int, data: bytes, op: str, path: str) -> None:
        if status == 404:
            raise StorageError(f"not found: {path}", kind="not_found")
        if status in (401, 403):
            raise StorageError(
                f"{self.service_name} {op} {path}: HTTP {status}",
                kind="unauthorized")
        if status >= 300:
            raise StorageError(
                f"{self.service_name} {op} {path}: HTTP {status}: "
                f"{data[:200]!r}")

    # --- shared Storage operations ---------------------------------------
    def delete(self, path: str) -> None:
        status, _, data = self._request("DELETE", self._key(path))
        # object DELETEs are idempotent server-side: a 404 means a racing
        # GC already won, but the reference surfaces not_found for single
        # deletes
        if status == 404:
            raise StorageError(f"not found: {path}", kind="not_found")
        self._check(status, data, "DELETE", path)

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        if start >= end:
            return b""
        status, _, data = self._request(
            "GET", self._key(path),
            extra_headers={"range": f"bytes={start}-{end - 1}"})
        if status == 416:
            raise StorageError(
                f"range {start}:{end} out of bounds for {path}")
        self._check(status, data, "GET", path)
        if status == 200 and (start > 0 or len(data) > end - start):
            # 200 (not 206) means the server ignored the Range header and
            # returned the full object; slice host-side
            return data[start:end]
        return data

    def get_all(self, path: str) -> bytes:
        status, _, data = self._request("GET", self._key(path))
        self._check(status, data, "GET", path)
        return data

    def file_num_bytes(self, path: str) -> int:
        status, headers, data = self._request("HEAD", self._key(path))
        self._check(status, data, "HEAD", path)
        return int(headers.get("content-length", 0))
