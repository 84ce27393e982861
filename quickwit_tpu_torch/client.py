"""Public client for a quickwit_tpu cluster.

Role of the reference's `quickwit-rest-client` (`src/rest_client.rs:1`):
a typed client over the REST API for applications and tooling (the CLI
and integration tests use the same surface). Stdlib-only, persistent
connection, explicit errors, optional TLS with CA pinning.

    from quickwit_tpu.client import QuickwitClient

    qw = QuickwitClient("127.0.0.1:7280")
    qw.create_index({"index_id": "logs", "doc_mapping": {...}})
    qw.ingest("logs", [{"ts": 1, "body": "hello"}], commit="force")
    result = qw.search("logs", query="body:hello", max_hits=10)
    es = qw.es_search("logs", {"query": {"match": {"body": "hello"}}})
"""

from __future__ import annotations

import json
import ssl as ssl_mod
from http.client import HTTPConnection, HTTPSConnection
from typing import Any, Iterable, Optional
from urllib.parse import quote, urlencode


class QuickwitError(RuntimeError):
    """Non-2xx response; carries the HTTP status and decoded body."""

    def __init__(self, status: int, body: Any):
        if isinstance(body, dict):
            message = body.get("message") or body.get("error") or body
        else:
            message = body
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.body = body


class QuickwitClient:
    def __init__(self, endpoint: str, timeout_secs: float = 30.0,
                 tls: bool = False, ca_path: Optional[str] = None,
                 skip_verify: bool = False):
        host, _, port = endpoint.rpartition(":")
        self.host = host or endpoint
        self.port = int(port) if port else (443 if tls else 7280)
        self.timeout_secs = timeout_secs
        self._context: Optional[ssl_mod.SSLContext] = None
        if tls:
            if skip_verify:
                self._context = ssl_mod.SSLContext(
                    ssl_mod.PROTOCOL_TLS_CLIENT)
                self._context.check_hostname = False
                self._context.verify_mode = ssl_mod.CERT_NONE
            else:
                self._context = ssl_mod.create_default_context(
                    cafile=ca_path)
        self._conn: Optional[HTTPConnection] = None

    # --- transport --------------------------------------------------------
    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _connection(self) -> HTTPConnection:
        if self._conn is None:
            if self._context is not None:
                self._conn = HTTPSConnection(
                    self.host, self.port, timeout=self.timeout_secs,
                    context=self._context)
            else:
                self._conn = HTTPConnection(self.host, self.port,
                                            timeout=self.timeout_secs)
        return self._conn

    def request(self, method: str, path: str, body: Any = None,
                raw: Optional[bytes] = None,
                content_type: str = "application/json") -> Any:
        payload = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        idempotent = method in ("GET", "HEAD", "DELETE")
        for attempt in (1, 2):  # one re-dial on a dead kept-alive conn
            conn = self._connection()
            sent = False
            try:
                conn.request(method, path, body=payload,
                             headers={"Content-Type": content_type})
                sent = True
                response = conn.getresponse()
                data = response.read()
                break
            except (OSError, ConnectionError):
                self.close()
                # once a non-idempotent request was TRANSMITTED, a retry
                # could duplicate its effect (e.g. re-ingest a batch the
                # server committed before the connection dropped)
                if attempt == 2 or (sent and not idempotent):
                    raise
        decoded = json.loads(data) if data else None
        if response.status >= 300:
            raise QuickwitError(response.status, decoded)
        return decoded

    # --- index management --------------------------------------------------
    def create_index(self, index_config: dict) -> dict:
        return self.request("POST", "/api/v1/indexes", index_config)

    def update_index(self, index_id: str, update: dict) -> dict:
        """Live config update: search_settings, retention,
        indexing_settings, append-only doc_mapping additions."""
        return self.request(
            "PUT", f"/api/v1/indexes/{quote(index_id)}", update)

    def delete_index(self, index_id: str) -> dict:
        return self.request("DELETE", f"/api/v1/indexes/{quote(index_id)}")

    def list_indexes(self) -> list:
        return self.request("GET", "/api/v1/indexes")

    def list_splits(self, index_id: str) -> list:
        return self.request(
            "GET", f"/api/v1/indexes/{quote(index_id)}/splits")["splits"]

    # --- sources -----------------------------------------------------------
    def create_source(self, index_id: str, source_config: dict) -> dict:
        return self.request(
            "POST", f"/api/v1/indexes/{quote(index_id)}/sources",
            source_config)

    def delete_source(self, index_id: str, source_id: str) -> dict:
        return self.request(
            "DELETE", f"/api/v1/indexes/{quote(index_id)}/sources/"
                      f"{quote(source_id)}")

    # --- ingest ------------------------------------------------------------
    def ingest(self, index_id: str, docs: Iterable[dict],
               commit: str = "auto") -> dict:
        ndjson = "\n".join(json.dumps(d) for d in docs).encode()
        return self.request(
            "POST", f"/api/v1/{quote(index_id)}/ingest?commit={commit}",
            raw=ndjson, content_type="application/x-ndjson")

    # --- search ------------------------------------------------------------
    def search(self, index_id: str, query: str = "*", max_hits: int = 20,
               start_offset: int = 0, sort_by: Optional[str] = None,
               start_timestamp: Optional[int] = None,
               end_timestamp: Optional[int] = None,
               aggs: Optional[dict] = None) -> dict:
        """The native search API (query-string syntax)."""
        body: dict[str, Any] = {"query": query, "max_hits": max_hits,
                                "start_offset": start_offset}
        if sort_by is not None:
            body["sort_by"] = sort_by
        if start_timestamp is not None:
            body["start_timestamp"] = start_timestamp
        if end_timestamp is not None:
            body["end_timestamp"] = end_timestamp
        if aggs:
            body["aggs"] = aggs
        return self.request(
            "POST", f"/api/v1/{quote(index_id)}/search", body)

    def es_search(self, index_id: str, body: dict) -> dict:
        """The Elasticsearch-compatible `_search` API."""
        return self.request(
            "POST", f"/api/v1/_elastic/{quote(index_id)}/_search", body)

    def scroll(self, index_id: str, query: str = "*", max_hits: int = 20,
               scroll: str = "1m"):
        """Iterate every page of a scrolled search."""
        params = urlencode({"query": query, "max_hits": max_hits,
                            "scroll": scroll})
        page = self.request(
            "GET", f"/api/v1/{quote(index_id)}/search?{params}")
        while True:
            yield page
            scroll_id = page.get("scroll_id")
            if not scroll_id or not page.get("hits"):
                return
            page = self.request(
                "GET", f"/api/v1/scroll?scroll_id={quote(scroll_id)}")
            if not page.get("hits"):
                return

    def sql(self, query: str) -> dict:
        return self.request("POST", "/api/v1/_sql", {"query": query})

    def create_delete_task(self, index_id: str, es_query: dict) -> dict:
        return self.request(
            "POST", f"/api/v1/{quote(index_id)}/delete-tasks",
            {"query": es_query})

    # --- cluster / ops ------------------------------------------------------
    def cluster(self) -> dict:
        return self.request("GET", "/api/v1/cluster")

    def health(self) -> bool:
        try:
            self.request("GET", "/health/livez")
            return True
        except (QuickwitError, OSError):
            return False
