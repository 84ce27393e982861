"""HTTP search client — the cross-node transport.

Role of the reference's codegen'd gRPC SearchService client with tower
retry/timeout layers: same `SearchClient` surface as LocalSearchClient, over
the peer's `/internal/*` endpoints using stdlib http.client (zero-dep).
"""

from __future__ import annotations

import http.client
import json
import ssl
from typing import Any, Optional

from ..common.tower import CircuitBreaker, CircuitOpen
from ..search.models import FetchDocsRequest, LeafSearchRequest, LeafSearchResponse
from .serializers import leaf_response_from_dict


class HttpTransportError(ConnectionError):
    """Connection-level failure (peer unreachable/timeout) — counts toward
    the circuit breaker."""


class HttpStatusError(HttpTransportError):
    """Peer answered with a non-200 — an application error, NOT evidence the
    peer is dead; does not open the circuit."""

    def __init__(self, message: str, status: int = 0, body: bytes = b""):
        super().__init__(message)
        self.status = status
        self.body = body


def client_ssl_context(tls: bool = False, ca_path: Optional[str] = None,
                       skip_verify: bool = False,
                       client_cert_path: Optional[str] = None,
                       client_key_path: Optional[str] = None,
                       alpn: Optional[list[str]] = None
                       ) -> Optional[ssl.SSLContext]:
    """Peer-facing TLS context (role of quickwit-transport's rustls client
    side), shared by the JSON/HTTP client and the gRPC channel: `ca_path`
    pins the cluster CA for self-signed deployments; `skip_verify` is for
    tests only; a client cert is the mTLS identity toward verify-client
    peers; `alpn` is set here (ONE construction path) so callers never
    mutate a context they share."""
    if not tls:
        return None
    if skip_verify:
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        context.check_hostname = False
        context.verify_mode = ssl.CERT_NONE
    else:
        context = ssl.create_default_context(cafile=ca_path)
    if client_cert_path:
        context.load_cert_chain(client_cert_path, client_key_path)
    if alpn:
        try:
            context.set_alpn_protocols(alpn)
        except NotImplementedError:
            pass
    return context


class HttpSearchClient:
    def __init__(self, endpoint: str, timeout_secs: float = 30.0,
                 tls: bool = False, ca_path: Optional[str] = None,
                 skip_verify: bool = False,
                 client_cert_path: Optional[str] = None,
                 client_key_path: Optional[str] = None):
        self.endpoint = endpoint  # "host:port"
        host, port = endpoint.rsplit(":", 1)
        self.host = host
        self.port = int(port)
        self.timeout_secs = timeout_secs
        self._ssl_context = client_ssl_context(
            tls, ca_path, skip_verify, client_cert_path, client_key_path)
        # stop hammering a dead peer; root search fails fast to its retry
        # path instead of stacking timeouts (reference tower circuit breaker)
        self.circuit = CircuitBreaker(
            failure_threshold=3, cooldown_secs=5.0,
            counts_as_failure=lambda exc: not isinstance(exc, HttpStatusError))

    def _post(self, path: str, payload: Any,
              timeout_secs: Optional[float] = None) -> Any:
        return self.circuit.call(
            lambda: self._post_once(path, payload, timeout_secs))

    def _post_once(self, path: str, payload: Any,
                   timeout_secs: Optional[float] = None) -> Any:
        timeout = (self.timeout_secs if timeout_secs is None
                   else min(self.timeout_secs, timeout_secs))
        if self._ssl_context is not None:
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                self.host, self.port, timeout=timeout,
                context=self._ssl_context)
        else:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout)
        try:
            data = json.dumps(payload).encode()
            headers = {"Content-Type": "application/json"}
            # propagate the active trace across the root->leaf hop
            # (reference: tracing_utils.rs inject_current_context)
            from ..observability.tracing import TRACER
            traceparent = TRACER.current_traceparent()
            if traceparent:
                headers["traceparent"] = traceparent
            conn.request("POST", path, body=data, headers=headers)
            response = conn.getresponse()
            body = response.read()
            if response.status != 200:
                raise HttpStatusError(
                    f"{self.endpoint}{path} -> {response.status}: {body[:200]!r}",
                    status=response.status, body=body)
            return json.loads(body)
        except HttpStatusError:
            raise  # ConnectionError subclass: must not be re-wrapped below
        except (OSError, http.client.HTTPException) as exc:
            raise HttpTransportError(f"{self.endpoint}{path}: {exc}") from exc
        finally:
            conn.close()

    def leaf_search(self, request: LeafSearchRequest) -> LeafSearchResponse:
        # socket timeout tracks the request's remaining budget (plus slack
        # for the leaf to serialize its partial response) instead of the
        # fixed per-connection default — a deadline-bound request must not
        # wait out a 30s socket timeout
        timeout_secs = None
        if request.deadline_millis is not None:
            timeout_secs = request.deadline_millis / 1000.0 + 0.5
        return leaf_response_from_dict(
            self._post("/internal/leaf_search", request.to_dict(),
                       timeout_secs=timeout_secs))

    def fetch_docs(self, request: FetchDocsRequest) -> list[dict[str, Any]]:
        return self._post("/internal/fetch_docs", request.to_dict())

    def heartbeat(self, payload: dict[str, Any]) -> dict[str, Any]:
        return self._post("/internal/heartbeat", payload)

    def replicate(self, payload: dict[str, Any]) -> dict[str, Any]:
        """Chained-replication append on the follower (ingest v2)."""
        return self._post("/internal/replicate", payload)
