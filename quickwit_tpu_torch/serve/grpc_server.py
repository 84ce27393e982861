"""gRPC services over the stdlib HTTP/2 transport (`http2.py`).

Roles of the reference's tonic surfaces:
- OTLP gRPC ingest (`quickwit-opentelemetry/src/otlp/{traces,logs}.rs`):
  TraceService/LogsService Export with binary protobuf request decoding
  (the schema-driven decoder in `otlp_proto.py`).
- Jaeger gRPC SpanReaderPlugin (`quickwit-jaeger/src/lib.rs:78`):
  GetServices / GetOperations / FindTraceIDs / FindTraces / GetTrace
  translating to searches on the otel indexes, spans re-encoded as
  jaeger.api_v2 protobuf messages.

gRPC wire mechanics implemented here: the 5-byte message frame
(compressed flag + u32 length), `application/grpc` content type,
`grpc-status`/`grpc-message` trailers, unary and server-streaming
responses. `GrpcChannel` is the matching minimal client (tests, tools).

Counterpart of the JAX package's `serve/grpc_server.py`, on the same wire:
a JAX node and a port node reach each other's `LeafSearch`, `FetchDocs`
and `Replicate` routes. The leaf work behind `LeafSearch` runs on the
node's device (`NodeConfig.device`).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Callable, Iterable, Optional

from ..common.deadline import DeadlineExceeded
from ..tenancy.overload import OverloadShed
from ..tenancy.registry import TenantRateLimited
from .http2 import (
    FLAG_ACK, FLAG_END_HEADERS, FLAG_END_STREAM, FRAME_DATA, FRAME_HEADERS,
    FRAME_PING, FRAME_SETTINGS, FRAME_WINDOW_UPDATE, Http2Server, HpackDecoder,
    PREFACE, frame, hpack_encode_raw, read_exact_from, read_frame,
)

GRPC_OK = 0
GRPC_UNKNOWN = 2
GRPC_DEADLINE_EXCEEDED = 4
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_UNIMPLEMENTED = 12


class GrpcError(RuntimeError):
    def __init__(self, message: str, status: int = GRPC_UNKNOWN):
        super().__init__(message)
        self.status = status


# --- protobuf encoding helpers ----------------------------------------------


def pb_varint_raw(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_varint(field: int, value: int) -> bytes:
    if not value:
        return b""
    return pb_varint_raw(field << 3) + pb_varint_raw(value)


def pb_bytes(field: int, data: bytes) -> bytes:
    if not data:
        return b""
    return pb_varint_raw(field << 3 | 2) + pb_varint_raw(len(data)) + data


def pb_str(field: int, text: str) -> bytes:
    return pb_bytes(field, text.encode())


def pb_msg(field: int, encoded: bytes) -> bytes:
    # messages keep explicit presence even when empty
    return pb_varint_raw(field << 3 | 2) + pb_varint_raw(len(encoded)) + encoded


def _pb_timestamp(micros: int) -> bytes:
    return (pb_varint(1, micros // 1_000_000)
            + pb_varint(2, (micros % 1_000_000) * 1000))


def _pb_duration(micros: int) -> bytes:
    return _pb_timestamp(micros)  # same seconds/nanos shape


def _pb_keyvalue(key: str, value: Any) -> bytes:
    # jaeger.api_v2 KeyValue: key=1, v_type=2, v_str=3, v_bool=4
    # ValueType: STRING=0, BOOL=1, INT64=2
    if isinstance(value, bool):
        return pb_str(1, key) + pb_varint(2, 1) + pb_varint(4, 1 if value else 0)
    return pb_str(1, key) + pb_str(3, str(value))


def _hex_bytes(hex_id: str) -> bytes:
    text = hex_id or ""
    if len(text) % 2:
        text = "0" + text
    try:
        return bytes.fromhex(text)
    except ValueError:
        return text.encode()


def encode_jaeger_span(doc: dict[str, Any]) -> bytes:
    """One span doc → jaeger.api_v2.Span protobuf bytes."""
    start_micros = int(float(doc.get("span_start_timestamp", 0)) * 1_000_000)
    out = bytearray()
    out += pb_bytes(1, _hex_bytes(doc.get("trace_id", "")))
    out += pb_bytes(2, _hex_bytes(doc.get("span_id", "")))
    out += pb_str(3, doc.get("span_name", ""))
    parent = doc.get("parent_span_id")
    if parent:
        ref = (pb_bytes(1, _hex_bytes(doc.get("trace_id", "")))
               + pb_bytes(2, _hex_bytes(parent)))  # ref_type CHILD_OF = 0
        out += pb_msg(4, ref)
    out += pb_msg(6, _pb_timestamp(start_micros))
    out += pb_msg(7, _pb_duration(int(doc.get("span_duration_micros", 0))))
    for key, value in (doc.get("attributes") or {}).items():
        out += pb_msg(8, _pb_keyvalue(key, value))
    if doc.get("span_status") == "error":
        out += pb_msg(8, _pb_keyvalue("error", True))
    process = pb_str(1, doc.get("service_name", "unknown_service"))
    out += pb_msg(10, process)
    return bytes(out)


# --- request decoding (shares otlp_proto's field iterator) ------------------


def _fields(payload: bytes):
    from .otlp_proto import iter_fields
    return iter_fields(memoryview(payload))


def _decode_trace_query(payload: bytes) -> dict[str, Any]:
    """FindTracesRequest/FindTraceIDsRequest → query dict. The
    TraceQueryParameters message rides at field 1."""
    query: dict[str, Any] = {}
    for field, wire, value in _fields(payload):
        if field == 1 and wire == 2:
            for f2, w2, v2 in _fields(bytes(value)):
                if f2 == 1 and w2 == 2:
                    query["service"] = bytes(v2).decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    query["operation"] = bytes(v2).decode("utf-8", "replace")
                elif f2 == 3 and w2 == 2:
                    # map<string,string> tags: repeated entries {key=1, value=2}
                    key = text = ""
                    for f3, w3, v3 in _fields(bytes(v2)):
                        if f3 == 1 and w3 == 2:
                            key = bytes(v3).decode("utf-8", "replace")
                        elif f3 == 2 and w3 == 2:
                            text = bytes(v3).decode("utf-8", "replace")
                    if key:
                        query.setdefault("tags", {})[key] = text
                elif f2 == 4 and w2 == 2:
                    query["start_min"] = _decode_timestamp_s(bytes(v2))
                elif f2 == 5 and w2 == 2:
                    query["start_max"] = _decode_timestamp_s(bytes(v2))
                elif f2 == 6 and w2 == 2:
                    query["duration_min_micros"] = \
                        _decode_duration_micros(bytes(v2))
                elif f2 == 7 and w2 == 2:
                    query["duration_max_micros"] = \
                        _decode_duration_micros(bytes(v2))
                elif f2 == 8 and w2 == 0:
                    query["num_traces"] = int(v2)
    return query


def _decode_timestamp_s(payload: bytes) -> int:
    seconds = 0
    for field, wire, value in _fields(payload):
        if field == 1 and wire == 0:
            seconds = int(value)
    return seconds


def _decode_duration_micros(payload: bytes) -> int:
    seconds = nanos = 0
    for field, wire, value in _fields(payload):
        if field == 1 and wire == 0:
            seconds = int(value)
        elif field == 2 and wire == 0:
            nanos = int(value)
    return seconds * 1_000_000 + nanos // 1000


# --- the server --------------------------------------------------------------


class GrpcServer:
    """gRPC endpoint for one node: OTLP collector services + the Jaeger
    span reader, mounted on the stdlib HTTP/2 server."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self.node = node
        self._handlers: dict[str, Callable[[bytes], Iterable[bytes]]] = {
            "/opentelemetry.proto.collector.trace.v1.TraceService/Export":
                self._export_traces,
            "/opentelemetry.proto.collector.logs.v1.LogsService/Export":
                self._export_logs,
            "/jaeger.storage.v1.SpanReaderPlugin/GetServices":
                self._get_services,
            "/jaeger.storage.v1.SpanReaderPlugin/GetOperations":
                self._get_operations,
            "/jaeger.storage.v1.SpanReaderPlugin/FindTraceIDs":
                self._find_trace_ids,
            "/jaeger.storage.v1.SpanReaderPlugin/FindTraces":
                self._find_traces,
            "/jaeger.storage.v1.SpanReaderPlugin/GetTrace":
                self._get_trace,
            # internal search fan-out (reference search.proto:19
            # SearchService; payloads ride binwire instead of protobuf —
            # the numpy agg states go over as dtype+shape+raw bytes, the
            # role of the reference's postcard intermediate-agg bytes)
            "/quickwit.search.SearchService/LeafSearch":
                self._leaf_search,
            "/quickwit.search.SearchService/FetchDocs":
                self._fetch_docs,
            "/quickwit.search.SearchService/Replicate":
                self._replicate,
        }
        self._http2 = Http2Server(self._handle, host=host, port=port,
                                  ssl_context=ssl_context)
        self.host, self.port = self._http2.host, self._http2.port

    def stop(self) -> None:
        self._http2.stop()

    # -- transport glue
    def _handle(self, headers, body):
        header_map = dict(headers)
        path = header_map.get(":path", "")
        handler = self._handlers.get(path)
        response_headers = [(":status", "200"),
                            ("content-type", "application/grpc")]
        if handler is None:
            return (response_headers, [],
                    [("grpc-status", str(GRPC_UNIMPLEMENTED)),
                     ("grpc-message", f"unknown method {path}")])
        from ..observability.tracing import TRACER
        try:
            # every RPC is a server span joined to the caller's W3C trace
            # (the role of tonic's tracing interceptor)
            with TRACER.span("grpc.request", {"rpc.method": path},
                             remote_parent=header_map.get("traceparent", ""),
                             scope=self.node.config.node_id):
                messages = list(handler(_grpc_unframe(body)))
        except GrpcError as exc:
            return (response_headers, [],
                    [("grpc-status", str(exc.status)),
                     ("grpc-message", str(exc))])
        except DeadlineExceeded as exc:
            # str(exc) embeds the deadline mark, so the remote root's
            # is_deadline_error() classifier still recognizes the failure
            return (response_headers, [],
                    [("grpc-status", str(GRPC_DEADLINE_EXCEEDED)),
                     ("grpc-message", str(exc))])
        except (OverloadShed, TenantRateLimited) as exc:
            return (response_headers, [],
                    [("grpc-status", str(GRPC_RESOURCE_EXHAUSTED)),
                     ("grpc-message", f"{type(exc).__name__}: {exc}")])
        except Exception as exc:  # noqa: BLE001 - status trailer, not a 500
            return (response_headers, [],
                    [("grpc-status", str(GRPC_UNKNOWN)),
                     ("grpc-message", f"{type(exc).__name__}: {exc}")])
        chunks = [_grpc_frame(m) for m in messages]
        return response_headers, chunks, [("grpc-status", "0")]

    # -- internal SearchService (binwire payloads)
    def _leaf_search(self, payload: bytes):
        from ..search.models import LeafSearchRequest
        from .binwire import decode, encode
        from .serializers import leaf_response_to_wire
        request = LeafSearchRequest.from_dict(decode(payload))
        response = self.node.search_service.leaf_search(request)
        yield encode(leaf_response_to_wire(response))

    def _fetch_docs(self, payload: bytes):
        from ..search.models import FetchDocsRequest
        from .binwire import decode, encode
        request = FetchDocsRequest.from_dict(decode(payload))
        yield encode(self.node.search_service.fetch_docs(request))

    def _replicate(self, payload: bytes):
        from ..ingest.ingester import ReplicationGap
        from .binwire import decode, encode
        request = decode(payload)
        if request.get("reset"):
            self.node.ingester.replica_reset(
                request["index_uid"], request["source_id"],
                request["shard_id"], int(request["first_position"]))
        try:
            last = self.node.ingester.replica_persist(
                request["index_uid"], request["source_id"],
                request["shard_id"], int(request["first_position"]),
                list(request["payloads"]))
        except ReplicationGap as gap:
            yield encode({"gap": True, "replica_position": gap.have})
            return
        yield encode({"replica_position": last})

    # -- OTLP collector services
    def _export_traces(self, payload: bytes):
        from .otlp_proto import decode_traces_request
        self.node.otel.ingest_traces(decode_traces_request(payload))
        yield b""  # ExportTraceServiceResponse{}

    def _export_logs(self, payload: bytes):
        from .otlp_proto import decode_logs_request
        self.node.otel.ingest_logs(decode_logs_request(payload))
        yield b""  # ExportLogsServiceResponse{}

    # -- Jaeger SpanReaderPlugin
    def _get_services(self, payload: bytes):
        out = bytearray()
        for service in self.node.otel.services():
            out += pb_str(1, service)
        yield bytes(out)

    def _get_operations(self, payload: bytes):
        service = ""
        for field, wire, value in _fields(payload):
            if field == 1 and wire == 2:
                service = bytes(value).decode("utf-8", "replace")
        out = bytearray()
        for name in self.node.otel.operations(service):
            out += pb_str(1, name)                      # operationNames
            out += pb_msg(2, pb_str(1, name))           # Operation{name}
        yield bytes(out)

    @staticmethod
    def _trace_query_kwargs(query: dict[str, Any]) -> dict[str, Any]:
        return dict(
            service=query.get("service"), operation=query.get("operation"),
            min_duration_micros=query.get("duration_min_micros"),
            max_duration_micros=query.get("duration_max_micros"),
            tags=query.get("tags"),
            start_timestamp=query.get("start_min"),
            end_timestamp=query.get("start_max"),
            limit=query.get("num_traces", 20))

    def _find_trace_ids(self, payload: bytes):
        query = _decode_trace_query(payload)
        trace_ids = self.node.otel.find_traces(
            **self._trace_query_kwargs(query))
        out = bytearray()
        for trace_id in trace_ids:
            out += pb_bytes(1, _hex_bytes(trace_id))
        yield bytes(out)

    def _find_traces(self, payload: bytes):
        query = _decode_trace_query(payload)
        traces = self.node.otel.find_traces_with_spans(
            **self._trace_query_kwargs(query))
        # server-streaming: one SpansResponseChunk per trace
        for _trace_id, docs in traces:
            chunk = bytearray()
            for doc in docs:
                chunk += pb_msg(1, encode_jaeger_span(doc))
            yield bytes(chunk)

    def _get_trace(self, payload: bytes):
        trace_id = ""
        for field, wire, value in _fields(payload):
            if field == 1 and wire == 2:
                trace_id = bytes(value).hex()
        docs = self.node.otel.get_trace(trace_id)
        if not docs:
            raise GrpcError(f"trace {trace_id!r} not found", status=5)
        chunk = bytearray()
        for doc in docs:
            chunk += pb_msg(1, encode_jaeger_span(doc))
        yield bytes(chunk)


def _grpc_frame(message: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(message)) + message


def _grpc_unframe(body: bytes) -> bytes:
    """First (unary) request message of a gRPC body."""
    if not body:
        return b""
    if body[0] != 0:
        raise GrpcError("compressed gRPC messages are not supported")
    length = struct.unpack(">I", body[1:5])[0]
    return body[5: 5 + length]


# --- minimal client (tests / tooling) ----------------------------------------


class GrpcChannel:
    """Blocking h2c gRPC client: one request per call over a persistent
    connection (raw-literal HPACK — no Huffman, by design)."""

    def __init__(self, host: str, port: int, timeout: float = 15.0,
                 ssl_context=None):
        self._timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._scheme = "http"
        if ssl_context is not None:
            # gRPC-over-TLS — the secure cluster's binary plane; ALPN is
            # configured by whoever built the context (GrpcSearchClient);
            # server identity checked per the context's settings
            self._sock = ssl_context.wrap_socket(
                self._sock,
                server_hostname=host if ssl_context.check_hostname else None)
            self._scheme = "https"
        self._sock.sendall(
            PREFACE + frame(FRAME_SETTINGS, 0, 0, b""))
        self._decoder = HpackDecoder()
        self._stream_id = 1
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        return read_exact_from(self._sock, n)

    def call(self, path: str, message: bytes,
             extra_headers: "tuple[tuple[str, str], ...]" = (),
             timeout_secs: Optional[float] = None
             ) -> tuple[list[bytes], int, str]:
        """(response messages, grpc-status, grpc-message).

        `timeout_secs` clamps THIS call to the caller's remaining deadline
        budget (never above the channel default): the budget covers the
        whole stream, so the socket timeout is re-armed with the remaining
        time before every frame read — N slow frames cannot each burn a
        full per-frame timeout. The shared socket's default timeout is
        restored afterwards (calls are serialized by the channel lock)."""
        budget = self._timeout if timeout_secs is None \
            else min(self._timeout, max(timeout_secs, 0.001))
        with self._lock:
            deadline = time.monotonic() + budget
            stream_id = self._stream_id
            self._stream_id += 2
            headers = [(":method", "POST"), (":scheme", self._scheme),
                       (":path", path), (":authority", "localhost"),
                       ("content-type", "application/grpc"), ("te", "trailers")]
            headers.extend(extra_headers)
            out = frame(FRAME_HEADERS, FLAG_END_HEADERS, stream_id,
                        hpack_encode_raw(headers))
            out += frame(FRAME_DATA, FLAG_END_STREAM, stream_id,
                         _grpc_frame(message))
            try:
                self._sock.settimeout(min(budget, self._timeout))
                self._sock.sendall(out)
                data, status, status_message = self._read_stream(
                    stream_id, deadline, path)
            finally:
                try:
                    self._sock.settimeout(self._timeout)
                except OSError:
                    pass  # socket already dead; the caller sees the error
            messages = []
            pos = 0
            while pos + 5 <= len(data):
                length = struct.unpack(">I", data[pos + 1: pos + 5])[0]
                messages.append(bytes(data[pos + 5: pos + 5 + length]))
                pos += 5 + length
            return messages, status, status_message

    def _read_stream(self, stream_id: int, deadline: float, path: str
                     ) -> tuple[bytearray, int, str]:
        data = bytearray()
        status, status_message = -1, ""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    f"grpc call {path} exceeded its deadline budget")
            self._sock.settimeout(remaining)
            frame_type, flags, fid, payload = read_frame(self._read_exact)
            if frame_type == FRAME_SETTINGS:
                if not flags & FLAG_ACK:
                    self._sock.sendall(
                        frame(FRAME_SETTINGS, FLAG_ACK, 0, b""))
                continue
            if frame_type == FRAME_PING and not flags & FLAG_ACK:
                self._sock.sendall(
                    frame(FRAME_PING, FLAG_ACK, 0, payload))
                continue
            if frame_type == FRAME_WINDOW_UPDATE or fid != stream_id:
                continue
            if frame_type == FRAME_HEADERS:
                for name, value in self._decoder.decode(payload):
                    if name == "grpc-status":
                        status = int(value)
                    elif name == "grpc-message":
                        status_message = value
            elif frame_type == FRAME_DATA:
                data += payload
                if payload:
                    import struct as _struct
                    increment = _struct.pack(">I", len(payload))
                    self._sock.sendall(
                        frame(FRAME_WINDOW_UPDATE, 0, 0, increment)
                        + frame(FRAME_WINDOW_UPDATE, 0, stream_id,
                                increment))
            if flags & FLAG_END_STREAM:
                return data, status, status_message


class GrpcSearchClient:
    """Cross-node search client over the gRPC stack — the role of the
    reference's codegen'd SearchService gRPC client (`search.proto:19`,
    `quickwit-codegen/src/codegen.rs:12-45`). leaf_search / fetch_docs /
    replicate ride gRPC framing with binwire payloads on one persistent
    HTTP/2 connection; everything else (heartbeat, cluster KV `_post`
    surface) delegates to the JSON/HTTP client, which also owns the
    shared circuit breaker."""

    def __init__(self, grpc_endpoint: str, rest_endpoint: str,
                 timeout_secs: float = 30.0, **http_kwargs):
        from .http_client import HttpSearchClient, client_ssl_context
        self.endpoint = rest_endpoint
        self.grpc_endpoint = grpc_endpoint
        host, port = grpc_endpoint.rsplit(":", 1)
        self._grpc_host, self._grpc_port = host, int(port)
        self.timeout_secs = timeout_secs
        self.http = HttpSearchClient(rest_endpoint,
                                     timeout_secs=timeout_secs, **http_kwargs)
        self.circuit = self.http.circuit
        # a TLS cluster runs its gRPC plane over TLS too (same CA / mTLS
        # settings as the REST client), with h2 ALPN baked in at
        # construction — no per-reconnect context mutation
        self._channel_ssl = client_ssl_context(alpn=["h2"], **http_kwargs)
        self._channel: "GrpcChannel | None" = None
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._channel_lock = threading.Lock()

    def close(self) -> None:
        with self._channel_lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None

    def _call(self, path: str, payload: bytes,
              timeout_secs: Optional[float] = None) -> bytes:
        from .http_client import HttpStatusError, HttpTransportError

        def once() -> bytes:
            with self._channel_lock:
                if self._channel is None:
                    self._channel = GrpcChannel(
                        self._grpc_host, self._grpc_port,
                        timeout=self.timeout_secs,
                        ssl_context=self._channel_ssl)
                channel = self._channel
            from ..observability.tracing import TRACER
            from .http2 import Http2Error
            traceparent = TRACER.current_traceparent()
            extra = (("traceparent", traceparent),) if traceparent else ()
            try:
                messages, status, message = channel.call(
                    path, payload, extra_headers=extra,
                    timeout_secs=timeout_secs)
            except (OSError, Http2Error) as exc:
                # connection-level failure: drop the channel so the next
                # call reconnects; counts toward the breaker
                with self._channel_lock:
                    if self._channel is channel:
                        self._channel = None
                channel.close()
                raise HttpTransportError(
                    f"grpc {self.grpc_endpoint}{path}: {exc}") from exc
            if status != 0:
                # translate gRPC status into the HTTP status the root's
                # failure handling keys on: RESOURCE_EXHAUSTED is remote
                # backpressure (429 -> failed-node retry path, see
                # search/root.py), DEADLINE_EXCEEDED is a timeout (504);
                # the message carries the deadline mark for
                # is_deadline_error(). Anything else stays a generic 500.
                http_status = {GRPC_RESOURCE_EXHAUSTED: 429,
                               GRPC_DEADLINE_EXCEEDED: 504}.get(status, 500)
                raise HttpStatusError(
                    f"grpc {self.grpc_endpoint}{path} -> status {status}: "
                    f"{message}", status=http_status)
            return messages[0] if messages else b""

        return self.circuit.call(once)

    # -- gRPC-backed methods
    def leaf_search(self, request):
        from .binwire import decode, encode
        from .serializers import leaf_response_from_wire
        # clamp the call to the query's remaining deadline budget (plus
        # grace for trailers), mirroring HttpSearchClient.leaf_search —
        # a 2s-deadline query must not hold the shared channel for the
        # full 30s default
        timeout_secs = None
        if getattr(request, "deadline_millis", None) is not None:
            timeout_secs = request.deadline_millis / 1000.0 + 0.5
        raw = self._call("/quickwit.search.SearchService/LeafSearch",
                         encode(request.to_dict()),
                         timeout_secs=timeout_secs)
        return leaf_response_from_wire(decode(raw))

    def fetch_docs(self, request):
        from .binwire import decode, encode
        raw = self._call("/quickwit.search.SearchService/FetchDocs",
                         encode(request.to_dict()))
        return decode(raw)

    def replicate(self, payload):
        """Chained-replication append; WAL records ride as raw bytes (the
        JSON path base64-encodes them)."""
        import base64
        from .binwire import decode, encode
        wire = dict(payload)
        if "payloads" in wire:
            wire["payloads"] = [base64.b64decode(p) if isinstance(p, str)
                                else bytes(p) for p in wire["payloads"]]
        raw = self._call("/quickwit.search.SearchService/Replicate",
                         encode(wire))
        response = decode(raw)
        if response.get("gap"):
            # mirror the HTTP 409 contract the ingester's caller expects
            from .http_client import HttpStatusError
            import json as _json
            raise HttpStatusError(
                f"grpc replicate gap at {response['replica_position']}",
                status=409, body=_json.dumps(response).encode())
        return response

    # -- JSON/HTTP delegation (heartbeat, KV, truncate, ...)
    def heartbeat(self, payload):
        return self.http.heartbeat(payload)

    def _post(self, path: str, payload):
        return self.http._post(path, payload)
