"""The port's gRPC plane against the JAX package's.

`tests/test_grpc.py`'s cases run against a port node on the CPU: OTLP
collector services and the Jaeger SpanReaderPlugin over the port's HTTP/2
transport, flow control, the deadline clamp, the config key and the
restart with the background services. Then the wire: both packages'
Huffman codes, HPACK blocks and HTTP/2 frames are equal byte for byte
over a fixed header corpus, each decodes the other's, and each package's
channel talks to the other package's server. No grpcio is needed.
"""

import struct

import pytest

from quickwit_tpu_torch.serve import Node, NodeConfig, RestServer
from quickwit_tpu_torch.serve.grpc_server import (
    GrpcChannel, pb_bytes, pb_msg, pb_str, pb_varint, pb_varint_raw,
)
from quickwit_tpu_torch.storage import StorageResolver


def _fixed64(field: int, value: int) -> bytes:
    return pb_varint_raw(field << 3 | 1) + struct.pack("<Q", value)


def _otlp_span(trace_id: str, span_id: str, name: str, start_s: int,
               dur_us: int) -> bytes:
    return (pb_bytes(1, bytes.fromhex(trace_id))
            + pb_bytes(2, bytes.fromhex(span_id))
            + pb_str(5, name)
            + _fixed64(7, start_s * 10**9)
            + _fixed64(8, start_s * 10**9 + dur_us * 1000))


def _export_request(service: str, spans: list[bytes]) -> bytes:
    any_value = pb_str(1, service)
    key_value = pb_str(1, "service.name") + pb_msg(2, any_value)
    resource = pb_msg(1, key_value)
    scope_spans = b"".join(pb_msg(2, s) for s in spans)
    resource_spans = pb_msg(1, resource) + pb_msg(2, scope_spans)
    return pb_msg(1, resource_spans)


TRACE_A = "0102030405060708090a0b0c0d0e0f10"
TRACE_B = "1112131415161718191a1b1c1d1e1f20"


@pytest.fixture(scope="module")
def grpc():
    node = Node(NodeConfig(node_id="grpc-node", rest_port=0, grpc_port=0,
                           metastore_uri="ram:///grpc/ms",
                           default_index_root_uri="ram:///grpc/idx",
                           device="cpu"),
                storage_resolver=StorageResolver.for_test())
    server = RestServer(node, host="127.0.0.1", port=0)
    server.start()
    channel = GrpcChannel("127.0.0.1", node.grpc_server.port)
    # seed the spans every reader test depends on HERE, so each test
    # passes standalone instead of relying on file execution order
    request = _export_request("frontend", [
        _otlp_span(TRACE_A, "0102030405060708", "GET /", 1_700_000_000,
                   5000),
        _otlp_span(TRACE_A, "1102030405060708", "auth", 1_700_000_001,
                   900),
    ]) + _export_request("backend", [
        _otlp_span(TRACE_B, "2102030405060708", "query", 1_700_000_002,
                   15000),
    ])
    export_result = channel.call(
        "/opentelemetry.proto.collector.trace.v1.TraceService/Export",
        request)
    yield node, channel, export_result
    channel.close()
    node.grpc_server.stop()
    server.stop()


def test_otlp_grpc_trace_export(grpc):
    _node, _channel, (messages, status, message) = grpc
    assert status == 0, message
    assert messages == [b""]  # empty ExportTraceServiceResponse


def test_jaeger_grpc_get_services(grpc):
    node, channel, _ = grpc
    messages, status, message = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/GetServices", b"")
    assert status == 0, message
    services = _decode_strings(messages[0], field=1)
    assert sorted(services) == ["backend", "frontend"]


def test_jaeger_grpc_get_operations(grpc):
    node, channel, _ = grpc
    messages, status, _ = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/GetOperations",
        pb_str(1, "frontend"))
    assert status == 0
    names = _decode_strings(messages[0], field=1)
    assert sorted(names) == ["GET /", "auth"]


def test_jaeger_grpc_find_trace_ids(grpc):
    node, channel, _ = grpc
    query = pb_msg(1, pb_str(1, "backend"))
    messages, status, _ = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/FindTraceIDs", query)
    assert status == 0
    ids = _decode_byte_fields(messages[0], field=1)
    assert [i.hex() for i in ids] == [TRACE_B]


def test_jaeger_grpc_find_traces_streams_spans(grpc):
    node, channel, _ = grpc
    query = pb_msg(1, pb_str(1, "frontend"))
    messages, status, _ = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/FindTraces", query)
    assert status == 0
    assert len(messages) == 1  # one chunk per trace
    spans = _decode_byte_fields(messages[0], field=1)
    assert len(spans) == 2
    names = set()
    for span in spans:
        fields = dict(_iter_simple(span))
        assert fields[1] == bytes.fromhex(TRACE_A)
        names.add(fields[3].decode())
    assert names == {"GET /", "auth"}


def test_jaeger_grpc_get_trace_not_found(grpc):
    node, channel, _ = grpc
    messages, status, message = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/GetTrace",
        pb_bytes(1, b"\xde\xad\xbe\xef"))
    assert status == 5  # NOT_FOUND
    assert "not found" in message


def test_unknown_method_unimplemented(grpc):
    node, channel, _ = grpc
    _messages, status, message = channel.call("/no.such.Service/Nope", b"")
    assert status == 12
    assert "unknown method" in message


TRACE_C = "2122232425262728292a2b2c2d2e2f30"


def _tagged_span(trace_id: str, span_id: str, name: str, start_s: int,
                 dur_us: int, attrs: dict, error: bool = False) -> bytes:
    span = _otlp_span(trace_id, span_id, name, start_s, dur_us)
    for key, value in attrs.items():
        key_value = pb_str(1, key) + pb_msg(2, pb_str(1, str(value)))
        span += pb_msg(9, key_value)
    if error:
        span += pb_msg(15, pb_varint(3, 2))  # Status{code: ERROR}
    return span


def test_jaeger_grpc_find_traces_tag_and_duration_max_filters(grpc):
    node, channel, _ = grpc
    request = _export_request("tagged", [
        _tagged_span(TRACE_C, "3102030405060708", "slow-err", 1_700_000_010,
                     50_000, {"env": "prod"}, error=True),
    ])
    _, status, message = channel.call(
        "/opentelemetry.proto.collector.trace.v1.TraceService/Export",
        request)
    assert status == 0, message

    def find(params: bytes) -> list[bytes]:
        messages, status, msg = channel.call(
            "/jaeger.storage.v1.SpanReaderPlugin/FindTraceIDs",
            pb_msg(1, params))
        assert status == 0, msg
        return _decode_byte_fields(messages[0], field=1) if messages else []

    tag = pb_msg(3, pb_str(1, "env") + pb_str(2, "prod"))
    assert [i.hex() for i in find(pb_str(1, "tagged") + tag)] == [TRACE_C]
    # non-matching tag value filters the trace out
    bad_tag = pb_msg(3, pb_str(1, "env") + pb_str(2, "staging"))
    assert find(pb_str(1, "tagged") + bad_tag) == []
    # error=true matches the span_status-derived virtual tag
    err_tag = pb_msg(3, pb_str(1, "error") + pb_str(2, "true"))
    assert [i.hex() for i in find(pb_str(1, "tagged") + err_tag)] == [TRACE_C]
    # duration_max below the span's 50ms filters it out (field 7 Duration)
    dur_max = pb_msg(7, pb_varint(2, 1_000_000))  # 1ms in nanos
    assert find(pb_str(1, "tagged") + dur_max) == []

    # bool tags stream back with v_type=BOOL(1) + v_bool (the mandated
    # error=true tag on error spans; reference emits ValueType::Bool=1)
    messages, status, _ = channel.call(
        "/jaeger.storage.v1.SpanReaderPlugin/FindTraces",
        pb_msg(1, pb_str(1, "tagged")))
    assert status == 0 and len(messages) == 1
    spans = _decode_byte_fields(messages[0], field=1)
    kvs = [dict(_iter_simple(kv))
           for kv in _decode_byte_fields(spans[0], field=8)]
    error_kv = next(kv for kv in kvs if kv[1] == b"error")
    assert error_kv[2] == 1 and error_kv[4] == 1  # v_type=BOOL, v_bool=true


# --- tiny protobuf readers for assertions ---------------------------------

def _iter_simple(payload: bytes):
    from quickwit_tpu_torch.serve.otlp_proto import iter_fields
    for field, wire, value in iter_fields(memoryview(payload)):
        yield field, bytes(value) if wire == 2 else value


def _decode_strings(payload: bytes, field: int) -> list[str]:
    return [v.decode() for f, v in _iter_simple(payload)
            if f == field and isinstance(v, bytes)]


def _decode_byte_fields(payload: bytes, field: int) -> list[bytes]:
    return [v for f, v in _iter_simple(payload)
            if f == field and isinstance(v, bytes)]


def test_large_streamed_response_respects_flow_control():
    """Responses above SETTINGS_MAX_FRAME_SIZE and the 65535 initial
    flow-control window split into frames and wait for WINDOW_UPDATEs."""
    from quickwit_tpu_torch.serve.http2 import Http2Server
    from quickwit_tpu_torch.serve.grpc_server import _grpc_frame

    big = bytes(range(256)) * 1024  # 256 KiB

    def handler(headers, body):
        return ([(":status", "200"),
                 ("content-type", "application/grpc")],
                [_grpc_frame(big)], [("grpc-status", "0")])

    server = Http2Server(handler)
    channel = GrpcChannel(server.host, server.port)
    try:
        messages, status, message = channel.call("/x/Y", b"req")
        assert status == 0, message
        assert messages == [big]
    finally:
        channel.close()
        server.stop()


def test_grpc_call_timeout_clamped_to_deadline_budget():
    """A per-call `timeout_secs` below the channel default bounds the
    WHOLE stream: a leaf stalling past the query's remaining budget
    frees the shared channel in ~budget seconds, not the 30s default,
    and the socket's default timeout is restored afterwards."""
    import time as _time

    from quickwit_tpu_torch.serve.http2 import Http2Server
    from quickwit_tpu_torch.serve.grpc_server import _grpc_frame

    def handler(headers, body):
        _time.sleep(1.5)  # stall well past the call budget
        return ([(":status", "200"),
                 ("content-type", "application/grpc")],
                [_grpc_frame(b"ok")], [("grpc-status", "0")])

    server = Http2Server(handler)
    channel = GrpcChannel(server.host, server.port, timeout=30.0)
    try:
        start = _time.monotonic()
        with pytest.raises(OSError):
            channel.call("/x/Y", b"req", timeout_secs=0.3)
        assert _time.monotonic() - start < 1.2
        assert channel._sock.gettimeout() == 30.0  # default restored
    finally:
        channel.close()
        server.stop()


def test_grpc_leaf_search_clamps_timeout_to_remaining_deadline():
    """GrpcSearchClient.leaf_search mirrors HttpSearchClient: the wire
    deadline_millis (remaining budget at dispatch) plus trailer grace
    becomes the per-call timeout; no deadline means channel default."""
    from quickwit_tpu_torch.query import parse_query_string
    from quickwit_tpu_torch.search.models import LeafSearchRequest, SearchRequest
    from quickwit_tpu_torch.serve.grpc_server import GrpcSearchClient

    client = GrpcSearchClient("127.0.0.1:1", "http://127.0.0.1:1")
    seen = []

    def fake_call(path, payload, timeout_secs=None):
        seen.append(timeout_secs)
        raise RuntimeError("stop before decode")

    client._call = fake_call
    request = LeafSearchRequest(
        search_request=SearchRequest(
            index_ids=["idx"],
            query_ast=parse_query_string("x", ["body"])),
        index_uid="idx:0000", doc_mapping={}, splits=[],
        deadline_millis=2000)
    with pytest.raises(RuntimeError):
        client.leaf_search(request)
    request.deadline_millis = None
    with pytest.raises(RuntimeError):
        client.leaf_search(request)
    assert seen == [2.5, None]


def test_grpc_port_loads_from_config(tmp_path):
    from quickwit_tpu_torch.config.node_config import load_node_config
    path = tmp_path / "node.yaml"
    path.write_text("node_id: n1\ngrpc:\n  listen_port: 7281\n")
    config = load_node_config(str(path), env={})
    assert config.grpc_port == 7281
    config2 = load_node_config(str(path), env={"QW_GRPC_PORT": "9999"})
    assert config2.grpc_port == 9999
    assert load_node_config(None, env={}).grpc_port is None


def test_grpc_server_restarts_with_background_services():
    node = Node(NodeConfig(node_id="grpc-restart", rest_port=0, grpc_port=0,
                           metastore_uri="ram:///grpcr/ms",
                           default_index_root_uri="ram:///grpcr/idx",
                           device="cpu"),
                storage_resolver=StorageResolver.for_test())
    assert node.grpc_server is not None
    node.start_background_services()
    node.stop_background_services()
    assert node.grpc_server is None
    node.start_background_services()
    try:
        assert node.grpc_server is not None
        channel = GrpcChannel("127.0.0.1", node.grpc_server.port)
        _m, status, _msg = channel.call(
            "/jaeger.storage.v1.SpanReaderPlugin/GetServices", b"")
        assert status == 0
        channel.close()
    finally:
        node.stop_background_services()


# --- the two packages on one wire ---------------------------------------------

# header lists a gRPC peer sends and answers: request pseudo-headers, the
# trace context, the status trailers, non-ASCII and long values (a length
# past the 7-bit HPACK prefix), every byte value once
HEADER_CORPUS = [
    [(":method", "POST"), (":scheme", "http"),
     (":path", "/quickwit.search.SearchService/LeafSearch"),
     (":authority", "localhost"), ("content-type", "application/grpc"),
     ("te", "trailers")],
    [("traceparent",
      "00-0102030405060708090a0b0c0d0e0f10-0102030405060708-01")],
    [(":status", "200"), ("content-type", "application/grpc")],
    [("grpc-status", "0")],
    [("grpc-status", "8"), ("grpc-message",
                            "OverloadShed: leaf overloaded (retry 1.0s)")],
    [("grpc-message", "trace 'deadbeef' not found"), ("x-empty", "")],
    [("x-long", "v" * 300), ("x-unicode", "héllo wörld ✓")],
    [("x-bytes", bytes(range(32, 127)).decode())],
]


def _packages():
    from quickwit_tpu.serve import grpc_server as jgrpc
    from quickwit_tpu.serve import hpack_huffman as jhuff
    from quickwit_tpu.serve import http2 as jh2
    from quickwit_tpu_torch.serve import grpc_server as tgrpc
    from quickwit_tpu_torch.serve import hpack_huffman as thuff
    from quickwit_tpu_torch.serve import http2 as th2
    return {"jax": (jh2, jhuff, jgrpc), "port": (th2, thuff, tgrpc)}


def test_huffman_tables_and_codes_are_equal():
    pk = _packages()
    (_, jhuff, _), (_, thuff, _) = pk["jax"], pk["port"]
    assert thuff.HUFFMAN_CODES == jhuff.HUFFMAN_CODES
    strings = [v.encode() for block in HEADER_CORPUS for kv in block
               for v in kv] + [bytes(range(256))]
    for raw in strings:
        port, jax = thuff.huffman_encode(raw), jhuff.huffman_encode(raw)
        assert port == jax
        assert thuff.huffman_decode(jax) == raw == jhuff.huffman_decode(port)
    with pytest.raises(thuff.HuffmanError):
        thuff.huffman_decode(b"\x00")   # padding that is not an EOS prefix


def _huffman_block(huff, headers):
    """Literal-with-incremental-indexing HPACK with Huffman strings (what
    grpc-core sends by default)."""
    out = bytearray()
    for name, value in headers:
        out.append(0x40)
        for raw in (name.encode(), value.encode()):
            coded = huff.huffman_encode(raw)
            assert len(coded) < 127
            out += bytes([0x80 | len(coded)]) + coded
    return bytes(out)


@pytest.mark.parametrize("index", range(len(HEADER_CORPUS)))
def test_hpack_blocks_and_frames_are_equal(index):
    headers = HEADER_CORPUS[index]
    pk = _packages()
    (jh2, jhuff, jgrpc), (th2, thuff, tgrpc) = pk["jax"], pk["port"]
    raw = th2.hpack_encode_raw(headers)
    assert raw == jh2.hpack_encode_raw(headers)
    assert th2.HpackDecoder().decode(raw) == headers
    assert jh2.HpackDecoder().decode(raw) == headers
    for flags in (th2.FLAG_END_HEADERS,
                  th2.FLAG_END_HEADERS | th2.FLAG_END_STREAM):
        assert (th2.frame(th2.FRAME_HEADERS, flags, 3, raw)
                == jh2.frame(jh2.FRAME_HEADERS, flags, 3, raw))
    message = "|".join(f"{k}={v}" for k, v in headers).encode()
    assert tgrpc._grpc_frame(message) == jgrpc._grpc_frame(message)
    assert (th2.frame(th2.FRAME_DATA, th2.FLAG_END_STREAM, 3,
                      tgrpc._grpc_frame(message))
            == jh2.frame(jh2.FRAME_DATA, jh2.FLAG_END_STREAM, 3,
                         jgrpc._grpc_frame(message)))
    if all(len(thuff.huffman_encode(s.encode())) < 127
           for kv in headers for s in kv):
        # each decoder reads the other package's Huffman block, and the
        # dynamic table it builds serves an indexed repeat of the block
        port_block = _huffman_block(thuff, headers)
        assert port_block == _huffman_block(jhuff, headers)
        for h2 in (th2, jh2):
            decoder = h2.HpackDecoder()
            assert decoder.decode(port_block) == headers
            n = len(headers)
            indexed = bytes(0x80 | (61 + n - i) for i in range(n))
            assert decoder.decode(indexed) == headers


def _recorded_request(grpc_mod, message):
    """The bytes a package's `GrpcChannel` sends for one unary call: a
    one-shot loopback server records them, then answers with the frames
    the port's server writes for `message`."""
    import socket
    import threading

    from quickwit_tpu_torch.serve import http2 as th2
    from quickwit_tpu_torch.serve.grpc_server import _grpc_frame

    listener = socket.create_server(("127.0.0.1", 0))
    seen = bytearray()

    def serve():
        conn, _ = listener.accept()
        with conn:
            def read_exact(n):
                out = th2.read_exact_from(conn, n)
                seen.extend(out)
                return out
            read_exact(len(th2.PREFACE))
            while True:
                kind, flags, stream, _payload = th2.read_frame(read_exact)
                if kind == th2.FRAME_DATA and flags & th2.FLAG_END_STREAM:
                    break
            conn.sendall(
                th2.frame(th2.FRAME_SETTINGS, 0, 0, b"")
                + th2.frame(th2.FRAME_HEADERS, th2.FLAG_END_HEADERS, stream,
                            th2.hpack_encode_raw(HEADER_CORPUS[2]))
                + th2.frame(th2.FRAME_DATA, 0, stream, _grpc_frame(message))
                + th2.frame(th2.FRAME_HEADERS,
                            th2.FLAG_END_HEADERS | th2.FLAG_END_STREAM,
                            stream, th2.hpack_encode_raw(HEADER_CORPUS[3])))
            conn.recv(1 << 16)   # the client's acks, then its close

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    channel = grpc_mod.GrpcChannel("127.0.0.1", listener.getsockname()[1])
    try:
        got = channel.call("/quickwit.search.SearchService/LeafSearch",
                           message)
    finally:
        channel.close()
        thread.join(10)
        listener.close()
    return bytes(seen), got


def test_channels_send_equal_bytes():
    pk = _packages()
    message = b"\x00\x01binwire payload\xff" * 50
    port_sent, port_got = _recorded_request(pk["port"][2], message)
    jax_sent, jax_got = _recorded_request(pk["jax"][2], message)
    assert port_sent == jax_sent
    assert port_got == jax_got == ([message], 0, "")


def _stream_frames(sock, h2):
    """Frames on stream 1 until its END_STREAM, and the connection-level
    frames seen meanwhile (their order depends on thread timing)."""
    def read_exact(n):
        return h2.read_exact_from(sock, n)
    stream, conn = [], []
    while True:
        kind, flags, sid, payload = h2.read_frame(read_exact)
        if sid == 1:
            stream.append(h2.frame(kind, flags, sid, payload))
            if flags & h2.FLAG_END_STREAM:
                return stream, sorted(conn)
        else:
            conn.append(h2.frame(kind, flags, sid, payload))


def test_servers_answer_equal_frames():
    import socket
    pk = _packages()
    big = bytes(range(256)) * 200   # past one frame, inside the window

    request = None
    answers = {}
    for name, (h2, _huff, grpc_mod) in pk.items():
        def handler(headers, body, grpc_mod=grpc_mod):
            assert grpc_mod._grpc_unframe(body) == b"req"
            return ([(":status", "200"),
                     ("content-type", "application/grpc")],
                    [grpc_mod._grpc_frame(big)], [("grpc-status", "0")])
        server = h2.Http2Server(handler)
        request = (h2.PREFACE + h2.frame(h2.FRAME_SETTINGS, 0, 0, b"")
                   + h2.frame(h2.FRAME_HEADERS, h2.FLAG_END_HEADERS, 1,
                              h2.hpack_encode_raw(HEADER_CORPUS[0]))
                   + h2.frame(h2.FRAME_DATA, h2.FLAG_END_STREAM, 1,
                              grpc_mod._grpc_frame(b"req")))
        sock = socket.create_connection((server.host, server.port),
                                        timeout=10)
        try:
            sock.sendall(request)
            answers[name] = _stream_frames(sock, h2)
        finally:
            sock.close()
            server.stop()
    assert answers["port"] == answers["jax"]
    assert len(answers["port"][0]) >= 3   # headers, data..., trailers


@pytest.fixture(scope="module")
def mixed_nodes():
    """A JAX node and a port node (on the CPU), each with its gRPC plane."""
    from quickwit_tpu.serve import Node as JNode, NodeConfig as JNodeConfig
    from quickwit_tpu.storage import StorageResolver as JResolver
    jax_node = JNode(JNodeConfig(node_id="jax-g", rest_port=0, grpc_port=0,
                                 metastore_uri="ram:///mixg/ms",
                                 default_index_root_uri="ram:///mixg/idx"),
                     storage_resolver=JResolver.for_test())
    port_node = Node(NodeConfig(node_id="port-g", rest_port=0, grpc_port=0,
                                metastore_uri="ram:///mixg/ms",
                                default_index_root_uri="ram:///mixg/idx",
                                device="cpu"),
                     storage_resolver=StorageResolver.for_test())
    try:
        yield {"jax": jax_node, "port": port_node}
    finally:
        jax_node.grpc_server.stop()
        port_node.grpc_server.stop()


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_each_channel_talks_to_the_other_server(mixed_nodes, client, server):
    pk = _packages()
    grpc_mod = pk[client][2]
    node = mixed_nodes[server]
    channel = grpc_mod.GrpcChannel("127.0.0.1", node.grpc_server.port)
    try:
        _, status, message = channel.call(
            "/opentelemetry.proto.collector.trace.v1.TraceService/Export",
            _export_request(f"svc-{client}", [_otlp_span(
                TRACE_A, "0102030405060708", "op", 1_700_000_000, 10)]))
        assert status == 0, message
        messages, status, _ = channel.call(
            "/jaeger.storage.v1.SpanReaderPlugin/GetServices", b"")
        assert status == 0
        assert f"svc-{client}" in _decode_strings(messages[0], field=1)
        _, status, message = channel.call("/no.such.Service/Nope", b"")
        assert status == 12 and "unknown method" in message
    finally:
        channel.close()
