"""The port's OTLP decoder, OTel service and profiler against the JAX package's.

Carried over: `tests/test_otlp_proto.py` (6) and `tests/test_profiler.py`
(4), each in both packages. The decoder's output for the same bytes must
be equal across the packages. Through REST, a JAX node and a port node
(`tests/test_torch_rest_api.py`'s `Pair`) take the same OTLP JSON and
protobuf (plain and gzip) payloads and answer the Jaeger routes; their
answers must be equal, byte for byte where the body is protobuf.
"""

import gzip
import struct
import threading
import urllib.request

import pytest

from test_torch_rest_api import (PACKAGES, check_otlp_and_jaeger, load,
                                 pair_of_nodes)


# --- minimal protobuf writer (independent of the decoder) -----------------

def varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return tag(field, 2) + varint(len(payload)) + payload


def vi(field: int, value: int) -> bytes:  # varint field
    return tag(field, 0) + varint(value)


def f64(field: int, value: int) -> bytes:  # fixed64 field
    return tag(field, 1) + struct.pack("<Q", value)


def s(field: int, text: str) -> bytes:
    return ld(field, text.encode())


def any_str(text: str) -> bytes:
    return s(1, text)


def kv(key: str, value_any: bytes) -> bytes:
    return s(1, key) + ld(2, value_any)


def make_logs_request() -> bytes:
    resource = ld(1, kv("service.name", any_str("checkout")))
    record = (f64(1, 1_600_000_000_000_000_000)
              + vi(2, 17)
              + s(3, "ERROR")
              + ld(5, any_str("payment failed"))
              + ld(6, kv("k8s.pod", any_str("pod-7")))
              + ld(9, bytes.fromhex("aabbccddeeff00112233445566778899"))
              + ld(10, bytes.fromhex("0102030405060708"))
              + vi(99, 5))                         # unknown field: skipped
    scope_logs = ld(2, record)
    resource_logs = ld(1, resource) + ld(2, scope_logs)
    return ld(1, resource_logs)


def make_traces_request() -> bytes:
    resource = ld(1, kv("service.name", any_str("checkout")))
    status = vi(3, 2)  # code = error
    span = (ld(1, bytes.fromhex("aabbccddeeff00112233445566778899"))
            + ld(2, bytes.fromhex("0102030405060708"))
            + s(5, "charge_card")
            + f64(7, 1_600_000_000_000_000_000)
            + f64(8, 1_600_000_000_250_000_000)
            + ld(9, kv("retry", tag(3, 0) + varint(2)))
            + ld(15, status))
    scope_spans = ld(2, span)
    resource_spans = ld(1, resource) + ld(2, scope_spans)
    return ld(1, resource_spans)


NEGATIVE_INT_LOGS = ld(1, ld(2, ld(2, ld(6, kv(
    "delta", tag(3, 0) + varint((-5) & 0xFFFFFFFFFFFFFFFF))))))


@pytest.fixture(params=PACKAGES)
def proto(request):
    return load(request.param).mod("serve.otlp_proto")


def test_decode_logs_request(proto):
    decoded = proto.decode_logs_request(make_logs_request())
    record = decoded["resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
    assert record["severityText"] == "ERROR"
    assert record["severityNumber"] == 17
    assert record["body"] == {"stringValue": "payment failed"}
    assert record["traceId"] == "aabbccddeeff00112233445566778899"
    assert record["timeUnixNano"] == 1_600_000_000_000_000_000
    attrs = {a["key"]: a["value"] for a in record["attributes"]}
    assert attrs["k8s.pod"] == {"stringValue": "pod-7"}
    resource = decoded["resourceLogs"][0]["resource"]["attributes"]
    assert resource[0] == {"key": "service.name",
                           "value": {"stringValue": "checkout"}}


def test_decode_traces_request(proto):
    decoded = proto.decode_traces_request(make_traces_request())
    span = decoded["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert span["name"] == "charge_card"
    assert span["status"] == {"code": "error"}
    assert span["endTimeUnixNano"] - span["startTimeUnixNano"] == 250_000_000
    attrs = {a["key"]: a["value"] for a in span["attributes"]}
    assert attrs["retry"] == {"intValue": 2}


def test_decode_malformed_payloads(proto):
    for junk in (b"\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff",
                 tag(1, 2) + varint(100) + b"short",
                 tag(1, 3) + b"x"):
        with pytest.raises(proto.ProtoDecodeError):
            proto.decode_logs_request(junk)


def test_negative_int_attribute(proto):
    record = proto.decode_logs_request(NEGATIVE_INT_LOGS)[
        "resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
    assert record["attributes"][0]["value"] == {"intValue": -5}


@pytest.mark.parametrize("decoder,payload", [
    ("decode_logs_request", make_logs_request()),
    ("decode_traces_request", make_traces_request()),
    ("decode_logs_request", NEGATIVE_INT_LOGS),
    ("decode_traces_request", ld(1, ld(2, ld(2, vi(99, 3))))),
], ids=["logs", "traces", "negative-int", "unknown-field"])
def test_decoded_requests_equal_across_packages(decoder, payload):
    jax_out, port_out = (getattr(load(root).mod("serve.otlp_proto"),
                                 decoder)(payload) for root in PACKAGES)
    assert port_out == jax_out


@pytest.fixture
def api():
    with pair_of_nodes(node_id="otlp", metastore_uri="ram:///otlp/ms",
                       default_index_root_uri="ram:///otlp/ix") as pair:
        yield pair


PROTO = {"Content-Type": "application/x-protobuf"}


def test_rest_binary_otlp_round_trip(api):
    """Binary OTLP through the REST route: docs land in the otel indexes
    and serve the Jaeger API."""
    status, out = api.request("POST", "/api/v1/otlp/v1/logs",
                              make_logs_request(), raw=True, headers=PROTO)
    assert status == 200 and out == b""  # empty ExportLogsServiceResponse
    status, _ = api.request("POST", "/api/v1/otlp/v1/traces",
                            make_traces_request(), raw=True, headers=PROTO)
    assert status == 200
    status, services = api.request("GET", "/api/v1/jaeger/api/services")
    assert "checkout" in services["data"]
    status, _ = api.request("GET", "/api/v1/jaeger/api/traces?"
                                   "service=checkout&limit=5")
    assert status == 200
    status, _ = api.request("POST", "/api/v1/otlp/v1/logs", b"\xff\xff\xff",
                            headers=PROTO)
    assert status == 400


def test_rest_gzip_and_wiretype_guards(api):
    """Gzip-compressed OTLP bodies inflate transparently; wire-type
    mismatches and corrupted gzip are 400s, not 500s."""
    status, _ = api.request("POST", "/api/v1/otlp/v1/logs",
                            gzip.compress(make_logs_request()), raw=True,
                            headers={**PROTO, "Content-Encoding": "gzip"})
    assert status == 200
    status, out = api.request("POST", "/api/v1/otlp/v1/logs", b"\x08\x01",
                              headers=PROTO)
    assert status == 400, out
    status, _ = api.request("POST", "/api/v1/otlp/v1/logs", b"\x1f\x8b junk",
                            headers={**PROTO, "Content-Encoding": "gzip"})
    assert status == 400


def test_otlp_json_and_jaeger(api):
    check_otlp_and_jaeger(api)


# --- the profiler (tests/test_profiler.py) --------------------------------

def _busy_loop(stop):
    while not stop.is_set():
        sum(i * i for i in range(500))


def _sample(profiler, duration):
    stop = threading.Event()
    worker = threading.Thread(target=_busy_loop, args=(stop,), daemon=True)
    worker.start()
    try:
        return profiler.sample_stacks(duration_secs=duration, hz=200)
    finally:
        stop.set()
        worker.join(timeout=2)


@pytest.fixture(params=PACKAGES)
def profiler(request):
    return load(request.param).mod("observability.profiler")


def test_sampler_catches_busy_function(profiler):
    counts = _sample(profiler, 0.4)
    assert sum(counts.values()) > 10
    assert any(any("_busy_loop" in frame for frame in stack)
               for stack in counts)


def test_collapsed_format(profiler):
    text = profiler.collapse(_sample(profiler, 0.2))
    lines = [line for line in text.splitlines() if line]
    assert lines
    for line in lines:
        frames, _, count = line.rpartition(" ")
        assert int(count) > 0
        assert frames


def test_svg_renders_self_contained(profiler):
    svg = profiler.render_svg(_sample(profiler, 0.2), title="test profile")
    assert svg.startswith("<svg")
    assert svg.endswith("</svg>")
    assert "test profile" in svg
    assert "<script" not in svg
    assert "_busy_loop" in svg


def test_port_frames_are_labelled_by_package_path():
    label = load("quickwit_tpu_torch").mod(
        "observability.profiler")._frame_label
    frame = type("F", (), {
        "f_code": type("C", (), {
            "co_filename": "/x/quickwit_tpu_torch/serve/rest.py",
            "co_name": "route"})(), "f_lineno": 7})()
    assert label(frame) == "route (quickwit_tpu_torch/serve/rest.py:7)"


@pytest.mark.parametrize("root", PACKAGES)
def test_rest_flamegraph_endpoint(root):
    q = load(root)
    extra = {"device": "cpu"} if q.is_port else {}
    node = q.serve.Node(q.serve.NodeConfig(
        node_id="prof", rest_port=0, metastore_uri="ram:///prof/ms",
        default_index_root_uri="ram:///prof/idx", **extra),
        storage_resolver=q.storage.StorageResolver.for_test())
    server = q.serve.RestServer(node, host="127.0.0.1", port=0)
    server.start()
    stop = threading.Event()
    worker = threading.Thread(target=_busy_loop, args=(stop,), daemon=True)
    worker.start()
    try:
        url = (f"http://127.0.0.1:{server.port}/api/v1/developer/pprof/"
               f"flamegraph?duration=0.3&hz=200")
        with urllib.request.urlopen(url) as resp:
            assert resp.headers["Content-Type"].startswith("image/svg")
            body = resp.read().decode()
        assert body.startswith("<svg")
        with urllib.request.urlopen(url + "&format=collapsed") as resp:
            text = resp.read().decode()
        assert text.strip()
    finally:
        stop.set()
        worker.join(timeout=2)
        server.stop()


def test_rest_trace_route_exports_chrome_json(api):
    """`/api/v1/developer/trace`: the flight recorder as Chrome trace
    JSON, holding the root's events of a search just run."""
    _, port_side = api.sides
    port_side.q.mod("observability.flight").FLIGHT.begin_run()
    check_otlp_and_jaeger(api)
    status, trace = port_side.request(
        "GET", "/api/v1/developer/trace?limit=1000")
    assert status == 200
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"query.start", "query.done"} <= names
    assert {"process_name"} <= names
