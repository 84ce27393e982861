"""Binary OTLP/HTTP decoding (application/x-protobuf).

Role of the reference's protobuf OTLP services (`quickwit-opentelemetry/
src/otlp/{logs,traces}.rs` — tonic-generated ExportLogsServiceRequest /
ExportTraceServiceRequest handlers). The OTLP .proto files are not in this
image, so this is a minimal, schema-driven protobuf *wire format* decoder
(varint / fixed64 / length-delimited — the whole format) with the OTLP
field numbers inlined from the public opentelemetry-proto schema. It emits
the same camelCase dict shapes as the JSON path, so `otlp_logs_to_docs` /
`otlp_traces_to_docs` serve both encodings unchanged.

Unknown fields are skipped by wire type, exactly like a generated parser —
new OTLP fields degrade gracefully instead of erroring.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator


class ProtoDecodeError(ValueError):
    """Malformed protobuf payload (maps to 400 at the REST layer)."""


# --------------------------------------------------------------------------
# wire format

def _read_varint(buf: memoryview, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise ProtoDecodeError("truncated varint")
        byte = buf[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7
        if shift > 63:
            raise ProtoDecodeError("varint too long")


def iter_fields(buf: memoryview) -> Iterator[tuple[int, int, Any]]:
    """(field_number, wire_type, value); length-delimited values are
    memoryviews, varints ints, fixed32/64 raw ints."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            value, i = _read_varint(buf, i)
        elif wire == 1:  # fixed64
            if i + 8 > n:
                raise ProtoDecodeError("truncated fixed64")
            value = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wire == 2:  # length-delimited
            length, i = _read_varint(buf, i)
            if i + length > n:
                raise ProtoDecodeError("truncated bytes field")
            value = buf[i: i + length]
            i += length
        elif wire == 5:  # fixed32
            if i + 4 > n:
                raise ProtoDecodeError("truncated fixed32")
            value = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ProtoDecodeError(f"unsupported wire type {wire}")
        yield field, wire, value


def _text(value: memoryview) -> str:
    return bytes(value).decode("utf-8", errors="replace")


def _f64(raw: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", raw))[0]


def _i64(raw: int) -> int:
    """Two's-complement reinterpretation for int64 varints."""
    return raw - (1 << 64) if raw >= (1 << 63) else raw


# --------------------------------------------------------------------------
# OTLP common (opentelemetry/proto/common/v1/common.proto)

def _any_value(buf: memoryview) -> dict[str, Any]:
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            return {"stringValue": _text(value)}
        if field == 2:
            return {"boolValue": bool(value)}
        if field == 3:
            return {"intValue": _i64(value)}
        if field == 4:
            return {"doubleValue": _f64(value)}
        if field == 5:  # ArrayValue{1: repeated AnyValue}
            return {"arrayValue": {"values": [
                _any_value(v) for f, _, v in iter_fields(value) if f == 1]}}
        if field == 6:  # KeyValueList{1: repeated KeyValue}
            return {"kvlistValue": {"values": [
                _key_value(v) for f, _, v in iter_fields(value) if f == 1]}}
        if field == 7:
            return {"bytesValue": bytes(value).hex()}
    return {}


def _key_value(buf: memoryview) -> dict[str, Any]:
    out: dict[str, Any] = {"key": "", "value": {}}
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            out["key"] = _text(value)
        elif field == 2:
            out["value"] = _any_value(value)
    return out


def _attributes(buf: memoryview, collected: list) -> None:
    collected.append(_key_value(buf))


def _resource(buf: memoryview) -> dict[str, Any]:
    attrs: list = []
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            _attributes(value, attrs)
    return {"attributes": attrs}


# --------------------------------------------------------------------------
# logs (opentelemetry/proto/logs/v1/logs.proto)

def _log_record(buf: memoryview) -> dict[str, Any]:
    record: dict[str, Any] = {"attributes": []}
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            record["timeUnixNano"] = value
        elif field == 11:
            record["observedTimeUnixNano"] = value
        elif field == 2:
            record["severityNumber"] = value
        elif field == 3:
            record["severityText"] = _text(value)
        elif field == 5:
            record["body"] = _any_value(value)
        elif field == 6:
            _attributes(value, record["attributes"])
        elif field == 9:
            record["traceId"] = bytes(value).hex()
        elif field == 10:
            record["spanId"] = bytes(value).hex()
    return record


def decode_logs_request(payload: bytes) -> dict[str, Any]:
    """ExportLogsServiceRequest bytes → the JSON-path `resourceLogs` shape."""
    try:
        return _decode_logs(memoryview(payload))
    except (TypeError, struct.error) as exc:
        # wire-type mismatch (e.g. a varint where a message was expected)
        # is client data, not a server fault
        raise ProtoDecodeError(f"wire-type mismatch: {exc}")


def _decode_logs(buf: memoryview) -> dict[str, Any]:
    resource_logs = []
    for field, _wire, value in iter_fields(buf):
        if field != 1:
            continue
        entry: dict[str, Any] = {"scopeLogs": []}
        for f2, _w2, v2 in iter_fields(value):
            if f2 == 1:
                entry["resource"] = _resource(v2)
            elif f2 == 2:
                records = []
                for f3, _w3, v3 in iter_fields(v2):
                    if f3 == 2:
                        records.append(_log_record(v3))
                entry["scopeLogs"].append({"logRecords": records})
        resource_logs.append(entry)
    return {"resourceLogs": resource_logs}


# --------------------------------------------------------------------------
# traces (opentelemetry/proto/trace/v1/trace.proto)

_STATUS_CODES = {0: "unset", 1: "ok", 2: "error"}


def _span(buf: memoryview) -> dict[str, Any]:
    span: dict[str, Any] = {"attributes": []}
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            span["traceId"] = bytes(value).hex()
        elif field == 2:
            span["spanId"] = bytes(value).hex()
        elif field == 4:
            span["parentSpanId"] = bytes(value).hex()
        elif field == 5:
            span["name"] = _text(value)
        elif field == 7:
            span["startTimeUnixNano"] = value
        elif field == 8:
            span["endTimeUnixNano"] = value
        elif field == 9:
            _attributes(value, span["attributes"])
        elif field == 15:  # Status{3: code varint}
            for f2, _w2, v2 in iter_fields(value):
                if f2 == 3:
                    span["status"] = {"code": _STATUS_CODES.get(v2, "unset")}
    return span


def decode_traces_request(payload: bytes) -> dict[str, Any]:
    """ExportTraceServiceRequest bytes → the `resourceSpans` shape."""
    try:
        return _decode_traces(memoryview(payload))
    except (TypeError, struct.error) as exc:
        raise ProtoDecodeError(f"wire-type mismatch: {exc}")


def _decode_traces(buf: memoryview) -> dict[str, Any]:
    resource_spans = []
    for field, _wire, value in iter_fields(buf):
        if field != 1:
            continue
        entry: dict[str, Any] = {"scopeSpans": []}
        for f2, _w2, v2 in iter_fields(value):
            if f2 == 1:
                entry["resource"] = _resource(v2)
            elif f2 == 2:
                spans = []
                for f3, _w3, v3 in iter_fields(v2):
                    if f3 == 2:
                        spans.append(_span(v3))
                entry["scopeSpans"].append({"spans": spans})
        resource_spans.append(entry)
    return {"resourceSpans": resource_spans}
