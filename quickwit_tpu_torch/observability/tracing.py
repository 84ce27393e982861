"""Self-tracing: spans on the engine's own hot paths, exported as OTLP.

Role of the reference's `tracing` + `tracing-opentelemetry` setup and the
`quickwit-telemetry-exporters` crate (`quickwit-common/src/
tracing_utils.rs:23-112` for W3C context propagation,
`rate_limited_tracing.rs:306` for log rate limiting): the engine traces
its own request handling and can ship those spans to any OTLP consumer —
including ITSELF (the node's own otel-traces index), closing the
"quickwit observes quickwit" loop.

Design: a tiny thread-local tracer (no external dependency), W3C
`traceparent` inject/extract so spans stitch across the root↔leaf HTTP
hop, and a batch exporter that renders finished spans as OTLP JSON
`resourceSpans`. Export re-entrancy is suppressed: spans opened while an
export is in flight are dropped, not queued, so exporting into the local
otel index cannot trace itself into a feedback loop.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class SpanData:
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars
    parent_span_id: str
    name: str
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "unset"
    # which node produced the span: set by the server entry point and
    # inherited by children, so per-node exporters on the process-global
    # tracer only ship their own node's spans (multi-node-per-process
    # tests and in-process clusters)
    scope: str = ""

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value


def _new_id(nbytes: int) -> str:
    # os.urandom, not the global PRNG: seeded harnesses and forked workers
    # share `random` state and would mint colliding trace/span ids
    return os.urandom(nbytes).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """W3C traceparent: version-traceid-spanid-flags. Returns
    (trace_id, span_id) or None on malformed/all-zero input."""
    parts = (header or "").strip().split("-")
    if len(parts) < 4 or parts[0] == "ff":
        return None
    trace_id, span_id = parts[1].lower(), parts[2].lower()
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


class Tracer:
    """Thread-local span stack + fan-out to processors on span end."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._processors: list[Callable[[SpanData], None]] = []
        self.enabled = True

    # --- processors --------------------------------------------------------
    def add_processor(self, processor: Callable[[SpanData], None]) -> None:
        self._processors.append(processor)

    def remove_processor(self, processor) -> None:
        if processor in self._processors:
            self._processors.remove(processor)

    # --- context -----------------------------------------------------------
    def _stack(self) -> list[SpanData]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Optional[SpanData]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_traceparent(self) -> Optional[str]:
        span = self.current_span()
        if span is None:
            return None
        return format_traceparent(span.trace_id, span.span_id)

    @property
    def _suppressed(self) -> bool:
        return getattr(self._tls, "suppress", False)

    @contextmanager
    def suppress(self):
        """No spans recorded inside (export paths: no feedback loops)."""
        prev = self._suppressed
        self._tls.suppress = True
        try:
            yield
        finally:
            self._tls.suppress = prev

    # --- spans -------------------------------------------------------------
    @contextmanager
    def span(self, name: str, attributes: Optional[dict[str, Any]] = None,
             remote_parent: Optional[str] = None, scope: str = ""):
        """Span context manager. `remote_parent` is an incoming W3C
        traceparent header; when valid, the span joins that trace.
        `scope` tags the span's producer (node id); children inherit."""
        if not self.enabled or self._suppressed:
            yield SpanData("", "", "", name)
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        trace_id = parent.trace_id if parent else None
        parent_id = parent.span_id if parent else ""
        if parent is None and remote_parent:
            remote = parse_traceparent(remote_parent)
            if remote is not None:
                trace_id, parent_id = remote
        span = SpanData(
            trace_id=trace_id or _new_id(16),
            span_id=_new_id(8),
            parent_span_id=parent_id,
            name=name,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
            scope=scope or (parent.scope if parent else ""))
        stack.append(span)
        try:
            yield span
            if span.status == "unset":
                span.status = "ok"
        except BaseException:
            # a handler that already classified the failure (e.g. a REST
            # 4xx mapped below the span) keeps its classification
            if span.status == "unset":
                span.status = "error"
            raise
        finally:
            span.end_ns = time.time_ns()
            stack.pop()
            for processor in self._processors:
                try:
                    processor(span)
                except Exception:  # noqa: BLE001 - never break the traced path
                    pass


TRACER = Tracer()


def spans_to_otlp(spans: list[SpanData], service_name: str,
                  node_id: str = "") -> dict[str, Any]:
    """Finished spans → OTLP JSON `resourceSpans` (the shape both our
    `/otlp/v1/traces` endpoint and any OTLP collector accept)."""
    def _attrs(mapping: dict[str, Any]) -> list[dict[str, Any]]:
        out = []
        for key, value in mapping.items():
            if isinstance(value, bool):
                v: dict[str, Any] = {"boolValue": value}
            elif isinstance(value, int):
                v = {"intValue": str(value)}
            elif isinstance(value, float):
                v = {"doubleValue": value}
            else:
                v = {"stringValue": str(value)}
            out.append({"key": key, "value": v})
        return out

    resource_attrs = {"service.name": service_name}
    if node_id:
        resource_attrs["node.id"] = node_id
    return {"resourceSpans": [{
        "resource": {"attributes": _attrs(resource_attrs)},
        "scopeSpans": [{
            "scope": {"name": "quickwit_tpu_torch.self_tracing"},
            "spans": [{
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_span_id,
                "name": s.name,
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns),
                # proto3 JSON enum name (a real otel-collector rejects
                # bare lowercase strings)
                "status": {"code": {"ok": "STATUS_CODE_OK",
                                    "error": "STATUS_CODE_ERROR"}.get(
                                        s.status, "STATUS_CODE_UNSET")},
                "attributes": _attrs(s.attributes),
            } for s in spans],
        }],
    }]}


class BatchSpanExporter:
    """Span processor that batches and ships (reference: the OTLP span
    exporter installed by quickwit-telemetry-exporters). `export_fn`
    receives an OTLP JSON payload; failures drop the batch (telemetry is
    best-effort and must never apply backpressure to the data path)."""

    def __init__(self, export_fn: Callable[[dict[str, Any]], None],
                 service_name: str = "quickwit-tpu", node_id: str = "",
                 max_batch: int = 256, interval_secs: float = 5.0,
                 max_buffer: int = 4096, scope: str = ""):
        self.export_fn = export_fn
        self.service_name = service_name
        self.node_id = node_id
        # only ship spans tagged with this producer scope ("" = all):
        # several self-tracing nodes in one process each export exactly
        # their own spans, correctly attributed
        self.scope = scope
        self.max_batch = max_batch
        self.interval_secs = interval_secs
        self.max_buffer = max_buffer
        self._buffer: list[SpanData] = []
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._wake = threading.Event()
        self._stop = False
        # qwlint: disable-next-line=QW003 - exporter drains finished spans
        # for ALL queries; binding one query's context would be wrong
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._thread = threading.Thread(target=self._run,
                                        name="span-exporter", daemon=True)
        self._thread.start()

    def __call__(self, span: SpanData) -> None:  # Tracer processor hook
        if self.scope and span.scope != self.scope:
            return
        with self._lock:
            if len(self._buffer) >= self.max_buffer:
                return  # shed, never block the traced path
            self._buffer.append(span)
            full = len(self._buffer) >= self.max_batch
        if full:
            self._wake.set()

    def _drain(self) -> list[SpanData]:
        with self._lock:
            batch, self._buffer = self._buffer, []
        return batch

    def _export(self, batch: list[SpanData]) -> None:
        if not batch:
            return
        payload = spans_to_otlp(batch, self.service_name, self.node_id)
        with TRACER.suppress():
            try:
                self.export_fn(payload)
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass

    def _run(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self.interval_secs)
            self._wake.clear()
            self._export(self._drain())

    def flush(self) -> None:
        self._export(self._drain())

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2.0)
        self.flush()


class RateLimitedLog:
    """`rate_limited_tracing.rs` analogue: at most `limit` emissions of a
    keyed message per `period_secs` window; excess calls are counted and
    the count is reported on the window's first emission after reset."""

    def __init__(self, limit: int = 5, period_secs: float = 60.0,
                 clock=time.monotonic):
        self.limit = limit
        self.period_secs = period_secs
        self.clock = clock
        # qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter
        # updates only, no instrumented ops inside
        self._lock = threading.Lock()
        self._windows: dict[str, tuple[float, int, int]] = {}

    def should_log(self, key: str) -> tuple[bool, int]:
        """(emit_now, num_suppressed_since_last_emit)."""
        now = self.clock()
        with self._lock:
            start, emitted, suppressed = self._windows.get(key,
                                                           (now, 0, 0))
            if now - start >= self.period_secs:
                start, emitted, suppressed = now, 0, suppressed
            if emitted < self.limit:
                self._windows[key] = (start, emitted + 1, 0)
                return True, suppressed
            self._windows[key] = (start, emitted, suppressed + 1)
            return False, 0
