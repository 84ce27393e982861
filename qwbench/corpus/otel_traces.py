"""otel-traces: spans of the OTLP traces index (`otel-traces-v0_7`), the
fields a latency dashboard reads, at the index's own types and precisions:
start times in milliseconds (the field's `fast_precision`) uniform over
one hour, durations in whole milliseconds (`span_duration_millis`, u64)
from a log-normal law in microseconds, and the OpenTelemetry demo's
services under a Zipf law. Every split covers the same hour, as the fresh
splits of many indexing pipelines do before merges. Drawn on the device
from the seed.

Dashboards fetch no documents, so the splits carry an empty doc store.
"""

from __future__ import annotations

import torch

from quickwit_tpu_torch.index.format import DOC_PAD, SplitFileBuilder, pad_to

from . import common


def service_weights(config: dict) -> torch.Tensor:
    """Each service's share of the spans, in the order of `services`:
    Zipf(`service_zipf_s`) over the ranks of `services_by_traffic`."""
    rank = {name: r for r, name in enumerate(config["services_by_traffic"])}
    return torch.tensor([(rank[name] + 1.0) ** -config["service_zipf_s"]
                         for name in config["services"]],
                        dtype=torch.float64)


def draw(config: dict, seed: int, device, split: int = 0) -> dict:
    """One split's raw spans, on `device`: `ts` start times in ms,
    `duration` in ms, `service` codes into `services`."""
    n = config["docs_per_split"]
    gen = common.generator(seed, f"otel/{split}", device)
    ts = torch.sort(torch.randint(0, config["span_seconds"] * 1000, (n,),
                                  generator=gen, device=device)).values
    ts = ts + config["start_ts"] * 1000
    mu, sigma = config["duration_lognormal_us"]
    normal = torch.randn(n, generator=gen, device=device,
                         dtype=torch.float64) * sigma + mu
    duration = torch.div(torch.exp(normal).to(torch.int64), 1000,
                         rounding_mode="floor")
    service = torch.multinomial(service_weights(config).to(device), n,
                                replacement=True,
                                generator=gen).to(torch.int8)
    return {"ts": ts, "duration": duration, "service": service}


def build(config: dict, raw: dict) -> tuple[bytes, dict]:
    """One split's bytes, and its metastore facts."""
    mapper = common.doc_mapper(config)
    n = raw["ts"].shape[0]
    n_pad = pad_to(n, DOC_PAD)
    builder = SplitFileBuilder()
    fm = {f.name: f for f in mapper.field_mappings}
    fields = {"service_name": common.categorical_field(
        builder, fm["service_name"], config["services"], raw["service"],
        n_pad)}
    ts_us = raw["ts"].cpu().numpy() * config["raw_time_unit_us"]
    fields["span_start_timestamp_nanos"] = common.numeric_column(
        builder, fm["span_start_timestamp_nanos"], ts_us, n_pad)
    duration = raw["duration"].cpu().numpy()
    fields["span_duration_millis"] = common.numeric_column(
        builder, fm["span_duration_millis"], duration, n_pad)
    common.empty_doc_store(builder)
    time_range = (int(ts_us[0]), int(ts_us[-1]))
    split = common.finish(builder, mapper, fields, n, time_range, 0)
    facts = {"num_docs": n, "time_range": time_range,
             "column_bounds": {"span_duration_millis": (
                 int(duration.min()), int(duration.max()))}}
    return split, facts
