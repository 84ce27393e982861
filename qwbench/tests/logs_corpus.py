"""A small log-search deployment defined in the tests alone, as a later
deployment would add its files: a corpus kind (this module, registered as
`qwbench.corpus.test_logs` by `registered`), its deployment (`CONFIG`)
and a Poisson mix that draws query terms (`MIX`). Logs of hdfs-logs'
shape: a timestamp in seconds, an indexed u64 `tenant_id`, a raw
`severity_text` and a default-tokenized `body` whose words follow a Zipf
law over a 500-word vocabulary, with a doc store to fetch from."""

from __future__ import annotations

import copy
import sys

import torch

from qwbench.corpus import common
from quickwit_tpu_torch.index.format import DOC_PAD, SplitFileBuilder, pad_to

NAME = "test_logs"

CONFIG = {
    "name": "test-logs-3x2k",
    "corpus": NAME,
    "index_id": "test-logs",
    "splits": 3,
    "docs_per_split": 2000,
    "start_ts": 1700000000,
    "span_seconds": 3600,
    "raw_time_unit_us": 1_000_000,
    "tenants": 10,
    "severities": ["DEBUG", "ERROR", "INFO", "WARN"],
    "severity_p": [0.30, 0.10, 0.45, 0.15],
    # "t0", "t1", "t10", "t100", ...: byte order is not rank order
    "body_words": {"format": "t{}", "size": 500},
    "body_zipf_s": 1.1,
    "body_tokens": [3, 24],
    "doc_mapping": {
        "field_mappings": [
            {"name": "timestamp", "type": "datetime", "fast": True,
             "indexed": False, "input_formats": ["unix_timestamp"],
             "fast_precision": "seconds"},
            {"name": "tenant_id", "type": "u64", "fast": True},
            {"name": "severity_text", "type": "text", "tokenizer": "raw",
             "fast": True},
            {"name": "body", "type": "text", "tokenizer": "default"}],
        "timestamp_field": "timestamp",
        "default_search_fields": ["body"]},
    "raw_columns": {"timestamp": "ts", "tenant_id": "tenant",
                    "severity_text": "severity", "body": "body"},
    "raw_vocab": {"severity_text": "severities", "body": "body_words"},
    "node": {},
    "check": {"control_dtype": "float16", "sample": 24,
              "limits": {"count_wrong": 0, "agg_gap": 1e-9,
                         "score_gap": 1e-5}},
}

# a log explorer's searches: Poisson arrivals of full-text queries with
# drawn terms, newest-first tails of a tenant, top hits by score
MIX = {"loop": "poisson", "rate_qps": 8.0,
       "warmup": {"per_kind": 1, "seconds": 0},
       "kinds": [
           {"name": "search_any", "weight": 0.4,
            "draws": {"q": {"law": "query_terms", "field": "body",
                            "count": [1, 3], "zipf_s": 1.1, "top": 200}},
            "request": {"query": {"match": {"body": "$q.text"}},
                        "max_hits": 10}},
           {"name": "search_all_in_range", "weight": 0.3,
            "draws": {"q": {"law": "query_terms", "field": "body",
                            "count": [2, 3], "zipf_s": 1.1, "top": 50},
                      "w": {"law": "time_range", "lengths_s": [900, 3600],
                            "align_s": 60}},
            "request": {"query": {"match": {"body": {
                "query": "$q.text", "operator": "and"}}},
                "max_hits": 100,
                "start_timestamp": "$w.from_us",
                "end_timestamp": "$w.to_us"}},
           {"name": "tail_of_tenant", "weight": 0.3,
            "request": {"query": {"bool": {
                "filter": [{"term": {"tenant_id": 3}}],
                "must_not": [{"term": {"severity_text": "DEBUG"}}]}},
                "max_hits": 20,
                "sort_by": [{"field": "timestamp", "order": "desc"}]}}]}


def config() -> dict:
    return copy.deepcopy(CONFIG)


def registered(monkeypatch) -> None:
    """Make this module the corpus kind the deployment names."""
    monkeypatch.setitem(sys.modules, f"qwbench.corpus.{NAME}",
                        sys.modules[__name__])


def words(config: dict) -> list[str]:
    spec = config["body_words"]
    return [spec["format"].format(i) for i in range(spec["size"])]


def term_name(config: dict, field: str, rank: int) -> str:
    """The body's word of frequency rank `rank` (word ids are ranks)."""
    if field != "body":
        raise KeyError(field)
    return words(config)[rank]


def draw(config: dict, seed: int, device, split: int = 0) -> dict:
    """One split's raw logs on `device`: `ts` (s, sorted), `tenant`,
    `severity` codes, `body_offsets` and `body_ids` (CSR word ids)."""
    n = config["docs_per_split"]
    gen = common.generator(seed, f"test_logs/{split}", device)
    ts = torch.sort(torch.randint(0, config["span_seconds"], (n,),
                                  generator=gen, device=device)).values
    tenant = torch.randint(0, config["tenants"], (n,), generator=gen,
                           device=device)
    severity = torch.multinomial(
        torch.tensor(config["severity_p"], device=device), n,
        replacement=True, generator=gen).to(torch.int8)
    least, most = config["body_tokens"]
    lengths = torch.randint(least, most + 1, (n,), generator=gen,
                            device=device)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lengths, 0)
    size = config["body_words"]["size"]
    zipf = (torch.arange(size, dtype=torch.float64, device=device)
            + 1.0) ** -config["body_zipf_s"]
    ids = torch.multinomial(zipf, int(offsets[-1]), replacement=True,
                            generator=gen).to(torch.int32)
    return {"ts": ts + config["start_ts"], "tenant": tenant,
            "severity": severity, "body_offsets": offsets, "body_ids": ids}


def documents(config: dict, raw: dict) -> list[dict]:
    """Every doc of a split as it was ingested."""
    vocab = words(config)
    offsets = raw["body_offsets"].tolist()
    ids = raw["body_ids"].tolist()
    return [{"timestamp": ts, "tenant_id": tenant,
             "severity_text": config["severities"][severity],
             "body": " ".join(vocab[t] for t in ids[offsets[i]:
                                                    offsets[i + 1]])}
            for i, (ts, tenant, severity) in enumerate(zip(
                raw["ts"].tolist(), raw["tenant"].tolist(),
                raw["severity"].tolist()))]


def document(config: dict, raw: dict, doc_id: int) -> dict:
    """One doc as it was ingested (and as the doc store holds it)."""
    a, b = raw["body_offsets"][doc_id:doc_id + 2].tolist()
    vocab = words(config)
    return {"timestamp": int(raw["ts"][doc_id]),
            "tenant_id": int(raw["tenant"][doc_id]),
            "severity_text": config["severities"][int(raw["severity"][
                doc_id])],
            "body": " ".join(vocab[t] for t in raw["body_ids"][a:b]
                             .tolist())}


def build(config: dict, raw: dict) -> tuple[bytes, dict]:
    """One split's bytes, and its metastore facts."""
    mapper = common.doc_mapper(config)
    fm = {f.name: f for f in mapper.field_mappings}
    n = raw["ts"].shape[0]
    n_pad = pad_to(n, DOC_PAD)
    builder = SplitFileBuilder()
    ts_us = raw["ts"].cpu().numpy() * config["raw_time_unit_us"]
    tenant = raw["tenant"].cpu().numpy()
    fields = {
        "timestamp": common.numeric_column(builder, fm["timestamp"], ts_us,
                                           n_pad),
        "tenant_id": common.numeric_terms(builder, fm["tenant_id"],
                                          raw["tenant"], n_pad),
        "severity_text": common.categorical_field(
            builder, fm["severity_text"], config["severities"],
            raw["severity"], n_pad),
        "body": common.text_field(builder, fm["body"], words(config),
                                  raw["body_offsets"], raw["body_ids"],
                                  n_pad)}
    fields["tenant_id"].update(common.numeric_column(
        builder, fm["tenant_id"], tenant, n_pad))
    cpu = {k: v.cpu() for k, v in raw.items()}
    stored = common.doc_store(builder, documents(config, cpu))
    time_range = (int(ts_us[0]), int(ts_us[-1]))
    split = common.finish(builder, mapper, fields, n, time_range, stored)
    facts = {"num_docs": n, "time_range": time_range,
             "column_bounds": {"tenant_id": (int(tenant.min()),
                                             int(tenant.max()))}}
    return split, facts
