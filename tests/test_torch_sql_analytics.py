"""The port's SQL analytics (quickwit_tpu_torch/analytics/sql.py and the
`POST /api/v1/_sql` route of serve/rest.py) against the JAX package's,
over every SQL statement of `tests/test_sql_analytics.py` (read from that
file, so a statement added there is held here too).

`parse_sql` must give the same tree in both packages, or the same
`SqlError`. A JAX node and a port node (the harness of
`tests/test_torch_rest_api.py`: each behind its own `RestServer`, under
deterministic clocks and uuids) hold the same indexes and documents as
that file's two fixtures; every statement sent to both must get the same
status and the same JSON answer. The fixtures' numbers are integral, so
SQL aggregates (sums, averages, variances) are compared exactly.
"""

import ast
import dataclasses
import enum
import json
import pathlib
import re

import pytest

from quickwit_tpu.analytics import SqlError as JSqlError, parse_sql as j_parse

from quickwit_tpu_torch.analytics import (
    SqlError as TSqlError, parse_sql as t_parse,
)

import test_sql_analytics as jsql
from test_torch_rest_api import pair_of_nodes


def _statements() -> list[str]:
    """Every SELECT string literal of tests/test_sql_analytics.py, in
    order, once each."""
    source = pathlib.Path(jsql.__file__).read_text()
    out: list[str] = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and re.match(r"\s*select\b", node.value, re.IGNORECASE) \
                and node.value not in out:
            out.append(node.value)
    return out


STATEMENTS = _statements()


def tree(value):
    """A package-neutral form of a parsed statement: dataclasses by class
    name and fields, enums by class name and value."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: tree(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.value)
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [tree(v) for v in value])
    if isinstance(value, dict):
        return {k: tree(v) for k, v in value.items()}
    if isinstance(value, (set, frozenset)):
        return ("set", sorted(repr(tree(v)) for v in value))
    return value


def _parse(parse, error, statement):
    try:
        return "ok", tree(parse(statement))
    except error as exc:
        return "SqlError", str(exc)


def test_statements_were_found():
    assert len(STATEMENTS) >= 50


@pytest.mark.parametrize("idx", range(len(STATEMENTS)))
def test_parse_sql_matches_jax(idx):
    statement = STATEMENTS[idx]
    assert _parse(t_parse, TSqlError, statement) == \
        _parse(j_parse, JSqlError, statement)


TS = {"name": "ts", "type": "datetime", "fast": True,
      "input_formats": ["unix_timestamp"]}
RAW = {"type": "text", "tokenizer": "raw", "fast": True}


@pytest.fixture(scope="module")
def pair():
    """Both packages' nodes holding `metrics` (the `api` fixture of
    tests/test_sql_analytics.py) and `orders` / `users` (its `rel_api`)."""
    with pair_of_nodes(node_id="sql-node",
                       metastore_uri="ram:///sql/metastore",
                       default_index_root_uri="ram:///sql/indexes") as pair:
        indexes = {
            "metrics": ({"field_mappings": [
                TS, {"name": "service", **RAW},
                {"name": "latency", "type": "f64", "fast": True},
                {"name": "status", "type": "u64", "fast": True},
                {"name": "body", "type": "text"}],
                "timestamp_field": "ts",
                "default_search_fields": ["body"]}, jsql.DOCS),
            "orders": ({"field_mappings": [
                TS, {"name": "user", **RAW},
                {"name": "amount", "type": "f64", "fast": True}],
                "timestamp_field": "ts"},
                [{"ts": 100 + i, "user": f"u{i % 3}",
                  "amount": float(10 * (i + 1))} for i in range(9)]),
            "users": ({"field_mappings": [
                TS, {"name": "name", **RAW}, {"name": "tier", **RAW}],
                "timestamp_field": "ts"},
                [{"ts": 1, "name": "u0", "tier": "gold"},
                 {"ts": 2, "name": "u1", "tier": "silver"},
                 {"ts": 3, "name": "u2", "tier": "gold"}]),
        }
        for index_id, (mapping, docs) in indexes.items():
            status, _ = pair.request("POST", "/api/v1/indexes", {
                "index_id": index_id, "doc_mapping": mapping})
            assert status == 200
            ndjson = "\n".join(json.dumps(d) for d in docs).encode()
            status, result = pair.request(
                "POST", f"/api/v1/{index_id}/ingest?commit=force", ndjson)
            assert status == 200
            assert result["num_ingested_docs"] == len(docs)
        yield pair


ANSWERED: dict[int, int] = {}


@pytest.mark.parametrize("idx", range(len(STATEMENTS)))
def test_rest_sql_matches_jax(pair, idx):
    """Same status, same answer (the pair holds them equal)."""
    status, _ = pair.request("POST", "/api/v1/_sql",
                             {"query": STATEMENTS[idx]})
    assert status in (200, 400)
    ANSWERED[idx] = status


def test_known_answers_and_errors(pair):
    """A few answers of tests/test_sql_analytics.py by value on the
    port's node, and the errors as 400s in both nodes."""
    status, out = pair.request("POST", "/api/v1/_sql", {
        "query": "SELECT COUNT(*), SUM(latency) FROM metrics"})
    assert status == 200
    assert out["rows"] == [[60, sum(d["latency"] for d in jsql.DOCS)]]
    for bad in ({"query": "SELECT FROM logs"}, {"query": " "}, {},
                {"query": "SELECT latency FROM metrics GROUP BY service"}):
        status, err = pair.request("POST", "/api/v1/_sql", bad)
        assert status == 400, bad
    if len(ANSWERED) == len(STATEMENTS):   # the whole file ran
        assert sum(s == 200 for s in ANSWERED.values()) >= 30
