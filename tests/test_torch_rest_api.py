"""The port's REST front door against the JAX package's.

A JAX node and a port node (`device="cpu"`), each behind its own
`RestServer` on port 0, get the same requests; their answers must be
equal as parsed JSON. Both run under a `FakeClock` and a seeded RNG per
package, and the uuids that name indexes and scroll contexts come from a
seeded generator per package, so split ids, index uids, scroll ids and
timestamps are equal too. Each request first moves both fake clocks one
second on, as real time would: a v1 ingest names its checkpoint
partition by the clock, and two ingests at one instant would read as a
replay. Each package's writer runs on its
Python paths, so split bytes, and with them the metastore files, are
equal.

What is left out of a comparison, and why:
- `elapsed_time_micros`, and ES's `took` (the same clock in
  milliseconds): wall time of the request;
- the REST port each server bound (port 0 gives each its own), wherever
  a response names the node's endpoint;
- the bodies of `/api/v1/developer/debug` (threads and cache sizes of
  the process) and `/metrics` (each package has its own registry): the
  tests compare the debug route's keys and the deltas of the leaf
  cache's lookups.

Aggregation floats compare to rtol 1e-12, everything else exactly.

Carried over: the 33 tests of `tests/test_rest_api.py` and the 14
scenarios of `tests/test_golden_scenarios.py`, plus the metastore files
byte-identical after create, ingest and delete. This file imports
neither JAX nor the JAX package at module level: `Pair` and
`assert_same_json` serve `tests/test_torch_cuda_serve.py` on the card.
"""

import contextlib
import http.client
import importlib
import json
import math
import random
import uuid
from types import SimpleNamespace

import pytest

from test_torch_indexing import force_python_paths

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
SEED = 13

INDEX_CONFIG = {
    "index_id": "hdfs-logs",
    "doc_mapping": {
        "field_mappings": [
            {"name": "timestamp", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "severity_text", "type": "text", "tokenizer": "raw",
             "fast": True},
            {"name": "tenant_id", "type": "u64", "fast": True},
            {"name": "body", "type": "text", "record": "position"},
        ],
        "timestamp_field": "timestamp",
        "tag_fields": ["tenant_id"],
        "default_search_fields": ["body"],
    },
    "indexing_settings": {"split_num_docs_target": 1000},
}

DOCS = [
    {"timestamp": 1_600_000_000 + i, "severity_text": ["INFO", "ERROR"][i % 2],
     "tenant_id": i % 3, "body": f"log line {i} with shared tokens"}
    for i in range(100)
]

# keys whose values are the request's wall time
CLOCK_KEYS = ("elapsed_time_micros", "took")


def load(root):
    def mod(path):
        return importlib.import_module(f"{root}.{path}")
    return SimpleNamespace(
        root=root, is_port=root == "quickwit_tpu_torch", mod=mod,
        serve=mod("serve"), node=mod("serve.node"),
        http_client=mod("serve.http_client"), storage=mod("storage"),
        clock=mod("common.clock"), scroll=mod("search.scroll"))


def send(port, method, path, body=None, raw=False, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn.request(method, path, body=data, headers=headers or {})
    response = conn.getresponse()
    payload = response.read()
    conn.close()
    if raw:
        return response.status, payload
    return response.status, (json.loads(payload) if payload else None)


def strip(value, endpoints=()):
    """`value` without its wall-time keys, each of `endpoints` (a node's
    own `host:port`) written as `<rest>`."""
    if isinstance(value, dict):
        return {k: strip(v, endpoints) for k, v in value.items()
                if k not in CLOCK_KEYS}
    if isinstance(value, list):
        return [strip(v, endpoints) for v in value]
    if isinstance(value, str):
        for endpoint in endpoints:
            value = value.replace(endpoint, "<rest>")
    return value


def assert_same_json(want, got, path="$", agg=False):
    """Equal parsed JSON: floats under an `aggregations` key to rtol
    1e-12, everything else exactly (types included)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), (path, want, got)
        assert sorted(got) == sorted(want), (path, sorted(want), sorted(got))
        for key in want:
            assert_same_json(want[key], got[key], f"{path}.{key}",
                             agg or key == "aggregations")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (path, want, got)
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_json(w, g, f"{path}[{i}]", agg)
    elif isinstance(want, float) and agg:
        assert isinstance(got, float), (path, want, got)
        if math.isnan(want):
            assert math.isnan(got), (path, want, got)
        else:
            assert got == pytest.approx(want, rel=1e-12, abs=0), \
                (path, want, got)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


class _SeededUuid:
    """Stands in for the `uuid` module in a node's modules: `uuid4()`
    from a seeded RNG, so that index uids and scroll ids are the same in
    both packages."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def uuid4(self):
        return uuid.UUID(int=self._rng.getrandbits(128), version=4)


class Side:
    """One package's node behind its `RestServer`."""

    def __init__(self, q, node, server, resolver, clock):
        self.q, self.node, self.server = q, node, server
        self.resolver, self.clock = resolver, clock

    @property
    def port(self):
        return self.server.port

    def request(self, method, path, body=None, raw=False, headers=None):
        return send(self.port, method, path, body, raw, headers)


@contextlib.contextmanager
def deterministic(mp, q, seed=SEED, fake_clock=True):
    """`q`'s RNG and uuids, and unless `fake_clock` is false its clock,
    made deterministic for the block; yields the clock."""
    uuids = _SeededUuid(seed + 1)
    for module in (q.node, q.scroll):
        mp.setattr(module, "uuid", uuids)
    clock = q.clock.FakeClock() if fake_clock else q.clock.get_clock()
    with q.clock.use_clock(clock), q.clock.use_rng(random.Random(seed)):
        yield clock


class Pair:
    """A JAX node and a port node over the same config, each behind its
    own `RestServer` on port 0 and over its own package's storage
    resolver. `request` sends a request to both and holds the answers
    equal; it returns the port's."""

    def __init__(self, sides):
        self.jax, self.port_side = sides
        self.sides = sides

    def endpoints(self):
        return [f"127.0.0.1:{s.port}" for s in self.sides]

    def request(self, method, path, body=None, raw=False, compare=True,
                headers=None):
        self.tick()
        want = self.jax.request(method, path, body, raw, headers)
        got = self.port_side.request(method, path, body, raw, headers)
        assert got[0] == want[0], (path, want, got)
        if compare:
            if raw:
                assert got[1] == want[1], path
            else:
                assert_same_json(strip(want[1], self.endpoints()),
                                 strip(got[1], self.endpoints()))
        return got

    def tick(self, secs=1.0):
        for side in self.sides:
            side.clock.advance(secs)

    def both(self, fn):
        """`fn(node)` on each node; the results must be equal. Returns
        the port's."""
        want, got = (fn(side.node) for side in self.sides)
        assert got == want
        return got

    def files(self, uri):
        """The files under `uri` in each package's resolver, equal."""
        out = []
        for side in self.sides:
            storage = side.resolver.resolve(uri)
            out.append({p: storage.get_all(p) for p in storage.list_files()})
        assert out[1] == out[0], (sorted(out[0]), sorted(out[1]))
        return out[1]


@contextlib.contextmanager
def pair_of_nodes(seed=SEED, data_dir=None, resolvers=None, **config):
    """A `Pair` over `NodeConfig(rest_port=0, **config)` in each package
    (the port's on `device="cpu"`), under deterministic clocks; stops
    both servers and their nodes' threads on exit."""
    sides = []
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        force_python_paths(mp)
        try:
            for root in PACKAGES:
                q = load(root)
                clock = stack.enter_context(deterministic(mp, q, seed))
                resolver = (resolvers[root] if resolvers
                            else q.storage.StorageResolver.for_test())
                extra = {"device": "cpu"} if q.is_port else {}
                if data_dir is not None:
                    extra["data_dir"] = str(data_dir / root)
                node = q.serve.Node(
                    q.serve.NodeConfig(rest_port=0, **config, **extra),
                    storage_resolver=resolver)
                server = q.serve.RestServer(node)
                server.start()
                sides.append(Side(q, node, server, resolver, clock))
            yield Pair(sides)
        finally:
            for side in sides:
                side.server.stop()
                side.node.stop_background_services()


@pytest.fixture(scope="module")
def api():
    with pair_of_nodes(node_id="rest-node",
                       metastore_uri="ram:///rest/metastore",
                       default_index_root_uri="ram:///rest/indexes") as pair:
        status, _ = pair.request("POST", "/api/v1/indexes", INDEX_CONFIG)
        assert status == 200
        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        status, result = pair.request(
            "POST", "/api/v1/hdfs-logs/ingest?commit=force", ndjson)
        assert status == 200 and result["num_ingested_docs"] == 100
        yield pair


def test_health_and_cluster(api):
    assert api.request("GET", "/health/livez") == (200, True)
    status, cluster = api.request("GET", "/api/v1/cluster")
    assert status == 200 and cluster["node_id"] == "rest-node"


def test_search_get(api):
    status, result = api.request(
        "GET", "/api/v1/hdfs-logs/search?query=severity_text:ERROR&max_hits=5")
    assert status == 200
    assert result["num_hits"] == 50
    assert len(result["hits"]) == 5
    assert result["hits"][0]["severity_text"] == "ERROR"


def test_search_post_with_aggs_and_sort(api):
    status, result = api.request("POST", "/api/v1/hdfs-logs/search", {
        "query": "severity_text:ERROR",
        "max_hits": 3,
        "sort_by": "-timestamp",
        "aggs": {"tenants": {"terms": {"field": "tenant_id"}}},
    })
    assert status == 200
    timestamps = [h["timestamp"] for h in result["hits"]]
    assert timestamps == sorted(timestamps, reverse=True)
    buckets = {b["key"]: b["doc_count"]
               for b in result["aggregations"]["tenants"]["buckets"]}
    expected = {}
    for i in range(1, 100, 2):
        expected[i % 3] = expected.get(i % 3, 0) + 1
    assert buckets == expected


def test_search_time_range(api):
    status, result = api.request(
        "GET", "/api/v1/hdfs-logs/search?query=*"
               f"&start_timestamp={1_600_000_000 + 10}"
               f"&end_timestamp={1_600_000_000 + 20}")
    assert status == 200
    assert result["num_hits"] == 10  # end exclusive


def test_search_bad_query_is_400(api):
    status, result = api.request("GET", "/api/v1/hdfs-logs/search?query=body:")
    assert status == 400
    assert "message" in result


def test_search_unknown_index_404ish(api):
    status, result = api.request("GET", "/api/v1/nope/search?query=*")
    assert status == 404 and "no index matches" in result["message"]


def test_splits_listing(api):
    status, result = api.request("GET", "/api/v1/indexes/hdfs-logs/splits")
    assert status == 200
    assert sum(s["metadata"]["num_docs"] for s in result["splits"]) == 100


def test_es_search(api):
    status, result = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "query": {"bool": {
            "must": [{"match": {"body": "shared"}}],
            "filter": [{"term": {"severity_text": "ERROR"}}],
        }},
        "size": 4,
    })
    assert status == 200
    assert result["hits"]["total"]["value"] == 50
    assert len(result["hits"]["hits"]) == 4
    hit = result["hits"]["hits"][0]
    assert hit["_source"]["severity_text"] == "ERROR"
    assert hit["_score"] is not None


def test_es_search_query_string_fallback(api):
    status, result = api.request(
        "GET", "/api/v1/_elastic/hdfs-logs/_search?q=severity_text:INFO&size=2")
    assert status == 200
    assert result["hits"]["total"]["value"] == 50


def test_es_msearch(api):
    body = (json.dumps({"index": "hdfs-logs"}) + "\n"
            + json.dumps({"query": {"term": {"severity_text": "ERROR"}},
                          "size": 1})
            + "\n" + json.dumps({"index": "hdfs-logs"}) + "\n"
            + json.dumps({"query": {"match_all": {}}, "size": 1})
            + "\n").encode()
    status, result = api.request("POST", "/api/v1/_elastic/_msearch", body)
    assert status == 200
    assert len(result["responses"]) == 2
    assert result["responses"][0]["hits"]["total"]["value"] == 50
    assert result["responses"][1]["hits"]["total"]["value"] == 100


def test_es_bulk_and_cat(api):
    bulk = (json.dumps({"index": {"_index": "hdfs-logs"}}) + "\n"
            + json.dumps({"timestamp": 1_600_001_000, "severity_text": "WARN",
                          "tenant_id": 9, "body": "bulk doc"}) + "\n").encode()
    status, result = api.request("POST", "/api/v1/_elastic/_bulk", bulk)
    assert status == 200 and result["errors"] is False
    # format=json is required (reference 400s on any other format)
    status, _ = api.request("GET", "/api/v1/_elastic/_cat/indices")
    assert status == 400
    status, result = api.request(
        "GET", "/api/v1/_elastic/_cat/indices?format=json")
    assert status == 200
    entry = next(e for e in result if e["index"] == "hdfs-logs")
    assert int(entry["docs.count"]) == 101


def test_es_field_caps(api):
    status, result = api.request("GET",
                                 "/api/v1/_elastic/hdfs-logs/_field_caps")
    assert status == 200
    assert result["fields"]["timestamp"]["date_nanos"]["aggregatable"] is True
    assert result["fields"]["body"]["text"]["searchable"] is True
    assert result["fields"]["body"]["keyword"]["searchable"] is True


def test_sorted_search_es_with_sort(api):
    status, result = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "query": {"match_all": {}},
        "sort": [{"timestamp": {"order": "desc"}}],
        "size": 3,
    })
    assert status == 200
    values = [h["sort"][0] for h in result["hits"]["hits"]]
    assert values == sorted(values, reverse=True)


def _counter_total(text, name):
    total = 0.0
    for line in text.decode().splitlines():
        if line.startswith(name) and not line.startswith("#"):
            total += float(line.rsplit(" ", 1)[1])
    return total


def test_metrics_exposition(api):
    # each package keeps its own registry, and other tests of this module
    # have counted into it: compare the deltas of the leaf cache's lookups,
    # which a search makes before it answers
    def lookups(side):
        status, text = side.request("GET", "/metrics", raw=True)
        assert status == 200 and b"qw_http_requests_total" in text
        return sum(_counter_total(text, name) for name in (
            "qw_leaf_cache_hits_total", "qw_leaf_cache_misses_total"))
    before = [lookups(side) for side in api.sides]
    api.request("GET", "/api/v1/hdfs-logs/search?query=tenant_id:2"
                       "&max_hits=1")
    deltas = [lookups(side) - base for side, base in zip(api.sides, before)]
    assert deltas[0] == deltas[1] > 0


def test_delete_index(api):
    api.request("POST", "/api/v1/indexes",
                {**INDEX_CONFIG, "index_id": "tmp-index"})
    api.request("POST", "/api/v1/tmp-index/ingest",
                json.dumps({"timestamp": 1, "body": "x"}).encode())
    status, result = api.request("DELETE", "/api/v1/indexes/tmp-index")
    assert status == 200
    status, _ = api.request("GET", "/api/v1/indexes/tmp-index")
    assert status == 404


def test_scroll_pagination(api):
    status, page1 = api.request(
        "GET", "/api/v1/hdfs-logs/search?query=*&max_hits=7&scroll=5m"
               "&sort_by=-timestamp")
    assert status == 200
    scroll_id = page1["scroll_id"]
    assert len(page1["hits"]) == 7
    seen = {json.dumps(h, sort_keys=True) for h in page1["hits"]}
    total = page1["num_hits"]
    fetched = len(page1["hits"])
    while True:
        status, page = api.request("GET",
                                   f"/api/v1/scroll?scroll_id={scroll_id}")
        assert status == 200
        if not page["hits"]:
            break
        for h in page["hits"]:
            key = json.dumps(h, sort_keys=True)
            assert key not in seen
            seen.add(key)
        fetched += len(page["hits"])
    assert fetched == total


def test_scroll_unknown_id(api):
    status, result = api.request("GET", "/api/v1/scroll?scroll_id=bogus")
    assert status == 400


def test_list_terms(api):
    status, result = api.request(
        "GET", "/api/v1/hdfs-logs/list-terms?field=severity_text")
    assert status == 200
    assert set(result["terms"]) >= {"ERROR", "INFO"}
    status, result = api.request(
        "GET", "/api/v1/hdfs-logs/list-terms?field=severity_text&start_key=I")
    assert "ERROR" not in result["terms"]
    status, _ = api.request("GET", "/api/v1/hdfs-logs/list-terms")
    assert status == 400


def test_list_fields(api):
    status, result = api.request("GET", "/api/v1/hdfs-log*/fields")
    assert status == 200
    by_name = {f["field_name"]: f for f in result["fields"]}
    assert by_name["timestamp"]["aggregatable"] is True
    assert by_name["body"]["searchable"] is True


def otlp_traces_payload():
    def span(tid, sid, name, start, dur):
        return {"traceId": tid, "spanId": sid, "name": name,
                "startTimeUnixNano": str(start * 10**9),
                "endTimeUnixNano": str(start * 10**9 + dur * 1000)}
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "frontend"}}]},
        "scopeSpans": [{"spans": [
            span("trace-aa", "s1", "GET /", 1_600_000_100, 5000),
            span("trace-aa", "s2", "db query", 1_600_000_100, 2000),
            span("trace-bb", "s3", "GET /", 1_600_000_200, 9000),
        ]}]}]}


OTLP_LOGS_PAYLOAD = {"resourceLogs": [{
    "resource": {"attributes": [
        {"key": "service.name", "value": {"stringValue": "frontend"}}]},
    "scopeLogs": [{"logRecords": [
        {"timeUnixNano": str(1_600_000_100 * 10**9),
         "severityText": "ERROR",
         "body": {"stringValue": "connection refused"}}]}]}]}


def check_otlp_and_jaeger(api):
    """OTLP JSON ingest of traces and logs, then the Jaeger routes."""
    status, result = api.request("POST", "/api/v1/otlp/v1/traces",
                                 otlp_traces_payload())
    assert status == 200 and result["num_ingested_docs"] == 3
    status, services = api.request("GET", "/api/v1/jaeger/api/services")
    assert "frontend" in services["data"]
    status, ops = api.request(
        "GET", "/api/v1/jaeger/api/services/frontend/operations")
    assert set(ops["data"]) == {"GET /", "db query"}
    status, trace = api.request("GET", "/api/v1/jaeger/api/traces/trace-aa")
    assert status == 200 and len(trace["data"][0]["spans"]) == 2
    status, found = api.request(
        "GET", "/api/v1/jaeger/api/traces?service=frontend&limit=5")
    assert {t["traceID"] for t in found["data"]} == {"trace-aa", "trace-bb"}
    status, _ = api.request("GET", "/api/v1/jaeger/api/traces/nope")
    assert status == 404
    status, result = api.request("POST", "/api/v1/otlp/v1/logs",
                                 OTLP_LOGS_PAYLOAD)
    assert status == 200 and result["num_ingested_docs"] == 1
    status, search = api.request(
        "GET", "/api/v1/otel-logs-v0/search?query=severity_text:ERROR")
    assert search["num_hits"] == 1


def test_otlp_and_jaeger(api):
    check_otlp_and_jaeger(api)


def test_wal_ingest_endpoint(api):
    docs = "\n".join(json.dumps(
        {"timestamp": 1_600_009_000 + i, "severity_text": "DEBUG",
         "tenant_id": 1, "body": "walflow doc"}) for i in range(5)).encode()
    status, result = api.request(
        "POST", "/api/v1/hdfs-logs/ingest?commit=wal", docs)
    assert status == 200
    assert result["num_docs"] == 5


def test_scroll_deep_pagination_past_window(api, monkeypatch):
    """Scrolling past the cache window refills via search_after pushdown
    and returns every hit exactly once."""
    for side in api.sides:
        monkeypatch.setattr(side.q.scroll, "CACHE_WINDOW", 30)
    status, page = api.request(
        "GET", "/api/v1/hdfs-logs/search?query=*&max_hits=12&scroll=1m"
               "&sort_by=-timestamp")
    assert status == 200
    total = page["num_hits"]
    assert total > 60  # corpus is > 2x the shrunken window
    scroll_id = page["scroll_id"]
    seen = [h["timestamp"] for h in page["hits"]]
    while True:
        status, page = api.request("GET",
                                   f"/api/v1/scroll?scroll_id={scroll_id}")
        assert status == 200
        if not page["hits"]:
            break
        seen.extend(h["timestamp"] for h in page["hits"])
    assert len(seen) == total
    assert len(set(seen)) == total  # no duplicates, no gaps


def test_index_templates_auto_create(api):
    template = {
        "template_id": "logs-template",
        "index_id_patterns": ["applogs-*"],
        "priority": 10,
        "index_config": {
            "doc_mapping": {
                "field_mappings": [
                    {"name": "ts", "type": "datetime", "fast": True,
                     "input_formats": ["unix_timestamp"]},
                    {"name": "body", "type": "text"},
                ],
                "timestamp_field": "ts",
                "default_search_fields": ["body"],
            },
        },
    }
    status, _ = api.request("POST", "/api/v1/templates", template)
    assert status == 200
    status, templates = api.request("GET", "/api/v1/templates")
    assert any(t["template_id"] == "logs-template" for t in templates)
    doc = json.dumps({"ts": 1_600_000_000, "body": "templated doc"}).encode()
    status, result = api.request("POST", "/api/v1/applogs-web/ingest", doc)
    assert status == 200 and result["num_ingested_docs"] == 1
    status, result = api.request(
        "GET", "/api/v1/applogs-web/search?query=templated")
    assert result["num_hits"] == 1
    status, _ = api.request("POST", "/api/v1/otherlogs/ingest", doc)
    assert status == 404
    status, _ = api.request("DELETE", "/api/v1/templates/logs-template")
    assert status == 200
    status, _ = api.request("POST", "/api/v1/applogs-db/ingest", doc)
    assert status == 404


def test_developer_debug_endpoint(api):
    # threads and cache sizes are the process's own: compare the keys
    status, debug = api.request("GET", "/api/v1/developer/debug",
                                compare=False)
    assert status == 200
    assert debug["node_id"] == "rest-node"
    assert "jit_cache_entries" in debug
    assert "threads" in debug and debug["threads"]
    _, jax_debug = api.jax.request("GET", "/api/v1/developer/debug")
    assert sorted(debug) == sorted(jax_debug)


def test_clear_scroll(api):
    status, page = api.request(
        "GET", "/api/v1/hdfs-logs/search?query=*&max_hits=5&scroll=1m")
    scroll_id = page["scroll_id"]
    status, result = api.request("DELETE",
                                 f"/api/v1/scroll?scroll_id={scroll_id}")
    assert status == 200 and result["released"] is True
    status, _ = api.request("GET", f"/api/v1/scroll?scroll_id={scroll_id}")
    assert status == 400  # context gone


def test_es_two_field_sort(api):
    status, result = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "query": {"match_all": {}},
        "sort": [{"tenant_id": {"order": "asc"}},
                 {"timestamp": {"order": "desc"}}],
        "size": 6,
    })
    assert status == 200
    rows = [(h["_source"]["tenant_id"], h["_source"]["timestamp"])
            for h in result["hits"]["hits"]]
    assert rows == sorted(rows, key=lambda r: (r[0], -r[1]))
    first_sort = result["hits"]["hits"][0]["sort"]
    assert len(first_sort) == 3 and "|" in first_sort[2]


def test_source_crud_and_transform(api):
    """Source routes + the transform applied on the WAL drain."""
    client = api
    client.request("POST", "/api/v1/indexes", {
        "index_id": "tx-logs",
        "doc_mapping": {
            "field_mappings": [
                {"name": "level", "type": "text", "tokenizer": "raw",
                 "fast": True},
                {"name": "body", "type": "text"}],
            "default_search_fields": ["body"]}})
    status, source = client.request(
        "POST", "/api/v1/indexes/tx-logs/sources", {
            "source_id": "_ingest-source", "source_type": "ingest",
            "params": {"transform": {"script":
                'if .severity == "debug" { drop() }\n'
                '.level = uppercase(string(.severity))\ndel(.severity)'}}})
    assert status == 200 and source["source_id"] == "_ingest-source"
    ndjson = "\n".join(json.dumps(d) for d in [
        {"severity": "warn", "body": "tx keep"},
        {"severity": "debug", "body": "tx drop"}]).encode()
    status, _ = client.request("POST", "/api/v1/tx-logs/ingest?commit=wal",
                               ndjson)
    assert status == 200
    stats = api.both(lambda node: node.run_ingest_pass("tx-logs"))
    assert stats["num_docs_indexed"] == 1
    status, result = client.request("GET",
                                    "/api/v1/tx-logs/search?query=level:WARN")
    assert status == 200 and result["num_hits"] == 1
    status, err = client.request("POST", "/api/v1/indexes/tx-logs/sources", {
        "source_id": "bad", "params": {"transform": {"script": ".x = ("}}})
    assert status == 400
    status, out = client.request(
        "PUT", "/api/v1/indexes/tx-logs/sources/_ingest-source/toggle",
        {"enable": False})
    assert status == 200 and out["enabled"] is False
    stats = api.both(lambda node: node.run_ingest_pass("tx-logs"))
    assert stats.get("source_disabled") is True
    client.request(
        "PUT", "/api/v1/indexes/tx-logs/sources/_ingest-source/toggle",
        {"enable": True})
    status, err = client.request(
        "DELETE", "/api/v1/indexes/tx-logs/sources/_ingest-source")
    assert status == 400 and "internal" in err["message"]
    client.request("POST", "/api/v1/indexes/tx-logs/sources",
                   {"source_id": "user-src", "source_type": "vec"})
    status, out = client.request(
        "DELETE", "/api/v1/indexes/tx-logs/sources/user-src")
    assert status == 200
    status, _ = client.request(
        "PUT", "/api/v1/indexes/tx-logs/sources/_ingest-source/toggle",
        b"true")
    assert status == 400
    status, _ = client.request("POST", "/api/v1/indexes/tx-logs/sources",
                               b"[1]")
    assert status == 400


def test_disabled_ingest_api_source_rejects_v1_ingest(api):
    client = api
    client.request("POST", "/api/v1/indexes", {
        "index_id": "togglev1",
        "doc_mapping": {"field_mappings": [{"name": "body", "type": "text"}],
                        "default_search_fields": ["body"]}})
    status, out = client.request(
        "PUT", "/api/v1/indexes/togglev1/sources/_ingest-api-source/toggle",
        {"enable": False})
    assert status == 200
    status, err = client.request("POST", "/api/v1/togglev1/ingest",
                                 b'{"body": "x"}')
    assert status == 409 and "disabled" in err["message"]
    client.request(
        "PUT", "/api/v1/indexes/togglev1/sources/_ingest-api-source/toggle",
        {"enable": True})
    status, result = client.request("POST", "/api/v1/togglev1/ingest",
                                    b'{"body": "x"}')
    assert status == 200 and result["num_ingested_docs"] == 1


def test_es_search_after_pagination(api):
    seen = []
    marker = None
    for _ in range(50):
        body = {"query": {"query_string": {"query": "shared"}}, "size": 17,
                "sort": [{"timestamp": {"order": "desc"}}]}
        if marker is not None:
            body["search_after"] = marker
        status, result = api.request(
            "POST", "/api/v1/_elastic/hdfs-logs/_search", body)
        assert status == 200
        page = result["hits"]["hits"]
        if not page:
            break
        seen.extend(h["_source"]["timestamp"] for h in page)
        marker = page[-1]["sort"]
    assert len(seen) == len(set(seen)) == 100
    assert seen == sorted(seen, reverse=True)
    status, first = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "size": 3, "sort": [{"timestamp": {"order": "desc"}}],
        "query": {"query_string": {"query": "shared"}}})
    third_sort_value = first["hits"]["hits"][2]["sort"][0]
    status, result = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "size": 2, "sort": [{"timestamp": {"order": "desc"}}],
        "search_after": [third_sort_value]})
    assert status == 200
    assert [h["_source"]["timestamp"]
            for h in result["hits"]["hits"]] == [seen[3], seen[4]]
    status, err = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search", {
        "size": 2, "sort": [{"timestamp": {"order": "desc"}}],
        "search_after": [1, 2, 3, "x", 5]})
    assert status == 400 and "sort array" in err["message"]


def test_es_search_after_guards(api):
    base = {"size": 2, "sort": [{"timestamp": {"order": "desc"}}]}
    status, err = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search",
                              {**base, "search_after": 5})
    assert status == 400 and "array" in err["message"]
    status, err = api.request("POST", "/api/v1/_elastic/hdfs-logs/_search",
                              {**base, "search_after": {"a": 1}})
    assert status == 400
    status, err = api.request(
        "POST", "/api/v1/_elastic/hdfs-logs/_search",
        {**base, "from": 10, "search_after": [1, "s|1"]})
    assert status == 400 and "from" in err["message"]


def test_search_index_patterns_and_lists(api):
    for iid in ("pat-a", "pat-b"):
        api.request("POST", "/api/v1/indexes", {
            "index_id": iid, "doc_mapping": {
                "field_mappings": [{"name": "body", "type": "text"}],
                "default_search_fields": ["body"]}})
        api.request("POST", f"/api/v1/{iid}/ingest",
                    json.dumps({"body": f"patdoc {iid}"}).encode())
    status, result = api.request("GET",
                                 "/api/v1/pat-a,pat-b/search?query=patdoc")
    assert status == 200 and result["num_hits"] == 2
    status, result = api.request("GET", "/api/v1/pat-*/search?query=patdoc")
    assert status == 200 and result["num_hits"] == 2
    status, result = api.request("GET", "/api/v1/zzz-*/search?query=patdoc")
    assert status == 404 and "no index matches" in result["message"]


def test_es_search_after_string_sort(api):
    seen = []
    marker = None
    for _ in range(50):
        body = {"query": {"match_all": {}}, "size": 7,
                "sort": [{"severity_text": {"order": "asc"}}]}
        if marker is not None:
            body["search_after"] = marker
        status, result = api.request(
            "POST", "/api/v1/_elastic/hdfs-logs/_search", body)
        assert status == 200, result
        page = result["hits"]["hits"]
        if not page:
            break
        seen.extend(h["_source"]["severity_text"] for h in page)
        marker = page[-1]["sort"]
    assert len(seen) >= 100
    assert seen == sorted(seen)


def test_cancel_route_and_cancel_races_ahead(api):
    """`DELETE /api/v1/search/<query_id>` cancels by caller-chosen id; a
    DELETE that lands before the search runs is adopted by the root."""
    status, result = api.request("DELETE", "/api/v1/search/no-such-query")
    assert status == 200
    assert result == {"query_id": "no-such-query", "cancelled": False}
    qid = "rest-cancel-race"
    for side in api.sides:
        token = side.q.mod("common.deadline").CancellationToken()
        side.q.mod("search.cancel").CANCEL_REGISTRY.register(qid, token)
    status, result = api.request("DELETE", f"/api/v1/search/{qid}")
    assert status == 200 and result["cancelled"] is True
    status, result = api.request(
        "GET", f"/api/v1/hdfs-logs/search?query=*&query_id={qid}")
    assert status == 200
    assert result.get("cancelled") is True
    assert result["num_hits"] == 0 and result["hits"] == []
    status, result = api.request(
        "GET", f"/api/v1/hdfs-logs/search?query=*&query_id={qid}&max_hits=3")
    assert status == 200
    assert result.get("cancelled") is None and result["num_hits"] >= 100
    status, _ = api.request("GET", "/api/v1/search/anything")
    assert status != 200


@pytest.mark.parametrize("root", PACKAGES)
def test_rest_cancel_counts_each_delete_once(api, root):
    """`qw_search_cancel_total` counts each `DELETE /api/v1/search/<id>`
    once, live or unknown, in `root`'s node, and the two nodes' deltas are
    equal: the REST handler counts, the registry does not (the port's
    registry used to count a live cancel a second time)."""
    deltas = {}
    for side in api.sides:
        counter = side.q.mod("observability.metrics").SEARCH_CANCEL_TOTAL
        live = f"cancel-count-{root}"
        side.q.mod("search.cancel").CANCEL_REGISTRY.register(
            live, side.q.mod("common.deadline").CancellationToken())
        out = []
        for qid in (live, f"cancel-count-{root}-unknown"):
            before = counter.get()
            status, body = side.server._route_inner(
                "DELETE", f"/api/v1/search/{qid}", {}, b"")
            out.append((status, body["cancelled"], counter.get() - before))
        deltas[side.q.root] = out
    assert deltas[root] == [(200, True, 1), (200, False, 1)]
    assert deltas["quickwit_tpu_torch"] == deltas["quickwit_tpu"]


# --- the golden scenarios (tests/test_golden_scenarios.py) -----------------

def subset_match(expected, actual, path="$"):
    """expected ⊆ actual, recursively (lists compare element-wise)."""
    if isinstance(expected, dict):
        assert isinstance(actual, dict), f"{path}: {actual!r}"
        for key, value in expected.items():
            assert key in actual, f"{path}.{key} missing in {actual!r}"
            subset_match(value, actual[key], f"{path}.{key}")
    elif isinstance(expected, list):
        assert isinstance(actual, list) and len(actual) == len(expected), \
            f"{path}: expected {expected!r}, got {actual!r}"
        for i, (e, a) in enumerate(zip(expected, actual)):
            subset_match(e, a, f"{path}[{i}]")
    elif isinstance(expected, float):
        assert actual == pytest.approx(expected, rel=1e-6), path
    else:
        assert actual == expected, f"{path}: {actual!r} != {expected!r}"


@pytest.fixture(scope="module")
def golden():
    with pair_of_nodes(node_id="golden", metastore_uri="ram:///golden/ms",
                       default_index_root_uri="ram:///golden/idx") as pair:
        status, _ = pair.request("POST", "/api/v1/indexes", {
            "index_id": "g-logs",
            "doc_mapping": {
                "field_mappings": [
                    {"name": "ts", "type": "datetime", "fast": True,
                     "input_formats": ["unix_timestamp"]},
                    {"name": "level", "type": "text", "tokenizer": "raw",
                     "fast": True},
                    {"name": "size", "type": "i64", "fast": True},
                    {"name": "msg", "type": "text", "record": "position"},
                ],
                "timestamp_field": "ts",
                "tag_fields": ["level"],
                "default_search_fields": ["msg"],
            },
            "indexing_settings": {"split_num_docs_target": 40},
        })
        assert status == 200
        docs = [{"ts": 1_700_000_000 + i * 30,
                 "level": ["INFO", "WARN", "ERROR"][i % 3],
                 "size": (i * 7) % 100,
                 "msg": f"request {i} handled in zone{i % 4}"}
                for i in range(100)]
        ndjson = "\n".join(json.dumps(d) for d in docs).encode()
        status, result = pair.request(
            "POST", "/api/v1/g-logs/ingest?commit=force", ndjson)
        assert status == 200 and result["num_ingested_docs"] == 100
        yield pair


SCENARIOS = [
    ("GET", "/api/v1/g-logs/search?query=level:ERROR&max_hits=0", None,
     {"num_hits": 33}),
    ("GET", "/api/v1/g-logs/search?query=zone1&max_hits=0", None,
     {"num_hits": 25}),
    ("GET", "/api/v1/g-logs/search?query=level:ERROR+AND+zone1&max_hits=0",
     None, {"num_hits": 8}),
    ("GET", "/api/v1/g-logs/search?query=size:[90+TO+99]&max_hits=0", None,
     {"num_hits": 10}),
    ("GET", "/api/v1/g-logs/search?query=*&max_hits=2&sort_by=-ts", None,
     {"hits": [{"ts": 1_700_000_000 + 99 * 30},
               {"ts": 1_700_000_000 + 98 * 30}]}),
    ("GET",
     "/api/v1/g-logs/search?query=*&max_hits=2&sort_by=ts&sort_order=asc",
     None, {"hits": [{"ts": 1_700_000_000}, {"ts": 1_700_000_030}]}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"match_all": {}}, "size": 0},
     {"hits": {"total": {"value": 100, "relation": "eq"}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"term": {"level": "WARN"}}, "size": 1},
     {"hits": {"total": {"value": 33}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"match_phrase": {"msg": "request 42 handled"}}, "size": 1},
     {"hits": {"total": {"value": 1}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"range": {"size": {"gte": 50, "lt": 60}}}, "size": 0},
     {"hits": {"total": {"value": 10}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"bool": {"must": [{"term": {"level": "INFO"}}],
                         "must_not": [{"match": {"msg": "zone0"}}]}},
      "size": 0},
     {"hits": {"total": {"value": 25}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"match_all": {}}, "size": 0, "track_total_hits": False},
     {"hits": {"total": {"relation": "gte"}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"match_all": {}}, "size": 0,
      "aggs": {"levels": {"terms": {"field": "level", "size": 3}}}},
     {"aggregations": {"levels": {"buckets": [
         {"key": "INFO", "doc_count": 34},
         {"key": "ERROR", "doc_count": 33},
         {"key": "WARN", "doc_count": 33}]}}}),
    ("POST", "/api/v1/_elastic/g-logs/_search",
     {"query": {"match_all": {}}, "size": 0,
      "aggs": {"sz": {"stats": {"field": "size"}}}},
     {"aggregations": {"sz": {"count": 100, "min": 0.0, "max": 99.0}}}),
]


@pytest.mark.parametrize("method,path,body,expected", SCENARIOS,
                         ids=[f"{i}:{s[1][:48]}"
                              for i, s in enumerate(SCENARIOS)])
def test_golden_scenario(golden, method, path, body, expected):
    status, response = golden.request(method, path, body)
    assert status == 200, response
    subset_match(expected, response)


# --- the metastore files ---------------------------------------------------

def test_metastore_files_equal_after_create_ingest_delete():
    with pair_of_nodes(node_id="ms-node", metastore_uri="ram:///ms/metastore",
                       default_index_root_uri="ram:///ms/indexes") as pair:
        assert pair.request("POST", "/api/v1/indexes", INDEX_CONFIG)[0] == 200
        created = pair.files("ram:///ms/metastore")
        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        assert pair.request("POST", "/api/v1/hdfs-logs/ingest?commit=force",
                            ndjson)[0] == 200
        ingested = pair.files("ram:///ms/metastore")
        assert ingested != created
        splits = pair.files("ram:///ms/indexes/hdfs-logs")
        assert len(splits) == 1
        assert pair.request("DELETE",
                            "/api/v1/indexes/hdfs-logs")[0] == 200
        assert pair.files("ram:///ms/metastore") != ingested
        assert pair.files("ram:///ms/indexes/hdfs-logs") == {}
