"""The port's CLI, node config and Python client against the JAX package's.

Carried over: `tests/test_cli_config.py` (6), `tests/test_client.py` (4)
and `tests/test_index_update.py` (6). The CLI scenarios run the same
commands through each package's `cli.main`, each over its own `file://`
directory, under a `FakeClock`, a seeded RNG and seeded uuids per
package; what each command prints must be equal across the packages
once each package's directory is written as `<tmp>` (index and split
URIs name it). The client scenarios drive a JAX node and a port node
(`tests/test_torch_rest_api.py`'s `Pair`) through each package's own
`QuickwitClient`; every call must return equal results (minus wall
times) or raise equal `QuickwitError` statuses. One call differs on
purpose: `QuickwitClient.sql`, whose route answers 501 in the port until
the SQL engine is ported (ROADMAP item 14).

Then the port's own: `load_node_config` gives equal `NodeConfig` fields
in both packages for one file and environment (the port adds `device`),
`QW_DEVICE=cpu` reaches the node's `SearcherContext`, a node asked for
the GPU where there is none raises, `cli trace export` writes the flight
recorder from a running node and from the process, and
`python -m quickwit_tpu_torch.cli run` in a subprocess with
`QW_DEVICE=cpu` answers a search and exits 0 on SIGINT.
"""

import contextlib
import dataclasses
import inspect
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quickwit_tpu_torch.client import QuickwitError
from test_torch_rest_api import (PACKAGES, assert_same_json, deterministic,
                                 force_python_paths, load, pair_of_nodes,
                                 strip)

REPO = Path(__file__).resolve().parents[1]

INDEX_YAML = """
version: 0.8
index_id: cli-logs
doc_mapping:
  field_mappings:
    - name: ts
      type: datetime
      fast: true
      input_formats: [unix_timestamp]
    - name: body
      type: text
    - name: resource
      type: object
      field_mappings:
        - name: service
          type: text
          tokenizer: raw
  timestamp_field: ts
  default_search_fields: [body]
indexing_settings:
  split_num_docs_target: 100
"""


def config_mod(root):
    return load(root).mod("config.node_config")


@pytest.mark.parametrize("root", PACKAGES)
def test_interpolate_env(root):
    interpolate_env = config_mod(root).interpolate_env
    env = {"FOO": "bar"}
    assert interpolate_env("x-${FOO}-y", env) == "x-bar-y"
    assert interpolate_env("${MISSING:-default}", env) == "default"
    with pytest.raises(ValueError):
        interpolate_env("${MISSING}", env)


NODE_YAML = ("node_id: cfg-node\n"
             "metastore_uri: ${QW_TEST_MS:-ram:///cfg/ms}\n"
             "enabled_services: searcher,indexer\n"
             "rest:\n  listen_port: 9999\n")


@pytest.mark.parametrize("root", PACKAGES)
def test_load_node_config(root, tmp_path):
    load_node_config = config_mod(root).load_node_config
    config_path = tmp_path / "node.yaml"
    config_path.write_text(NODE_YAML)
    config = load_node_config(str(config_path), env={})
    assert config.node_id == "cfg-node"
    assert config.metastore_uri == "ram:///cfg/ms"
    assert config.roles == ("searcher", "indexer")
    assert config.rest_port == 9999
    config2 = load_node_config(str(config_path),
                               env={"QW_NODE_ID": "env-node"})
    assert config2.node_id == "env-node"


@pytest.mark.parametrize("root", PACKAGES)
def test_load_index_config_flattens_objects(root, tmp_path):
    path = tmp_path / "index.yaml"
    path.write_text(INDEX_YAML)
    config = config_mod(root).load_index_config(str(path))
    names = [f["name"] for f in config["doc_mapping"]["field_mappings"]]
    assert "resource.service" in names
    assert config["index_id"] == "cli-logs"


def write_cli_env(base):
    """The JAX test's files under `base`; the node yaml names the CPU
    (the JAX loader ignores the key)."""
    base.mkdir(parents=True, exist_ok=True)
    node_yaml = base / "node.yaml"
    node_yaml.write_text(
        f"node_id: cli-node\n"
        f"metastore_uri: file://{base}/metastore\n"
        f"default_index_root_uri: file://{base}/indexes\n"
        f"device: cpu\n")
    index_yaml = base / "index.yaml"
    index_yaml.write_text(INDEX_YAML)
    docs_path = base / "docs.ndjson"
    with open(docs_path, "w") as f:
        for i in range(250):
            f.write(json.dumps({
                "ts": 1_600_000_000 + i,
                "body": f"cli event {i}",
                "resource": {"service": ["web", "db"][i % 2]},
            }) + "\n")
    return str(node_yaml), str(index_yaml), str(docs_path), base


class Cli:
    """One package's `cli.main` over its own directory; `run` returns
    (exit code, stdout, stderr) and moves the fake clock one second on."""

    def __init__(self, q, env, capsys, clock):
        self.q, self.env, self.capsys, self.clock = q, env, capsys, clock
        self.main = q.mod("cli").main

    def run(self, *argv):
        self.clock.advance(1.0)
        self.capsys.readouterr()
        code = self.main(["--config", self.env[0], *argv])
        out = self.capsys.readouterr()
        return code, out.out, out.err


def cli_both(tmp_path, capsys, scenario):
    """`scenario(cli)` in each package; the lists of what each command
    printed must be equal with each package's directory as `<tmp>`."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        for root in PACKAGES:
            q = load(root)
            env = write_cli_env(tmp_path / root)
            with deterministic(mp, q) as clock:
                outputs = scenario(Cli(q, env, capsys, clock))
            got[root] = strip(outputs, [str(env[3])])
    assert_same_json(got["quickwit_tpu"], got["quickwit_tpu_torch"])
    return got["quickwit_tpu_torch"]


def parsed(result):
    code, out, err = result
    try:
        return [code, json.loads(out), err]
    except ValueError:
        return [code, out, err]


def test_cli_end_to_end(tmp_path, capsys):
    def scenario(cli):
        node_yaml, index_yaml, docs_path, base = cli.env
        seen = [parsed(cli.run("index", "create",
                               "--index-config", index_yaml))]
        code, out, _ = cli.run("index", "list")
        assert code == 0 and "cli-logs" in out
        seen.append(out)
        code, out, _ = cli.run("index", "ingest", "--index", "cli-logs",
                               "--input-path", docs_path)
        assert code == 0 and json.loads(out)["num_ingested_docs"] == 250
        seen.append(json.loads(out))
        code, out, _ = cli.run("index", "search", "--index", "cli-logs",
                               "--query", "resource.service:web",
                               "--max-hits", "3")
        assert code == 0 and json.loads(out)["num_hits"] == 125
        seen.append(json.loads(out))
        code, out, _ = cli.run("split", "list", "--index", "cli-logs")
        splits = json.loads(out)["splits"]
        assert sum(s["metadata"]["num_docs"] for s in splits) == 250
        assert len(splits) == 3
        seen.append(json.loads(out))
        seen.append(parsed(cli.run("index", "merge", "--index", "cli-logs")))
        code, out, _ = cli.run("index", "describe", "--index", "cli-logs")
        assert code == 0 and json.loads(out)["num_docs"] == 250
        seen.append(json.loads(out))
        out_dir = str(base / "extracted")
        split_id = splits[0]["metadata"]["split_id"]
        seen.append(parsed(cli.run("tool", "extract-split", "--index",
                                   "cli-logs", "--split", split_id,
                                   "--output-dir", out_dir)))
        assert seen[-1][0] == 0
        assert os.path.exists(os.path.join(out_dir, f"{split_id}.split"))
        seen.append(parsed(cli.run("index", "delete", "--index",
                                   "cli-logs")))
        assert seen[-1][0] == 0
        return seen
    cli_both(tmp_path, capsys, scenario)


def test_cli_error_surface(tmp_path, capsys):
    def scenario(cli):
        code, out, err = cli.run("index", "describe", "--index", "missing")
        assert code == 1 and "error:" in err
        return [code, out, err]
    cli_both(tmp_path, capsys, scenario)


def test_cli_source_and_split_admin(tmp_path, capsys):
    def scenario(cli):
        node_yaml, index_yaml, docs_path, base = cli.env
        seen = [parsed(cli.run("index", "create",
                               "--index-config", index_yaml))]
        src_yaml = base / "source.yaml"
        src_yaml.write_text("version: 0.8\nsource_id: files\n"
                            "source_type: file\nparams:\n"
                            f"  filepath: {docs_path}\n")
        code, out, _ = cli.run("source", "create", "--index", "cli-logs",
                               "--source-config", str(src_yaml))
        assert code == 0 and json.loads(out)["source_id"] == "files"
        seen.append(json.loads(out))
        code, out, _ = cli.run("source", "list", "--index", "cli-logs")
        assert any(s["source_id"] == "files" and s["enabled"]
                   for s in json.loads(out)["sources"])
        seen.append(json.loads(out))
        seen.append(parsed(cli.run("source", "disable", "--index",
                                   "cli-logs", "--source", "files")))
        code, out, _ = cli.run("source", "list", "--index", "cli-logs")
        [files] = [s for s in json.loads(out)["sources"]
                   if s["source_id"] == "files"]
        assert files["enabled"] is False
        seen.append(json.loads(out))
        seen.append(parsed(cli.run("source", "enable", "--index",
                                   "cli-logs", "--source", "files")))
        seen.append(parsed(cli.run("source", "delete", "--index", "cli-logs",
                                   "--source", "_ingest-api-source")))
        assert seen[-1][0] == 1
        seen.append(parsed(cli.run("source", "delete", "--index", "cli-logs",
                                   "--source", "files")))
        assert seen[-1][0] == 0
        code, out, _ = cli.run("source", "list", "--index", "cli-logs")
        assert not any(s["source_id"] == "files"
                       for s in json.loads(out)["sources"])
        seen.append(json.loads(out))
        seen.append(parsed(cli.run("index", "ingest", "--index", "cli-logs",
                                   "--input-path", docs_path)))
        code, out, _ = cli.run("split", "list", "--index", "cli-logs")
        split_id = json.loads(out)["splits"][0]["metadata"]["split_id"]
        code, out, _ = cli.run("split", "describe", "--index", "cli-logs",
                               "--split", split_id)
        assert code == 0
        assert json.loads(out)["metadata"]["split_id"] == split_id
        seen.append(json.loads(out))
        seen.append(parsed(cli.run("split", "describe", "--index",
                                   "cli-logs", "--split", "nope")))
        assert seen[-1][0] == 1
        code, out, err = cli.run("split", "mark-for-deletion", "--index",
                                 "cli-logs", "--splits", "nope")
        assert code == 1 and "unknown split" in err
        seen.append([code, out, err])
        seen.append(parsed(cli.run("split", "mark-for-deletion", "--index",
                                   "cli-logs", "--splits", f" {split_id} ")))
        assert seen[-1][0] == 0
        code, out, _ = cli.run("split", "list", "--index", "cli-logs")
        [marked] = [s for s in json.loads(out)["splits"]
                    if s["metadata"]["split_id"] == split_id]
        assert marked["state"] == "MarkedForDeletion"
        seen.append(json.loads(out))
        return seen
    cli_both(tmp_path, capsys, scenario)


# --- the client (tests/test_client.py, tests/test_index_update.py) ---------

class PairClient:
    """Each package's `QuickwitClient` on its own node of a `Pair`."""

    def __init__(self, pair):
        self.pair = pair
        self.clients = [side.q.mod("client").QuickwitClient(
            f"127.0.0.1:{side.port}") for side in pair.sides]

    def close(self):
        for client in self.clients:
            client.close()

    def _one(self, client, name, args, kwargs):
        try:
            result = getattr(client, name)(*args, **kwargs)
            if inspect.isgenerator(result):
                result = list(result)
            return "ok", result, None
        except Exception as exc:   # noqa: BLE001 - compared, then re-raised
            if type(exc).__name__ != "QuickwitError":
                raise
            return "error", [exc.status, exc.body], exc

    def __getattr__(self, name):
        def call(*args, compare=True, **kwargs):
            self.pair.tick()
            (wk, want, _), (gk, got, exc) = (
                self._one(c, name, args, kwargs) for c in self.clients)
            if compare:
                assert gk == wk, (name, want, got)
                assert_same_json(strip(want, self.pair.endpoints()),
                                 strip(got, self.pair.endpoints()))
            if exc is not None:
                raise exc
            return got
        return call


@pytest.fixture(scope="module")
def client():
    with pair_of_nodes(node_id="cl", metastore_uri="ram:///cl/ms",
                       default_index_root_uri="ram:///cl/idx") as pair:
        qw = PairClient(pair)
        yield qw
        qw.close()


CLIENT_DOCS = [{"ts": 1_600_000_000 + i, "sev": ["INFO", "ERROR"][i % 4 == 0],
                "body": f"event {i} clientword"} for i in range(40)]


def test_full_lifecycle(client):
    assert client.health()
    client.create_index({
        "index_id": "app",
        "doc_mapping": {"field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "sev", "type": "text", "tokenizer": "raw",
             "fast": True},
            {"name": "body", "type": "text"}],
            "timestamp_field": "ts"},
        "search_settings": {"default_search_fields": ["body"]}})
    assert any(ix["index_config"]["index_id"] == "app"
               for ix in client.list_indexes())
    out = client.ingest("app", CLIENT_DOCS, commit="force")
    assert out["num_ingested_docs"] == len(CLIENT_DOCS)
    assert len(client.list_splits("app")) == 1
    result = client.search("app", query="clientword", max_hits=5,
                           sort_by="-ts")
    assert result["num_hits"] == len(CLIENT_DOCS)
    assert len(result["hits"]) == 5
    assert result["hits"][0]["ts"] >= result["hits"][1]["ts"]
    es = client.es_search("app", {
        "query": {"match": {"body": "clientword"}}, "size": 0,
        "aggs": {"per_hour": {"date_histogram": {
            "field": "ts", "fixed_interval": "1h"}}}})
    assert es["hits"]["total"]["value"] == len(CLIENT_DOCS)
    assert sum(b["doc_count"]
               for b in es["aggregations"]["per_hour"]["buckets"]) \
        == len(CLIENT_DOCS)
    # the JAX node answers the SQL query; the port refuses it until the
    # SQL engine is ported
    jax_client, port_client = client.clients
    rows = jax_client.sql("SELECT COUNT(*) AS n FROM app")["rows"]
    assert rows[0][0] == len(CLIENT_DOCS)
    with pytest.raises(QuickwitError) as exc:
        port_client.sql("SELECT COUNT(*) AS n FROM app")
    assert exc.value.status == 501
    assert "analytics/sql.py" in exc.value.body["message"]
    pages = client.scroll("app", query="clientword", max_hits=15)
    seen = [h["ts"] for page in pages for h in page["hits"]]
    assert sorted(seen) == sorted(d["ts"] for d in CLIENT_DOCS)
    assert client.cluster()["node_id"] == "cl"


def test_errors_are_typed(client):
    with pytest.raises(QuickwitError) as exc:
        client.search("no-such-index", query="x")
    assert exc.value.status in (400, 404)
    with pytest.raises(QuickwitError):
        client.create_index({"index_id": "bad", "doc_mapping": {
            "field_mappings": [{"name": "x", "type": "nope"}]}})


def test_delete_task_via_client(client):
    client.create_index({
        "index_id": "gdpr",
        "doc_mapping": {"field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "user", "type": "text", "tokenizer": "raw"}],
            "timestamp_field": "ts"}})
    client.ingest("gdpr", [{"ts": 1 + i, "user": f"u{i % 2}"}
                           for i in range(10)], commit="force")
    out = client.create_delete_task("gdpr", {"term": {"user": "u1"}})
    assert out["opstamp"] == 1


def test_warmup_endpoint(client):
    client.create_index({
        "index_id": "warm",
        "doc_mapping": {"field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "body", "type": "text"}],
            "timestamp_field": "ts"},
        "search_settings": {"default_search_fields": ["body"]}})
    client.ingest("warm", [{"ts": 1 + i, "body": f"w {i} warmword"}
                           for i in range(8)], commit="force")
    # `elapsed_ms` is the warm-up's wall time: compare the statuses
    outs = [c.request("POST", "/api/v1/warm/warmup") for c in client.clients]
    assert [[w["status"] for w in out["warmed"]] for out in outs] == \
        [["ok", "ok"]] * 2
    outs = [c.request("POST", "/api/v1/warm/warmup", {
        "queries": [{"query": "warmword", "max_hits": 5, "sort_by": "-ts"}]})
        for c in client.clients]
    for out in outs:
        assert out["warmed"][0]["status"] == "ok"
        assert out["warmed"][0]["elapsed_ms"] >= 0


@pytest.fixture()
def upd():
    with pair_of_nodes(node_id="up", metastore_uri="ram:///up/ms",
                       default_index_root_uri="ram:///up/idx") as pair:
        client = PairClient(pair)
        client.create_index({
            "index_id": "upd",
            "doc_mapping": {"field_mappings": [
                {"name": "ts", "type": "datetime", "fast": True,
                 "input_formats": ["unix_timestamp"]},
                {"name": "title", "type": "text"},
                {"name": "body", "type": "text"}],
                "timestamp_field": "ts"},
            "search_settings": {"default_search_fields": ["body"]}})
        client.ingest("upd", [{"ts": 1 + i, "title": f"tword {i}",
                               "body": f"bword {i}"} for i in range(6)],
                      commit="force")
        yield pair, client
        client.close()


def test_update_default_search_fields_applies_live(upd):
    _pair, client = upd
    assert client.search("upd", query="tword")["num_hits"] == 0
    out = client.update_index("upd", {
        "search_settings": {"default_search_fields": ["title", "body"]}})
    assert out["index_config"]["doc_mapping"][
        "default_search_fields"] == ["title", "body"]
    assert client.search("upd", query="tword")["num_hits"] == 6
    assert client.search("upd", query="bword")["num_hits"] == 6


def test_append_only_doc_mapping(upd):
    _pair, client = upd
    base = client.request("GET", "/api/v1/indexes/upd")
    mapping = base["index_config"]["doc_mapping"]
    mapping["field_mappings"].append(
        {"name": "sev", "type": "text", "tokenizer": "raw", "fast": True})
    client.update_index("upd", {"doc_mapping": mapping})
    client.ingest("upd", [{"ts": 100, "title": "x", "body": "x",
                           "sev": "ERROR"}], commit="force")
    assert client.search("upd", query="sev:ERROR")["num_hits"] == 1
    removed = dict(mapping)
    removed["field_mappings"] = [f for f in mapping["field_mappings"]
                                 if f["name"] != "title"]
    with pytest.raises(QuickwitError) as exc:
        client.update_index("upd", {"doc_mapping": removed})
    assert exc.value.status == 400 and "REMOVE" in str(exc.value)
    changed = dict(mapping)
    changed["field_mappings"] = [
        {**f, "type": "u64"} if f["name"] == "title" else f
        for f in mapping["field_mappings"]]
    with pytest.raises(QuickwitError) as exc:
        client.update_index("upd", {"doc_mapping": changed})
    assert exc.value.status == 400 and "CHANGE" in str(exc.value)


def test_update_retention_and_indexing_settings(upd):
    pair, client = upd
    out = client.update_index("upd", {
        "retention": {"period": "7 days"},
        "indexing_settings": {"split_num_docs_target": 123,
                              "commit_timeout_secs": 5}})
    config = out["index_config"]
    assert config["retention"]["period_seconds"] == 7 * 86_400
    assert config["split_num_docs_target"] == 123
    assert config["commit_timeout_secs"] == 5
    out = client.update_index("upd", {"retention": None})
    assert out["index_config"]["retention"] is None
    with pytest.raises(QuickwitError) as exc:
        client.update_index("upd", {
            "indexing_settings": {"commit_timeout_secs": 0}})
    assert exc.value.status == 400
    assert pair.both(lambda node: node.metastore.index_metadata("upd")
                     .index_config.index_id) == "upd"


def test_rejected_update_leaves_config_untouched(upd):
    pair, client = upd
    with pytest.raises(QuickwitError) as exc:
        client.update_index("upd", {
            "search_settings": {"default_search_fields": ["nope"]}})
    assert exc.value.status == 400
    assert pair.both(lambda node: node.metastore.index_metadata("upd")
                     .index_config.doc_mapper.default_search_fields) \
        == ("body",)
    assert client.search("upd", query="bword")["num_hits"] == 6


def test_malformed_update_shapes_are_400(upd):
    _pair, client = upd
    for bad in ({"retention": {}},
                {"retention": "30 days"},
                {"search_settings": ["x"]},
                {"indexing_settings": {"merge_policy": {"type": "bogus"}}},
                {"indexing_settings": {"merge_policy": "bogus"}},
                {"search_settings": {"default_search_fields": "body"}}):
        with pytest.raises(QuickwitError) as exc:
            client.update_index("upd", bad)
        assert exc.value.status == 400, bad


def test_reset_source_checkpoint_replays(upd, tmp_path):
    pair, client = upd
    path = tmp_path / "replay.ndjson"
    path.write_text("\n".join(
        json.dumps({"ts": 50 + i, "title": "r", "body": f"rp {i}"})
        for i in range(4)))
    client.create_source("upd", {
        "source_id": "rp", "source_type": "file",
        "params": {"filepath": str(path)}})

    def source_pass(node):
        return node.run_source_pass("upd", "rp").num_docs_processed
    assert pair.both(source_pass) == 4
    assert pair.both(source_pass) == 0
    out = client.request(
        "PUT", "/api/v1/indexes/upd/sources/rp/reset-checkpoint")
    assert out == {"source_id": "rp", "checkpoint": "reset"}
    assert pair.both(source_pass) == 4
    with pytest.raises(QuickwitError) as exc:
        client.request(
            "PUT", "/api/v1/indexes/upd/sources/none/reset-checkpoint")
    assert exc.value.status == 404
    with pytest.raises(QuickwitError) as exc:
        client.request(
            "PUT",
            "/api/v1/indexes/upd/sources/_ingest-source/reset-checkpoint")
    assert exc.value.status == 400 and "built-in" in str(exc.value)


# --- the port's own ----------------------------------------------------------

CONFIG_CASES = [
    ("", {}),
    (NODE_YAML, {}),
    (NODE_YAML, {"QW_NODE_ID": "env-node", "QW_REST_PORT": "0",
                 "QW_METASTORE_URI": "file:///m",
                 "QW_ENABLED_SERVICES": "searcher"}),
    ("node_id: n\nrest:\n  listen_host: 0.0.0.0\n  tls:\n"
     "    cert_path: /c\n    key_path: /k\n    verify_client: true\n"
     "gossip: true\nreplication_factor: 2\npeer_seeds: [a:1, b:2]\n"
     "searcher:\n  split_cache:\n    root_path: /cache\n"
     "    max_bytes: 1000\n", {"QW_REPLICATION_FACTOR": "3"}),
    ("device: cpu\nnode_id: d\n", {}),
]


@pytest.mark.parametrize("text,env", CONFIG_CASES)
def test_node_config_fields_equal_across_packages(tmp_path, text, env):
    path = None
    if text:
        path = tmp_path / "node.yaml"
        path.write_text(text)
    configs = [dataclasses.asdict(config_mod(root).load_node_config(
        str(path) if path else None, env=env)) for root in PACKAGES]
    device = configs[1].pop("device")
    assert configs[1] == configs[0]
    assert device == ("cpu" if "device: cpu" in text else None)


def test_qw_device_reaches_the_searcher_context():
    q = load("quickwit_tpu_torch")
    config = config_mod(q.root).load_node_config(env={
        "QW_DEVICE": "cpu", "QW_METASTORE_URI": "ram:///dev/ms",
        "QW_DEFAULT_INDEX_ROOT_URI": "ram:///dev/idx"})
    assert config.device == "cpu"
    node = q.serve.Node(config,
                        storage_resolver=q.storage.StorageResolver.for_test())
    assert node.searcher_context.device == torch.device("cpu")


def test_node_without_a_card_raises_unless_given_the_cpu(monkeypatch):
    q = load("quickwit_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = config_mod(q.root).load_node_config(env={
        "QW_METASTORE_URI": "ram:///nogpu/ms",
        "QW_DEFAULT_INDEX_ROOT_URI": "ram:///nogpu/idx"})
    assert config.device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q.serve.Node(config,
                     storage_resolver=q.storage.StorageResolver.for_test())


def test_trace_export_from_a_node_and_from_the_process(tmp_path, capsys):
    q = load("quickwit_tpu_torch")
    main = q.mod("cli").main
    node = q.serve.Node(q.serve.NodeConfig(
        node_id="tr", rest_port=0, metastore_uri="ram:///tr/ms",
        default_index_root_uri="ram:///tr/idx", device="cpu"),
        storage_resolver=q.storage.StorageResolver.for_test())
    server = q.serve.RestServer(node)
    server.start()
    try:
        flight = q.mod("observability.flight").FLIGHT
        flight.emit("test.mark", attrs={"n": 1})
        remote = tmp_path / "remote.json"
        assert main(["trace", "export", "--endpoint",
                     f"127.0.0.1:{server.port}", "--out", str(remote)]) == 0
        local = tmp_path / "local.json"
        assert main(["trace", "export", "--out", str(local)]) == 0
        capsys.readouterr()
        for path in (remote, local):
            events = json.loads(path.read_text())["traceEvents"]
            assert any(e.get("name") == "test.mark" for e in events)
    finally:
        server.stop()


def _read_listening_line(proc, timeout):
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    lines = []
    while sel.select(timeout=timeout):
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "listening on" in line:
            return line
    raise AssertionError(f"no listening line: {lines}")


def test_cli_run_subprocess_answers_and_stops_on_sigint(tmp_path):
    env = dict(os.environ, QW_DEVICE="cpu", QW_REST_PORT="0",
               QW_METASTORE_URI=f"file://{tmp_path}/metastore",
               QW_DEFAULT_INDEX_ROOT_URI=f"file://{tmp_path}/indexes",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "quickwit_tpu_torch.cli", "run"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = _read_listening_line(proc, timeout=60)
        endpoint = line.rsplit("://", 1)[1].strip()
        client_mod = load("quickwit_tpu_torch").mod("client")
        qw = client_mod.QuickwitClient(endpoint)
        qw.create_index({
            "index_id": "sub",
            "doc_mapping": {"field_mappings": [
                {"name": "ts", "type": "datetime", "fast": True,
                 "input_formats": ["unix_timestamp"]},
                {"name": "body", "type": "text"}],
                "timestamp_field": "ts"},
            "search_settings": {"default_search_fields": ["body"]}})
        qw.ingest("sub", [{"ts": 1 + i, "body": f"sub {i} word"}
                          for i in range(20)], commit="force")
        assert qw.search("sub", query="word")["num_hits"] == 20
        qw.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=10) == 0
    finally:
        with contextlib.suppress(ProcessLookupError):
            proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()
