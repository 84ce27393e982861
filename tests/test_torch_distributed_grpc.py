"""Distributed search over the port's gRPC plane, and across packages.

The gRPC cases of `tests/test_distributed_search.py` (plaintext and TLS)
run on port nodes on the CPU: peers that advertise gRPC are reached
through `GrpcSearchClient`, and the root's leaf and fetch fan-out rides
binwire payloads on a persistent HTTP/2 connection. Then a mixed cluster:
a JAX node and a port node over one `file://` metastore and index, each
reaching the other's leaves over gRPC. A JAX root and a port root give
equal responses to the same requests.
"""

import pytest

from quickwit_tpu_torch.storage import StorageResolver


def test_fanout_over_grpc_framing():
    """Two real nodes with the gRPC plane enabled: the root→leaf
    leaf_search/fetch_docs fan-out rides gRPC framing with binwire
    payloads on a persistent HTTP/2 connection (reference: codegen'd
    SearchService gRPC clients, search.proto:19)."""
    import http.client as hc
    import json as _json

    from quickwit_tpu_torch.config.node_config import NodeConfig
    from quickwit_tpu_torch.serve.grpc_server import GrpcSearchClient
    from quickwit_tpu_torch.serve.node import Node
    from quickwit_tpu_torch.serve.rest import RestServer

    resolver = StorageResolver.for_test()
    nodes, servers = [], []
    for i in range(2):
        node = Node(NodeConfig(node_id=f"g-{i}", rest_port=0, grpc_port=0,
                               metastore_uri="ram:///gfan/ms",
                               default_index_root_uri="ram:///gfan/idx",
                               device="cpu"),
                    storage_resolver=resolver)
        server = RestServer(node)
        server.start()
        nodes.append(node)
        servers.append(server)
    try:
        # mutual membership, gRPC endpoints advertised
        for i, node in enumerate(nodes):
            from quickwit_tpu_torch.serve.http_client import HttpSearchClient
            HttpSearchClient(servers[1 - i].endpoint).heartbeat({
                "node_id": node.config.node_id,
                "roles": list(node.config.roles),
                "rest_endpoint": servers[i].endpoint,
                "grpc_endpoint": node._grpc_advertise()})
        # peers picked the gRPC client
        assert isinstance(nodes[0].clients["g-1"], GrpcSearchClient)
        assert isinstance(nodes[1].clients["g-0"], GrpcSearchClient)

        def rest(port, method, path, body=None):
            conn = hc.HTTPConnection("127.0.0.1", port, timeout=30)
            data = (None if body is None else
                    body if isinstance(body, bytes)
                    else _json.dumps(body).encode())
            conn.request(method, path, body=data)
            response = conn.getresponse()
            payload = response.read()
            conn.close()
            return response.status, (_json.loads(payload) if payload else None)

        status, _ = rest(servers[0].port, "POST", "/api/v1/indexes", {
            "index_id": "gfan-logs",
            "doc_mapping": {"field_mappings": [
                {"name": "ts", "type": "datetime", "fast": True,
                 "input_formats": ["unix_timestamp"]},
                {"name": "body", "type": "text"}],
                "timestamp_field": "ts",
                "default_search_fields": ["body"]},
            "indexing_settings": {"split_num_docs_target": 50}})
        assert status == 200
        docs = "\n".join(
            _json.dumps({"ts": 1_600_000_000 + i, "body": f"doc {i} grpcword"})
            for i in range(200)).encode()
        status, result = rest(servers[0].port, "POST",
                              "/api/v1/gfan-logs/ingest", docs)
        assert status == 200 and result["num_ingested_docs"] == 200

        # search via node 1: with 2 searchers the placer fans splits across
        # both, so node 1 must reach node 0's leaf over gRPC (hits + aggs
        # exercise binwire's numpy agg-state path, fetch phase the doc path)
        status, result = rest(
            servers[1].port, "GET",
            "/api/v1/gfan-logs/search?query=grpcword&max_hits=5"
            "&sort_by=-ts")
        assert status == 200 and result["num_hits"] == 200
        assert len(result["hits"]) == 5
        assert result["hits"][0]["ts"] == 1_600_000_199

        status, result = rest(
            servers[1].port, "POST", "/api/v1/gfan-logs/search", {
                "query": "grpcword", "max_hits": 3,
                "aggs": {"by_day": {"date_histogram": {
                    "field": "ts", "fixed_interval": "1d"}}}})
        assert status == 200 and result["num_hits"] == 200
        buckets = result["aggregations"]["by_day"]["buckets"]
        assert sum(b["doc_count"] for b in buckets) == 200
        assert all(h["body"].endswith("grpcword") for h in result["hits"])

        # the persistent channel actually carried traffic
        used = [c for node in nodes for c in node.clients.values()
                if isinstance(c, GrpcSearchClient) and c._channel is not None]
        assert used, "no gRPC channel was used for the fan-out"
    finally:
        for node in nodes:
            if node.grpc_server is not None:
                node.grpc_server.stop()
        for server in servers:
            server.stop()


def test_fanout_over_grpc_framing_under_tls(tmp_path):
    """Round-4 directive #9: a TLS cluster keeps its BINARY plane — the
    gRPC framing runs h2-over-TLS with the cluster cert/CA, peers pick
    the GrpcSearchClient, and distributed search works end to end."""
    import http.client as hc
    import json as _json
    import shutil
    import subprocess

    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)

    import ssl as _ssl

    from quickwit_tpu_torch.config.node_config import NodeConfig
    from quickwit_tpu_torch.serve.grpc_server import GrpcSearchClient
    from quickwit_tpu_torch.serve.http_client import HttpSearchClient
    from quickwit_tpu_torch.serve.node import Node
    from quickwit_tpu_torch.serve.rest import RestServer

    resolver = StorageResolver.for_test()
    nodes, servers = [], []
    for i in range(2):
        node = Node(NodeConfig(node_id=f"gt-{i}", rest_port=0, grpc_port=0,
                               metastore_uri="ram:///gtls/ms",
                               default_index_root_uri="ram:///gtls/idx",
                               tls_cert_path=str(cert),
                               tls_key_path=str(key),
                               tls_ca_path=str(cert), device="cpu"),
                    storage_resolver=resolver)
        server = RestServer(node)
        server.start()
        nodes.append(node)
        servers.append(server)
    try:
        for i, node in enumerate(nodes):
            # TLS advertise: the gRPC endpoint is published even with TLS on
            assert node._grpc_advertise(), "TLS node must advertise gRPC"
            HttpSearchClient(servers[1 - i].endpoint,
                             **node.config.client_tls_kwargs()).heartbeat({
                "node_id": node.config.node_id,
                "roles": list(node.config.roles),
                "rest_endpoint": servers[i].endpoint,
                "grpc_endpoint": node._grpc_advertise()})
        assert isinstance(nodes[0].clients["gt-1"], GrpcSearchClient)
        assert isinstance(nodes[1].clients["gt-0"], GrpcSearchClient)

        context = _ssl.create_default_context(cafile=str(cert))

        def rest(port, method, path, body=None):
            conn = hc.HTTPSConnection("127.0.0.1", port, timeout=30,
                                      context=context)
            data = (None if body is None else
                    body if isinstance(body, bytes)
                    else _json.dumps(body).encode())
            conn.request(method, path, body=data)
            response = conn.getresponse()
            payload = response.read()
            conn.close()
            return response.status, (_json.loads(payload) if payload else None)

        status, _ = rest(servers[0].port, "POST", "/api/v1/indexes", {
            "index_id": "gtls-logs",
            "doc_mapping": {"field_mappings": [
                {"name": "ts", "type": "datetime", "fast": True,
                 "input_formats": ["unix_timestamp"]},
                {"name": "body", "type": "text"}],
                "timestamp_field": "ts",
                "default_search_fields": ["body"]},
            "indexing_settings": {"split_num_docs_target": 50}})
        assert status == 200
        docs = "\n".join(
            _json.dumps({"ts": 1_600_000_000 + i,
                         "body": f"doc {i} tlsword"})
            for i in range(120)).encode()
        status, result = rest(servers[0].port, "POST",
                              "/api/v1/gtls-logs/ingest", docs)
        assert status == 200 and result["num_ingested_docs"] == 120

        status, result = rest(
            servers[1].port, "GET",
            "/api/v1/gtls-logs/search?query=tlsword&max_hits=5&sort_by=-ts")
        assert status == 200 and result["num_hits"] == 120
        assert len(result["hits"]) == 5

        # a plaintext h2c client must be rejected by the TLS gRPC plane
        from quickwit_tpu_torch.serve.grpc_server import GrpcChannel
        host, port = nodes[0]._grpc_advertise().rsplit(":", 1)
        with pytest.raises(Exception):
            plain = GrpcChannel(host, int(port), timeout=5)
            plain.call("/quickwit.search.SearchService/LeafSearch", b"")

        # the persistent TLS channel actually carried the fan-out
        used = [c for node in nodes for c in node.clients.values()
                if isinstance(c, GrpcSearchClient)
                and c._channel is not None]
        assert used, "no gRPC channel was used for the TLS fan-out"
        assert all(c._channel_ssl is not None for c in used)
    finally:
        for node in nodes:
            if node.grpc_server is not None:
                node.grpc_server.stop()
        for server in servers:
            server.stop()


# --- a mixed cluster: a JAX node and a port node -------------------------------

MIXED_INDEX = {
    "index_id": "mixed-logs",
    "doc_mapping": {"field_mappings": [
        {"name": "ts", "type": "datetime", "fast": True,
         "input_formats": ["unix_timestamp"]},
        {"name": "body", "type": "text"},
        {"name": "level", "type": "text", "tokenizer": "raw", "fast": True}],
        "timestamp_field": "ts", "default_search_fields": ["body"]},
    "indexing_settings": {"split_num_docs_target": 50}}
MIXED_DOCS = 400
MIXED_REQUESTS = [
    ("GET", "/api/v1/mixed-logs/search?query=mixword&max_hits=7"
            "&sort_by=-ts", None),
    ("POST", "/api/v1/mixed-logs/search", {
        "query": "mixword AND level:ERROR", "max_hits": 5,
        "aggs": {"by_day": {"date_histogram": {"field": "ts",
                                               "fixed_interval": "1h"}},
                 "levels": {"terms": {"field": "level"}}}}),
    ("POST", "/api/v1/mixed-logs/search", {
        "query": "body:w3", "max_hits": 10}),
]


@pytest.fixture(scope="module")
def mixed_cluster(tmp_path_factory):
    """A JAX node and a port node (on the CPU), each with its gRPC plane
    and REST server, over one `file://` metastore and index root, each a
    member of the other's cluster. The JAX node writes the index: 8
    splits of 50 docs."""
    from test_torch_rest_api import (PACKAGES, deterministic,
                                     force_python_paths, load, send)
    root = tmp_path_factory.mktemp("mixed")
    sides = {}
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        try:
            for package in PACKAGES:
                q = load(package)
                node = q.serve.Node(q.serve.NodeConfig(
                    node_id=f"{package}-node", rest_port=0, grpc_port=0,
                    metastore_uri=f"file://{root}/ms",
                    default_index_root_uri=f"file://{root}/idx",
                    data_dir=str(root / package),
                    **({"device": "cpu"} if q.is_port else {})),
                    storage_resolver=q.storage.StorageResolver.for_test())
                server = q.serve.RestServer(node)
                server.start()
                sides[package] = (q, node, server)
            jq, jnode, jserver = sides["quickwit_tpu"]
            # split ids are (wall time, seeded draw): a fixed time prefix
            # makes the rendezvous placement, and so which root's top hits
            # cross to the other node, the same in every run
            from quickwit_tpu.models import split_metadata as j_split_md
            mp.setattr(j_split_md, "wall_time", lambda: 1_700_000_000.0)
            with deterministic(mp, jq, fake_clock=False):
                status, _ = send(jserver.port, "POST", "/api/v1/indexes",
                                 MIXED_INDEX)
                assert status == 200
                docs = "\n".join(json_line(i) for i in range(MIXED_DOCS))
                status, result = send(
                    jserver.port, "POST",
                    "/api/v1/mixed-logs/ingest?commit=force",
                    docs.encode())
                assert status == 200
                assert result["num_ingested_docs"] == MIXED_DOCS
            for package, (q, node, server) in sides.items():
                node.metastore.refresh()
                other = next(s for p, s in sides.items() if p != package)
                other_node, other_server = other[1], other[2]
                q.http_client.HttpSearchClient(
                    other_server.endpoint).heartbeat({
                        "node_id": node.config.node_id,
                        "roles": list(node.config.roles),
                        "rest_endpoint": server.endpoint,
                        "grpc_endpoint": node._grpc_advertise()})
            yield sides
        finally:
            for _q, node, server in sides.values():
                if node.grpc_server is not None:
                    node.grpc_server.stop()
                server.stop()
                node.stop_background_services()


def json_line(i):
    import json
    return json.dumps({"ts": 1_600_000_000 + 60 * i,
                       "body": f"doc {i} mixword w{i % 5}",
                       "level": ["INFO", "ERROR", "WARN"][i % 3]})


def test_mixed_cluster_roots_reach_each_other_over_grpc(mixed_cluster):
    from quickwit_tpu.serve.grpc_server import (
        GrpcSearchClient as JGrpcSearchClient)
    from quickwit_tpu_torch.serve.grpc_server import (
        GrpcSearchClient as TGrpcSearchClient)
    from test_torch_rest_api import assert_same_json, send, strip

    _, jnode, jserver = mixed_cluster["quickwit_tpu"]
    _, tnode, tserver = mixed_cluster["quickwit_tpu_torch"]
    to_port = jnode.clients["quickwit_tpu_torch-node"]
    to_jax = tnode.clients["quickwit_tpu-node"]
    assert type(to_port) is JGrpcSearchClient
    assert type(to_jax) is TGrpcSearchClient

    # each root's calls to the other package's leaves, by RPC path
    calls = {"jax_root": [], "port_root": []}
    for name, client in (("jax_root", to_port), ("port_root", to_jax)):
        def spy(path, payload, timeout_secs=None, inner=client._call,
                seen=calls[name]):
            seen.append(path.rsplit("/", 1)[1])
            return inner(path, payload, timeout_secs=timeout_secs)
        client._call = spy

    endpoints = [jserver.endpoint, tserver.endpoint]
    for method, path, body in MIXED_REQUESTS:
        want = send(jserver.port, method, path, body)
        got = send(tserver.port, method, path, body)
        assert want[0] == got[0] == 200, (want, got)
        assert got[1]["num_hits"] > 0 and got[1]["hits"]
        assert_same_json(strip(want[1], endpoints), strip(got[1], endpoints))
    # every request's leaf search crossed the packages both ways over
    # gRPC; a fetch does where the top hits hold the other node's splits
    for name in calls:
        assert calls[name].count("LeafSearch") == len(MIXED_REQUESTS), calls
        assert calls[name].count("FetchDocs") >= 1, calls


def test_mixed_cluster_total_count_matches_one_node(mixed_cluster):
    from test_torch_rest_api import send
    _, _, jserver = mixed_cluster["quickwit_tpu"]
    _, _, tserver = mixed_cluster["quickwit_tpu_torch"]
    for server in (jserver, tserver):
        status, result = send(server.port, "GET",
                              "/api/v1/mixed-logs/search?query=mixword"
                              "&max_hits=0")
        assert status == 200 and result["num_hits"] == MIXED_DOCS
