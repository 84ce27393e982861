"""Clusters of port nodes over HTTP, and mixed JAX/port clusters.

The 9 scenarios of `tests/test_multinode.py` (two nodes over HTTP,
failover, the janitor, two-node WAL ingest, the wildcard bind, TLS, a
scroll across a restart, mTLS) run in each package, on the CPU; where a
scenario returns what its nodes answered, the two packages' answers must
be equal (`assert_same_json`, minus wall times and each node's own REST
port). The clusters run on the real clock, as the JAX scenarios do: the
janitor's grace period, retention and peer liveness read it. The RNG and
the uuids are seeded per package.

Then a mixed cluster, both ways: a JAX node and a port node are peers
over the same `file://` split and metastore files; a root on each fans
leaf searches out to the other through `/internal/leaf_search` and
fetches its docs through `/internal/fetch_docs`. Each root's response
equals a single-node root's over the same splits.
"""

import contextlib
import json
import shutil
import subprocess

import pytest

from test_torch_rest_api import (PACKAGES, assert_same_json, deterministic,
                                 force_python_paths, load, send, strip)

INDEX_CONFIG = {
    "index_id": "mn-logs",
    "doc_mapping": {
        "field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "body", "type": "text"},
        ],
        "timestamp_field": "ts",
        "default_search_fields": ["body"],
    },
    "indexing_settings": {"split_num_docs_target": 50},
}


def node_config(q, **kw):
    return q.serve.NodeConfig(rest_port=0, **kw,
                              **({"device": "cpu"} if q.is_port else {}))


def join(q, nodes, servers):
    """Mutual membership through the heartbeat route (the gossip join)."""
    for i, node in enumerate(nodes):
        peer = servers[1 - i]
        client = q.http_client.HttpSearchClient(peer.endpoint)
        client.heartbeat({"node_id": node.config.node_id,
                          "roles": list(node.config.roles),
                          "rest_endpoint": servers[i].endpoint})


class TwoNodes:
    def __init__(self, q, nodes, servers):
        self.q, self.nodes, self.servers = q, nodes, servers

    def endpoints(self):
        return [f"127.0.0.1:{s.port}" for s in self.servers]


@pytest.fixture(scope="module")
def clusters():
    """Per package, two nodes over one resolver (shared object storage
    and metastore files), joined over HTTP."""
    out, servers_all = {}, []
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        force_python_paths(mp)
        try:
            for root in PACKAGES:
                q = load(root)
                stack.enter_context(deterministic(mp, q, fake_clock=False))
                resolver = q.storage.StorageResolver.for_test()
                nodes, servers = [], []
                for i in range(2):
                    node = q.serve.Node(
                        node_config(q, node_id=f"mn-{i}",
                                    metastore_uri="ram:///mn/metastore",
                                    default_index_root_uri="ram:///mn/indexes"),
                        storage_resolver=resolver)
                    server = q.serve.RestServer(node)
                    server.start()
                    nodes.append(node)
                    servers.append(server)
                    servers_all.append(server)
                join(q, nodes, servers)
                out[root] = TwoNodes(q, nodes, servers)
            yield out
        finally:
            for server in servers_all:
                server.stop()


def both(clusters, scenario):
    """`scenario(cluster)` in each package; what it returns must be
    equal across the packages (minus wall times and REST ports)."""
    got = {root: strip(scenario(clusters[root]), clusters[root].endpoints())
           for root in PACKAGES}
    assert_same_json(got["quickwit_tpu"], got["quickwit_tpu_torch"])
    return got["quickwit_tpu_torch"]


def test_cross_node_search(clusters):
    def scenario(c):
        port0, port1 = c.servers[0].port, c.servers[1].port
        status, _ = send(port0, "POST", "/api/v1/indexes", INDEX_CONFIG)
        assert status == 200
        docs = "\n".join(json.dumps({"ts": 1_600_000_000 + i,
                                     "body": f"doc {i} shared"})
                         for i in range(200)).encode()
        status, result = send(port0, "POST", "/api/v1/mn-logs/ingest", docs)
        assert status == 200 and result["num_ingested_docs"] == 200
        status, cluster = send(port0, "GET", "/api/v1/cluster")
        assert {m["node_id"] for m in cluster["members"]} == {"mn-0", "mn-1"}
        # node 1 searches what node 0 ingested, fanning the 4 splits
        # over both searchers
        answers = []
        for _ in range(2):   # the repeat hits the nodes' caches
            status, result = send(
                port1, "GET", "/api/v1/mn-logs/search?query=shared&max_hits=5")
            assert status == 200 and result["num_hits"] == 200
            answers.append(result)
        return answers
    both(clusters, scenario)


def test_dead_node_failover(clusters):
    def scenario(c):
        c.servers[1].stop()
        member = c.nodes[0].cluster.member("mn-1")
        member.last_heartbeat = c.q.clock.monotonic() - 1000
        status, result = send(
            c.servers[0].port, "GET",
            "/api/v1/mn-logs/search?query=shared&max_hits=3")
        assert status == 200 and result["num_hits"] == 200
        return result
    both(clusters, scenario)


@pytest.mark.parametrize("root", PACKAGES)
def test_http_client_error_surface(root):
    q = load(root)
    client = q.http_client.HttpSearchClient("127.0.0.1:1")  # nothing listens
    with pytest.raises(q.http_client.HttpTransportError):
        client.heartbeat({"node_id": "x", "roles": []})


def test_janitor_gc_and_retention(clusters):
    def scenario(c):
        q, node = c.q, c.nodes[0]
        split_state = q.mod("models.split_metadata").SplitState
        list_query = q.mod("metastore.base").ListSplitsQuery
        janitor = q.mod("janitor")
        metadata = node.metastore.index_metadata("mn-logs")
        uid = metadata.index_uid
        storage = node.storage_resolver.resolve(
            metadata.index_config.index_uri)
        published = node.metastore.list_splits(list_query(
            index_uids=[uid], states=[split_state.PUBLISHED]))
        victim = published[0].metadata.split_id
        node.metastore.mark_splits_for_deletion(uid, [victim])
        now = q.clock.wall_time()
        too_young = janitor.run_garbage_collection(
            node.metastore, node.storage_resolver, now=now)
        later = janitor.run_garbage_collection(
            node.metastore, node.storage_resolver, now=now + 10_000)
        assert too_young["gc_deleted_splits"] == 0
        assert later["gc_deleted_splits"] == 1
        assert not storage.exists(f"{victim}.split")
        node.metastore.update_retention_policy(
            uid, q.mod("models.index_metadata").RetentionPolicy(
                period_seconds=3600))
        stats = janitor.apply_retention(node.metastore)
        remaining = node.metastore.list_splits(list_query(
            index_uids=[uid], states=[split_state.PUBLISHED]))
        assert stats["retention_marked_splits"] > 0
        assert remaining == []
        return [too_young, later, stats]
    both(clusters, scenario)


@pytest.mark.parametrize("root", PACKAGES)
def test_two_node_wal_ingest_no_checkpoint_collision(root, tmp_path):
    """Both nodes take WAL ingests for one index and drain their own
    WALs into the shared metastore: node-prefixed shard ids keep the
    checkpoint partitions disjoint, so no docs are lost."""
    q = load(root)
    resolver = q.storage.StorageResolver.for_test()
    nodes = [q.serve.Node(node_config(
        q, node_id=f"walmn-{i}", metastore_uri="ram:///walmn/metastore",
        default_index_root_uri="ram:///walmn/indexes",
        data_dir=str(tmp_path / f"n{i}"), wal_fsync=False),
        storage_resolver=resolver) for i in range(2)]
    nodes[0].index_service.create_index(INDEX_CONFIG)
    nodes[0].ingest_v2("mn-logs", [{"ts": 1_600_000_000 + i,
                                    "body": f"walmn from zero {i}"}
                                   for i in range(30)])
    nodes[1].ingest_v2("mn-logs", [{"ts": 1_600_000_100 + i,
                                    "body": f"walmn from one {i}"}
                                   for i in range(20)])
    assert nodes[0].run_ingest_pass("mn-logs")["num_docs_indexed"] == 30
    try:
        stats = nodes[1].run_ingest_pass("mn-logs")
    except q.mod("metastore").MetastoreError as exc:
        assert exc.kind == "failed_precondition"
        stats = nodes[1].run_ingest_pass("mn-logs")
    assert stats["num_docs_indexed"] == 20
    request = q.mod("search.models").SearchRequest(
        index_ids=["mn-logs"],
        query_ast=q.mod("query").parse_query_string("walmn", ["body"]),
        max_hits=5)
    assert nodes[1].root_searcher.search(request).num_hits == 50
    uid = nodes[1].metastore.index_metadata("mn-logs").index_uid
    checkpoint = nodes[1].metastore.source_checkpoint(uid, "_ingest-source")
    partitions = set(checkpoint.positions)
    assert any(p.startswith("walmn-0-") for p in partitions)
    assert any(p.startswith("walmn-1-") for p in partitions)


@pytest.mark.parametrize("root", PACKAGES)
def test_wildcard_bind_address_not_advertised(root):
    substitute = load(root).mod("cluster.membership").substitute_wildcard_host
    assert substitute("0.0.0.0:7280", "10.0.0.5") == "10.0.0.5:7280"
    assert substitute(":::7280", "10.0.0.5") == "10.0.0.5:7280"
    assert substitute("192.168.1.2:7280", "10.0.0.5") == "192.168.1.2:7280"
    assert substitute("", "10.0.0.5") == ""
    assert substitute("0.0.0.0:7280", "") == "0.0.0.0:7280"


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    base = tmp_path_factory.mktemp("tls")
    cert, key = base / "cert.pem", base / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return cert, key


@pytest.mark.parametrize("root", PACKAGES)
def test_tls_rest_and_peer_transport(root, cert):
    """TLS on the REST listener with the peer client verifying against a
    pinned CA: heartbeat and the cluster route over HTTPS."""
    import ssl
    import urllib.request
    q = load(root)
    cert, key = cert
    node = q.serve.Node(node_config(
        q, node_id="tls-node", metastore_uri="ram:///tls/metastore",
        default_index_root_uri="ram:///tls/indexes",
        tls_cert_path=str(cert), tls_key_path=str(key),
        tls_ca_path=str(cert)), storage_resolver=q.storage.StorageResolver
        .for_test())
    server = q.serve.RestServer(node)
    server.start()
    try:
        context = ssl.create_default_context(cafile=str(cert))
        with urllib.request.urlopen(
                f"https://127.0.0.1:{server.port}/api/v1/cluster",
                context=context, timeout=10) as response:
            cluster = json.loads(response.read())
        assert cluster["node_id"] == "tls-node"
        client = q.http_client.HttpSearchClient(
            f"127.0.0.1:{server.port}", **node.config.client_tls_kwargs())
        info = client.heartbeat({"node_id": "probe", "roles": ["searcher"],
                                 "rest_endpoint": "127.0.0.1:9"})
        assert info["node_id"] == "tls-node"
        plain = q.http_client.HttpSearchClient(f"127.0.0.1:{server.port}")
        with pytest.raises(q.http_client.HttpTransportError):
            plain.heartbeat({"node_id": "x", "roles": []})
    finally:
        server.stop()


def test_scroll_survives_node_restart_via_replica(clusters):
    """Scroll contexts replicate to the best-affinity peer: losing the
    serving node's in-memory store does not kill live scrolls."""
    def scenario(c):
        q, nodes = c.q, c.nodes
        membership = q.mod("cluster.membership")
        replacement = q.serve.RestServer(nodes[1], host="127.0.0.1", port=0)
        replacement.start()
        servers = [c.servers[0], replacement]
        c.servers = servers   # stopped with the module's servers
        for i in range(2):
            nodes[i].cluster.upsert_heartbeat(membership.ClusterMember(
                node_id=f"mn-{1 - i}",
                roles=("searcher", "indexer", "metastore"),
                rest_endpoint=f"127.0.0.1:{servers[1 - i].port}"))
        nodes[0].clients.pop("mn-1", None)
        nodes[0]._on_cluster_change(membership.ClusterChange(
            "update", membership.ClusterMember(
                "mn-1", ("searcher", "indexer", "metastore"),
                rest_endpoint=f"127.0.0.1:{replacement.port}")))
        port0 = servers[0].port
        status, _ = send(port0, "POST", "/api/v1/indexes",
                         {**INDEX_CONFIG, "index_id": "scr-logs"})
        assert status == 200
        docs = "\n".join(json.dumps({"ts": 1_700_000_000 + i,
                                     "body": f"scroll doc {i}"})
                         for i in range(40)).encode()
        status, _ = send(port0, "POST",
                         "/api/v1/scr-logs/ingest?commit=force", docs)
        assert status == 200
        status, page1 = send(port0, "GET",
                             "/api/v1/scr-logs/search?query=*&max_hits=10"
                             "&scroll=1m")
        assert status == 200 and len(page1["hits"]) == 10
        nodes[0].scroll_store._contexts.clear()   # a restart
        status, page2 = send(port0, "GET",
                             f"/api/v1/scroll?scroll_id={page1['scroll_id']}")
        assert status == 200, page2
        assert len(page2["hits"]) == 10
        ids1 = {json.dumps(h, sort_keys=True) for h in page1["hits"]}
        ids2 = {json.dumps(h, sort_keys=True) for h in page2["hits"]}
        assert not ids1 & ids2
        return [page1, page2]
    try:
        both(clusters, scenario)
    finally:
        for c in clusters.values():
            c.servers[1].stop()


@pytest.mark.parametrize("root", PACKAGES)
def test_mtls_requires_client_certificate(root, cert):
    q = load(root)
    cert, key = cert
    node = q.serve.Node(node_config(
        q, node_id="mtls-node", metastore_uri="ram:///mtls/metastore",
        default_index_root_uri="ram:///mtls/indexes",
        tls_cert_path=str(cert), tls_key_path=str(key),
        tls_ca_path=str(cert), tls_verify_client=True),
        storage_resolver=q.storage.StorageResolver.for_test())
    server = q.serve.RestServer(node)
    server.start()
    try:
        bare = q.http_client.HttpSearchClient(
            f"127.0.0.1:{server.port}", tls=True, ca_path=str(cert))
        with pytest.raises(q.http_client.HttpTransportError):
            bare.heartbeat({"node_id": "x", "roles": []})
        client = q.http_client.HttpSearchClient(
            f"127.0.0.1:{server.port}", **node.config.client_tls_kwargs())
        info = client.heartbeat({"node_id": "probe", "roles": ["searcher"],
                                 "rest_endpoint": "127.0.0.1:9"})
        assert info["node_id"] == "mtls-node"
    finally:
        server.stop()


# --- a mixed cluster -------------------------------------------------------

MIXED_REQUESTS = [
    ("GET", "/api/v1/mx-logs/search?query=shared&max_hits=7"),
    # every doc: each split's docs are fetched from the node that holds it
    ("GET", "/api/v1/mx-logs/search?query=*&max_hits=200&sort_by=-ts"),
    ("POST", "/api/v1/_elastic/mx-logs/_search",
     {"query": {"match": {"body": "doc"}}, "size": 5,
      "aggs": {"over_time": {"date_histogram": {"field": "ts",
                                                "fixed_interval": "1m"}}}}),
]


def _spy(node, peer_id, calls, name):
    """Count the leaf requests and doc fetches `node` sends its peer over
    HTTP (`/internal/leaf_search`, `/internal/fetch_docs`)."""
    client = node.clients[peer_id]
    for method in ("leaf_search", "fetch_docs"):
        inner = getattr(client, method)

        def wrapped(*args, _inner=inner, _method=method, **kwargs):
            calls[(name, _method)] = calls.get((name, _method), 0) + 1
            return _inner(*args, **kwargs)
        setattr(client, method, wrapped)


def test_mixed_cluster_both_ways(tmp_path):
    """A JAX node and a port node over the same `file://` bytes: the root
    on each fans leaf requests and doc fetches out to the other, and
    answers as a single-node root over the same splits does. A fake clock
    and a seeded RNG fix the split ids, and with them the rendezvous
    placement of the 8 splits over the two nodes."""
    base = tmp_path.as_uri()
    config = dict(metastore_uri=f"{base}/metastore",
                  default_index_root_uri=f"{base}/indexes")
    nodes, servers, calls = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        force_python_paths(mp)
        try:
            for root in PACKAGES:
                q = load(root)
                stack.enter_context(deterministic(mp, q))
                node = q.serve.Node(
                    node_config(q, node_id=f"mx-{root}", **config),
                    storage_resolver=q.storage.StorageResolver.default())
                server = q.serve.RestServer(node)
                server.start()
                nodes[root], servers[root] = node, server
            jax_root, port_root = PACKAGES
            # each heartbeats the other through its own package's client
            for me, peer in ((jax_root, port_root), (port_root, jax_root)):
                q = load(me)
                q.http_client.HttpSearchClient(servers[peer].endpoint) \
                    .heartbeat({"node_id": nodes[me].config.node_id,
                                "roles": list(nodes[me].config.roles),
                                "rest_endpoint": servers[me].endpoint})
            status, _ = send(servers[jax_root].port, "POST",
                             "/api/v1/indexes",
                             {**INDEX_CONFIG, "index_id": "mx-logs",
                              "indexing_settings":
                                  {"split_num_docs_target": 25}})
            assert status == 200
            docs = "\n".join(json.dumps({"ts": 1_600_000_000 + 7 * i,
                                         "body": f"doc {i} shared"})
                             for i in range(200)).encode()
            status, result = send(servers[port_root].port, "POST",
                                  "/api/v1/mx-logs/ingest?commit=force",
                                  docs)
            assert status == 200 and result["num_ingested_docs"] == 200
            # what a polling interval would do: the JAX node created the
            # index and the port node wrote its splits
            for node in nodes.values():
                node.metastore.refresh()

            # the reference: a port node alone over the same files
            q = load(port_root)
            alone = q.serve.Node(node_config(q, node_id="alone", **config),
                                 storage_resolver=q.storage.StorageResolver
                                 .default())
            alone_server = q.serve.RestServer(alone)
            alone_server.start()
            servers["alone"] = alone_server
            for me, peer in ((jax_root, port_root), (port_root, jax_root)):
                assert type(nodes[me].clients[f"mx-{peer}"]).__name__ == \
                    "HttpSearchClient"
                _spy(nodes[me], f"mx-{peer}", calls, me)
            for method, path, *body in MIXED_REQUESTS:
                status, want = send(alone_server.port, method, path, *body)
                assert status == 200
                for root in PACKAGES:
                    status, got = send(servers[root].port, method, path,
                                       *body)
                    assert status == 200
                    assert_same_json(strip(want), strip(got))
            # every root reached its peer, for leaves and for docs
            for root in PACKAGES:
                for method in ("leaf_search", "fetch_docs"):
                    assert calls.get((root, method), 0) > 0, (root, method)
        finally:
            for server in servers.values():
                server.stop()
