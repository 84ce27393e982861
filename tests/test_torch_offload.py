"""Leaf-search offload through the port's node, against the JAX package's.

`tests/test_offload.py`'s two scenarios (reference: quickwit-lambda-client
invoker + the local/offload scheduling split at leaf.rs:1658,1828) run in
each package, the port's nodes on the CPU: a main node whose leaf sends
its cold tail to a worker node over the internal protocol, and a main
node whose only worker is unreachable, so that every offloaded split runs
locally. Each package's observations (answers, offloaded counts and the
`qw_offload_*` metric deltas) must be equal.
"""

import json

import pytest

from test_torch_rest_api import (PACKAGES, deterministic, force_python_paths,
                                 load, send, strip)

NUM_SPLITS = 6
DOCS_PER_SPLIT = 30

OFFLOAD_SERIES = (("OFFLOAD_SPLITS_TOTAL", {"outcome": "remote"}),
                  ("OFFLOAD_SPLITS_TOTAL", {"outcome": "fallback_local"}),
                  ("OFFLOAD_DISPATCHES_TOTAL", {"outcome": "ok"}),
                  ("OFFLOAD_DISPATCHES_TOTAL", {"outcome": "error"}))


def metric_values(q):
    metrics = q.mod("observability.metrics")
    return [getattr(metrics, name).get(**labels)
            for name, labels in OFFLOAD_SERIES]


def deltas(q, before):
    return [after - b for after, b in zip(metric_values(q), before)]


def node(q, resolver, servers, node_id, **kw):
    n = q.serve.Node(q.serve.NodeConfig(
        node_id=node_id, rest_port=0, **kw,
        **({"device": "cpu"} if q.is_port else {})),
        storage_resolver=resolver)
    server = q.serve.RestServer(n, host="127.0.0.1", port=0)
    server.start()
    servers.append(server)
    return n, server


def offload_to_worker(q):
    """`test_offload_splits_to_worker`: six splits, a local budget of 2,
    one worker node over the same storage."""
    resolver = q.storage.StorageResolver.for_test()
    servers = []
    try:
        _, worker_server = node(q, resolver, servers, "offload-worker",
                                roles=("searcher",),
                                metastore_uri="ram:///ol/metastore",
                                default_index_root_uri="ram:///ol/idx")
        main, main_server = node(
            q, resolver, servers, "offload-main",
            metastore_uri="ram:///ol/metastore",
            default_index_root_uri="ram:///ol/idx",
            offload_endpoint=f"127.0.0.1:{worker_server.port}",
            offload_max_local_splits=2)
        port = main_server.port
        status, _ = send(port, "POST", "/api/v1/indexes", {
            "index_id": "ol-logs",
            "doc_mapping": {"field_mappings": [
                {"name": "body", "type": "text"},
                {"name": "n", "type": "i64", "fast": True}]}})
        assert status == 200
        for s in range(NUM_SPLITS):
            docs = [{"body": f"payload token{s}", "n": s * 100 + i}
                    for i in range(DOCS_PER_SPLIT)]
            ndjson = "\n".join(json.dumps(d) for d in docs).encode()
            status, _ = send(port, "POST",
                             "/api/v1/ol-logs/ingest?commit=force", ndjson)
            assert status == 200
        before = metric_values(q)
        status, result = send(
            port, "GET", "/api/v1/ol-logs/search?query=body:payload"
                         "&max_hits=5")
        assert status == 200
        assert result["num_hits"] == NUM_SPLITS * DOCS_PER_SPLIT
        rest_deltas = deltas(q, before)

        # the main node kept at most its local budget; the rest ran
        # remotely (resource stats ride the leaf response into the merge)
        base = q.mod("metastore.base")
        models = q.mod("search.models")
        state = q.mod("models.split_metadata").SplitState
        metadata = main.metastore.index_metadata("ol-logs")
        splits = [models.SplitIdAndFooter(
            split_id=s.metadata.split_id,
            storage_uri=metadata.index_config.index_uri,
            num_docs=s.metadata.num_docs)
            for s in main.metastore.list_splits(base.ListSplitsQuery(
                index_uids=[metadata.index_uid],
                states=[state.PUBLISHED]))]
        assert len(splits) == NUM_SPLITS
        before = metric_values(q)
        leaf = main.search_service.leaf_search(models.LeafSearchRequest(
            search_request=models.SearchRequest(
                index_ids=["ol-logs"],
                query_ast=q.mod("query.ast").FullText("body", "payload",
                                                      "and"),
                max_hits=5),
            index_uid=metadata.index_uid,
            doc_mapping=metadata.index_config.doc_mapper.to_dict(),
            splits=splits))
        assert leaf.num_hits == NUM_SPLITS * DOCS_PER_SPLIT
        offloaded = leaf.resource_stats.get("num_splits_offloaded", 0)
        assert offloaded >= NUM_SPLITS - 2
        return {"rest": strip(result), "rest_deltas": rest_deltas,
                "leaf_hits": leaf.num_hits, "offloaded": offloaded,
                "leaf_deltas": deltas(q, before),
                # split ids carry the wall clock: name each by its rank
                "hits": sorted((sorted(s.split_id for s in splits).index(
                    h.split_id), h.doc_id) for h in leaf.partial_hits)}
    finally:
        for server in servers:
            server.stop()


def offload_failure(q):
    """`test_offload_failure_falls_back_local`: an unreachable worker, a
    local budget of 1; every split is answered locally."""
    resolver = q.storage.StorageResolver.for_test()
    servers = []
    try:
        _, server = node(q, resolver, servers, "fb",
                         metastore_uri="ram:///fb/metastore",
                         default_index_root_uri="ram:///fb/idx",
                         offload_endpoint="127.0.0.1:1",
                         offload_max_local_splits=1)
        status, _ = send(server.port, "POST", "/api/v1/indexes", {
            "index_id": "fb-logs",
            "doc_mapping": {"field_mappings": [
                {"name": "body", "type": "text"}]}})
        assert status == 200
        for _ in range(3):
            ndjson = "\n".join(json.dumps({"body": "common word"})
                               for _ in range(10)).encode()
            status, _ = send(server.port, "POST",
                             "/api/v1/fb-logs/ingest?commit=force", ndjson)
            assert status == 200
        before = metric_values(q)
        status, result = send(server.port, "GET",
                              "/api/v1/fb-logs/search?query=body:common")
        assert status == 200
        assert result["num_hits"] == 30   # all splits answered locally
        return {"rest": strip(result), "deltas": deltas(q, before)}
    finally:
        for server in servers:
            server.stop()


def run(scenario, root):
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        q = load(root)
        with deterministic(mp, q, fake_clock=False):
            return scenario(q)


@pytest.fixture(scope="module")
def observed():
    return {(scenario.__name__, root): run(scenario, root)
            for scenario in (offload_to_worker, offload_failure)
            for root in PACKAGES}


def test_offload_splits_to_worker(observed):
    got = observed[("offload_to_worker", "quickwit_tpu_torch")]
    assert got["leaf_hits"] == NUM_SPLITS * DOCS_PER_SPLIT
    assert got["offloaded"] >= NUM_SPLITS - 2
    # the REST search: 4 of 6 splits served by the worker, none fell back
    remote, fallback, ok, error = got["rest_deltas"]
    assert (remote, fallback, error) == (NUM_SPLITS - 2, 0, 0) and ok >= 1


def test_offload_failure_falls_back_local(observed):
    got = observed[("offload_failure", "quickwit_tpu_torch")]
    remote, fallback, ok, error = got["deltas"]
    assert (remote, fallback, ok) == (0, 2, 0) and error >= 1


@pytest.mark.parametrize("scenario", ["offload_to_worker",
                                      "offload_failure"])
def test_observations_equal_the_jax_package(observed, scenario):
    want = observed[(scenario, "quickwit_tpu")]
    got = observed[(scenario, "quickwit_tpu_torch")]
    assert got == want
