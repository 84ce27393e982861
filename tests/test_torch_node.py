"""Node-level scenarios in both packages, with equal results.

The scenarios of the modules that came before the node and waited for
it: `test_control_plane.py::test_node_autoscale_opens_and_closes_shards`,
`test_kafka_source.py::test_node_drives_kafka_source`,
`test_cooperative.py::test_node_cooperative_drain_phases_and_metrics`,
`tests/test_control_plane_convergence.py` (4),
`tests/test_model_check_control_plane.py` (4, the BFS over failure
interleavings included) and the five two-node scenarios of
`tests/test_replication.py`. Each runs in each package on the CPU
(the port's nodes on `device="cpu"`) and returns what it observed; the
observations must be equal across the packages. The RNG and the uuids
that name indexes are seeded per package; the convergence scenarios run
on a `FakeClock`, as the JAX file does, the others on the real clock.

Then the refusals: what later slices of the port bring raises in
`Node.__init__` (`grpc_port`, `offload`, `offload_endpoint`, a
`sqlite://` metastore) or answers 501 (`POST /api/v1/_sql`), naming the
missing module. Each case is replaced by the scenarios of its module
when that module lands.
"""

import json
import threading

import pytest

from test_torch_rest_api import (PACKAGES, deterministic, force_python_paths,
                                 load, send)


def node_config(q, **kw):
    return q.serve.NodeConfig(rest_port=0, **kw,
                              **({"device": "cpu"} if q.is_port else {}))


def new_node(q, resolver=None, **kw):
    return q.serve.Node(node_config(q, **kw),
                        storage_resolver=resolver
                        or q.storage.StorageResolver.for_test())


def run_both(scenario, *args, fake_clock=False):
    """`scenario(q, *args)` in each package under a seeded RNG and seeded
    uuids (and a `FakeClock` when asked); the observations must be
    equal. Returns the port's."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        force_python_paths(mp)
        for root in PACKAGES:
            q = load(root)
            with deterministic(mp, q, fake_clock=fake_clock):
                out[root] = scenario(q, *args)
    assert out["quickwit_tpu_torch"] == out["quickwit_tpu"]
    return out["quickwit_tpu_torch"]


# --- the shard autoscaler ----------------------------------------------------

def autoscale(q, tmp_path):
    router = q.mod("ingest.router")
    ingester_mod = q.mod("ingest.ingester")
    node = new_node(q, node_id="scale-node",
                    metastore_uri="ram:///scale/metastore",
                    default_index_root_uri="ram:///scale/idx",
                    data_dir=str(tmp_path / q.root), wal_fsync=False,
                    max_shard_throughput_mib=0.001)
    now = [0.0]
    node.shard_rate_tracker.clock = lambda: now[0]
    node.scaling_permits = q.mod("control_plane.arbiter").ScalingPermits(
        clock=lambda: now[0])
    source = router.INGEST_V2_SOURCE_ID
    node.ingester.open_shard("idx:01", source, "s-00")
    qid = ingester_mod.shard_queue_id("idx:01", source, "s-00")
    for _ in range(30):
        node.ingester.persist("idx:01", source, "s-00",
                              [{"n": i, "pad": "x" * 200} for i in range(50)])
        bytes_now = node.ingester.shard_throughput_state()[qid]["bytes"]
        node.shard_rate_tracker.observe(qid, bytes_now)
        now[0] += 1.0
    actions = node.autoscale_shards()

    def open_shards():
        return sorted(s.shard_id for s in node.ingester.list_shards("idx:01")
                      if s.state is ingester_mod.ShardState.OPEN)
    after_up = open_shards()
    down = []
    for _ in range(10):
        now[0] += 120.0
        down.append([list(a) for a in node.autoscale_shards()])
    return [[list(a) for a in actions], after_up, down, open_shards()]


def test_node_autoscale_opens_and_closes_shards(tmp_path):
    actions, after_up, down, final = run_both(autoscale, tmp_path)
    assert [a for a in actions if a[0] == "open"]
    assert len(after_up) >= 2
    assert len(final) == 1   # back to min_shards


# --- a Kafka source drained by the node --------------------------------------

def kafka_node(q):
    broker = q.mod("indexing.fake_kafka").FakeKafkaBroker()
    node = new_node(q, node_id="kn", metastore_uri="ram:///kn/ms",
                    default_index_root_uri="ram:///kn/idx")
    server = q.serve.RestServer(node, host="127.0.0.1", port=0)
    server.start()
    try:
        broker.create_topic("node-logs")
        broker.seed("node-logs", 0, [json.dumps(
            {"body": f"hello {i}"}).encode() for i in range(25)])
        status, _ = send(server.port, "POST", "/api/v1/indexes", {
            "index_id": "klogs",
            "doc_mapping": {"field_mappings": [
                {"name": "body", "type": "text"}]}})
        assert status == 200
        status, _ = send(server.port, "POST", "/api/v1/indexes/klogs/sources", {
            "source_id": "kafka-src", "source_type": "kafka",
            "params": {"topic": "node-logs",
                       "client_params": {"bootstrap.servers":
                                         f"{broker.host}:{broker.port}"}}})
        assert status == 200
        seen = [node.run_source_pass("klogs", "kafka-src").num_docs_processed]
        status, result = send(server.port, "GET",
                              "/api/v1/klogs/search?query=body:hello")
        assert status == 200
        seen.append(result["num_hits"])
        seen.append(node.run_source_pass("klogs", "kafka-src")
                    .num_docs_processed)
        broker.seed("node-logs", 0, [b'{"body": "hello tail"}'])
        seen.append(node.run_source_pass("klogs", "kafka-src")
                    .num_docs_processed)
        return seen
    finally:
        server.stop()
        node.stop_background_services()
        broker.stop()


def test_node_drives_kafka_source():
    assert run_both(kafka_node) == [25, 25, 0, 1]


# --- cooperative drains --------------------------------------------------------

class VirtualClock:
    def __init__(self, start=0.0):
        self.now = start

    def __call__(self):
        return self.now


def cooperative(q):
    node = new_node(q, node_id="coop", metastore_uri="ram:///coop/ms",
                    default_index_root_uri="ram:///coop/idx",
                    cooperative_indexing=True)
    clock = VirtualClock(start=100.0)
    node._coop_clock = clock
    node.index_service.create_index({
        "version": "0.8", "index_id": "logs",
        "doc_mapping": {"field_mappings": [
            {"name": "body", "type": "text"}]},
        "indexing_settings": {"commit_timeout_secs": 60}})
    node.ingest_v2("logs", [{"body": f"doc {i}"} for i in range(5)])
    metadata = node.metastore.index_metadata("logs")
    node._cooperative_drain(metadata)
    uid = metadata.index_uid
    assert uid in node._coop_cycles
    first_wake = node._coop_next_wake[uid]
    clock.now = first_wake + 0.01
    node._cooperative_drain(metadata)
    assert node.pipeline_metrics[uid].cpu_load_mcpu >= 0
    result = node.root_searcher.search(q.mod("search.models").SearchRequest(
        index_ids=["logs"], query_ast=q.mod("query.ast").MatchAll(),
        max_hits=10))
    next_wake = node._coop_next_wake[uid]
    assert next_wake > clock.now + 50.0
    return [first_wake, result.num_hits, next_wake]


def test_node_cooperative_drain_phases_and_metrics():
    assert run_both(cooperative)[1] == 5


# --- control-plane convergence (tests/test_control_plane_convergence.py) -----

def convergence_cluster(q, tmp_path):
    resolver = q.storage.StorageResolver.for_test()
    nodes, servers = [], []
    for i in range(2):
        node = new_node(q, resolver, node_id=f"cp-{i}",
                        metastore_uri="ram:///cp/ms",
                        default_index_root_uri="ram:///cp/idx")
        server = q.serve.RestServer(node)
        server.start()
        nodes.append(node)
        servers.append(server)
    for i, node in enumerate(nodes):
        q.http_client.HttpSearchClient(servers[1 - i].endpoint).heartbeat({
            "node_id": node.config.node_id,
            "roles": list(node.config.roles),
            "rest_endpoint": servers[i].endpoint})
    files = []
    for n in range(2):
        path = tmp_path / f"src{n}.ndjson"
        path.write_text("\n".join(
            json.dumps({"ts": 1000 + n * 100 + i, "body": f"doc s{n} {i}"})
            for i in range(5)))
        files.append(str(path))
    nodes[0].index_service.create_index({
        "index_id": "cp-logs",
        "doc_mapping": {"field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "body", "type": "text"}],
            "timestamp_field": "ts"},
        "search_settings": {"default_search_fields": ["body"]}})
    source_config = q.mod("models.index_metadata").SourceConfig
    uid = nodes[0].metastore.index_metadata("cp-logs").index_uid
    for n, path in enumerate(files):
        nodes[0].metastore.add_source(uid, source_config(
            f"file-{n}", "file", params={"filepath": path}))
    return nodes, servers, uid


def with_cluster(body):
    def scenario(q, tmp_path):
        nodes, servers, uid = convergence_cluster(q, tmp_path)
        try:
            return body(q, nodes, uid)
        finally:
            for server in servers:
                server.stop()
    return scenario


def tasks(node):
    return sorted(t["source_id"] for t in node.indexing_tasks())


@with_cluster
def plan_applies(q, nodes, uid):
    out = nodes[0].run_control_plane_pass()
    gates = [[node.source_assignment_allows(uid, s)
              for s in ("file-0", "file-1")] for node in nodes]
    out2 = nodes[0].run_control_plane_pass()
    follower = nodes[1].run_control_plane_pass()
    return [out, [tasks(n) for n in nodes], gates, out2, follower]


def test_plan_applies_and_gates_sources(tmp_path):
    out, node_tasks, gates, out2, follower = run_both(
        plan_applies, tmp_path, fake_clock=True)
    assert out["role"] == "leader" and out["drift"] is True
    assert out["nodes_applied"] == 2 and out["planned_tasks"] == 3
    assert sorted(t for ts in node_tasks for t in ts
                  if t.startswith("file-")) == ["file-0", "file-1"]
    for mine, gate in zip(node_tasks, gates):
        assert [s in mine for s in ("file-0", "file-1")] == gate
        assert any(gate)
    assert out2["drift"] is False
    assert follower == {"role": "follower"}


@with_cluster
def drift_on_death(q, nodes, uid):
    nodes[0].run_control_plane_pass()
    before = [t for t in tasks(nodes[0]) if t.startswith("file-")]
    member = nodes[0].cluster.member("cp-1")
    member.last_heartbeat = q.clock.monotonic() - 10_000
    out = nodes[0].run_control_plane_pass()
    after = [t for t in tasks(nodes[0]) if t.startswith("file-")]
    return [before, out, after,
            [nodes[0].source_assignment_allows(uid, s)
             for s in ("file-0", "file-1")]]


def test_drift_reassigns_when_indexer_dies(tmp_path):
    before, out, after, gates = run_both(drift_on_death, tmp_path,
                                         fake_clock=True)
    assert len(before) == 1 and out["drift"] is True
    assert after == ["file-0", "file-1"] and gates == [True, True]


@with_cluster
def restarted_indexer(q, nodes, uid):
    nodes[0].run_control_plane_pass()
    applied_before = nodes[1].indexing_tasks_report()["applied"]
    nodes[1]._applied_indexing_tasks = None
    nodes[1]._assigned_sources = set()
    out = nodes[0].run_control_plane_pass()
    return [applied_before, out, nodes[1].indexing_tasks_report()["applied"],
            tasks(nodes[1])]


def test_restarted_indexer_reconverges(tmp_path):
    applied_before, out, applied, node1_tasks = run_both(
        restarted_indexer, tmp_path, fake_clock=True)
    assert applied_before is True and out["drift"] is True
    assert applied is True and node1_tasks
    assert out["nodes_applied"] == 1


@with_cluster
def legacy_election(q, nodes, uid):
    return nodes[0].source_assignment_allows(uid, "file-0")


def test_no_plan_means_legacy_election(tmp_path):
    assert run_both(legacy_election, tmp_path, fake_clock=True) is None


# --- the bounded model check (tests/test_model_check_control_plane.py) -------

NODE_IDS = ("m0", "m1", "m2")
SOURCES = ("file-0", "file-1")
MAX_DEPTH = 6
CONVERGE_PASSES = 4
ACTIONS = ("pass", "kill-0", "revive-0", "restart-1", "cut-1", "heal-1")


class FakeClient:
    """The wire, minus the wire: the two control-plane RPCs go straight
    to the peer object; raises when the model partitioned or killed it."""

    def __init__(self, world, peer_id):
        self.world = world
        self.peer_id = peer_id

    def _post(self, path, body):
        if self.peer_id in self.world.dead or \
                self.peer_id in self.world.cut:
            raise ConnectionError(f"{self.peer_id} unreachable")
        peer = self.world.nodes[self.peer_id]
        if path == "/internal/indexing_tasks":
            return peer.indexing_tasks_report()
        if path == "/internal/apply_indexing_plan":
            return peer.apply_indexing_plan(body.get("tasks", []))
        raise AssertionError(f"unexpected RPC {path}")


class World:
    """Three all-role nodes of one package sharing a metastore, one index
    with two external sources."""

    def __init__(self, q, resolver):
        self.q = q
        self.nodes = {}
        self.dead, self.cut = set(), set()
        for node_id in NODE_IDS:
            self.nodes[node_id] = new_node(
                q, resolver, node_id=node_id, metastore_uri="ram:///mc/ms",
                default_index_root_uri="ram:///mc/idx")
        member = q.mod("cluster.membership").ClusterMember
        for node in self.nodes.values():
            for peer_id, peer in self.nodes.items():
                if peer_id != node.config.node_id:
                    node.cluster.upsert_heartbeat(member(
                        peer_id, tuple(peer.config.roles)))
                    node.clients[peer_id] = FakeClient(self, peer_id)
        first = self.nodes["m0"]
        first.index_service.create_index({
            "index_id": "mc", "doc_mapping": {"field_mappings": [
                {"name": "body", "type": "text"}]}})
        self.uid = first.metastore.index_metadata("mc").index_uid
        source_config = q.mod("models.index_metadata").SourceConfig
        for source_id in SOURCES:
            first.metastore.add_source(self.uid, source_config(
                source_id, "file", params={"filepath": "/dev/null"}))

    def alive(self):
        return [n for n in NODE_IDS if n not in self.dead]

    def leader_id(self):
        return min(self.alive())

    def set_liveness(self, node_id, alive):
        stamp = self.q.clock.monotonic() - (0 if alive else 10_000)
        for node in self.nodes.values():
            member = node.cluster.member(node_id)
            if member is not None:
                member.last_heartbeat = stamp
                member.intervals.clear()

    def apply(self, action):
        if action == "pass":
            self.nodes[self.leader_id()].run_control_plane_pass()
        elif action == "kill-0":
            self.dead.add("m0")
            self.set_liveness("m0", False)
        elif action == "revive-0":
            self.dead.discard("m0")
            self.set_liveness("m0", True)
        elif action == "restart-1":
            node = self.nodes["m1"]
            node._applied_indexing_tasks = None
            node._assigned_sources = set()
        elif action == "cut-1":
            self.cut.add("m1")
        elif action == "heal-1":
            self.cut.discard("m1")
        else:
            raise AssertionError(action)

    def enabled(self, action):
        return {"pass": True,
                "kill-0": "m0" not in self.dead,
                "revive-0": "m0" in self.dead,
                "restart-1": "m1" not in self.dead,
                "cut-1": "m1" not in self.cut and "m1" not in self.dead,
                "heal-1": "m1" in self.cut}[action]

    def fingerprint(self):
        per_node = []
        for node_id in NODE_IDS:
            applied = self.nodes[node_id]._applied_indexing_tasks
            per_node.append((applied is None, tuple(sorted(
                (t["index_uid"], t["source_id"]) for t in (applied or [])))))
        return (frozenset(self.dead), frozenset(self.cut), tuple(per_node))

    def consumers(self, source_id):
        out = []
        for node_id in self.alive():
            node = self.nodes[node_id]
            allowed = node.source_assignment_allows(self.uid, source_id)
            if allowed is None:
                allowed = node.owns_index(self.uid)
            if allowed:
                out.append(node_id)
        return out


def materialize(q, seq):
    """A fresh world on fresh storage after the actions of `seq`. Each
    world draws a new index uid from the package's seeded uuids, as each
    JAX world draws a random one: the fingerprints carry it, so the BFS
    explores the same states in both packages."""
    world = World(q, q.storage.StorageResolver.for_test())
    for action in seq:
        world.apply(action)
    return world


def check_convergence(world, trace):
    """Quiet the network and require the pass loop to converge, then one
    consumer per source and a plan on every alive node."""
    world.cut.clear()
    leader = world.nodes[world.leader_id()]
    outs = []
    for _ in range(CONVERGE_PASSES):
        outs.append(leader.run_control_plane_pass())
        if outs[-1]["drift"] is False:
            break
    assert outs[-1]["drift"] is False, trace
    owners = [world.consumers(s) for s in SOURCES]
    assert all(len(o) == 1 for o in owners), (owners, trace)
    for node_id in world.alive():
        assert world.nodes[node_id].indexing_tasks_report()["applied"], \
            (node_id, trace)
    return [outs, owners]


def model_check(q):
    """The BFS over failure interleavings; returns every reachable state
    in discovery order with its convergence outcome."""
    seen = {materialize(q, ()).fingerprint()}
    frontier = [()]
    explored, transitions = [], 0
    while frontier:
        next_frontier = []
        for seq in frontier:
            if len(seq) >= MAX_DEPTH:
                continue
            for action in ACTIONS:
                world = materialize(q, seq)
                if not world.enabled(action):
                    continue
                world.apply(action)
                transitions += 1
                fp = world.fingerprint()
                if fp in seen:
                    continue
                seen.add(fp)
                next_frontier.append(seq + (action,))
                explored.append([list(seq + (action,)), repr(fp),
                                 check_convergence(world, seq + (action,))])
        frontier = next_frontier
    return [explored, transitions]


def test_model_check_convergence():
    explored, transitions = run_both(model_check)
    assert len(explored) >= 1_500, len(explored)
    assert transitions >= 1_500, transitions


def leader_failover(q):
    world = materialize(q, ("pass",))
    before = {s: world.consumers(s) for s in SOURCES}
    world.apply("kill-0")
    leader = world.leader_id()
    out = world.nodes[leader].run_control_plane_pass()
    return [before, leader, out, {s: world.consumers(s) for s in SOURCES}]


def test_leader_failover_reassigns():
    before, leader, out, after = run_both(leader_failover)
    assert all(len(v) == 1 for v in before.values())
    assert leader == "m1" and out["drift"] is True
    for owners in after.values():
        assert len(owners) == 1 and owners != ["m0"]


def restarted_rejoins(q):
    world = materialize(q, ("pass", "restart-1"))
    applied = world.nodes["m1"].indexing_tasks_report()["applied"]
    return [applied, check_convergence(world, ("pass", "restart-1"))]


def test_restarted_node_rejoins_plan():
    applied, _ = run_both(restarted_rejoins)
    assert applied is False


def partitioned_keeps_slice(q):
    world = materialize(q, ("pass", "cut-1"))
    old = tasks(world.nodes["m1"])
    world.nodes[world.leader_id()].run_control_plane_pass()
    kept = tasks(world.nodes["m1"])
    return [old, kept, check_convergence(world, ("pass", "cut-1"))]


def test_partitioned_node_keeps_old_slice_until_heal():
    old, kept, _ = run_both(partitioned_keeps_slice)
    assert kept == old


# --- two-node replication (tests/test_replication.py) ------------------------

REP_INDEX = {
    "index_id": "rep-logs",
    "doc_mapping": {
        "field_mappings": [
            {"name": "ts", "type": "datetime", "fast": True,
             "input_formats": ["unix_timestamp"]},
            {"name": "body", "type": "text"},
        ],
        "timestamp_field": "ts",
        "default_search_fields": ["body"],
    },
}


def replicated(body):
    """`body(q, nodes, servers, uid)` over two replicating nodes (RF 2)
    of one package with the `rep-logs` index created."""
    def scenario(q, tmp_path):
        resolver = q.storage.StorageResolver.for_test()
        nodes, servers = [], []
        for i in range(2):
            node = new_node(q, resolver, node_id=f"rep-{i}",
                            metastore_uri="ram:///rep/metastore",
                            default_index_root_uri="ram:///rep/indexes",
                            data_dir=str(tmp_path / q.root / f"node{i}"),
                            wal_fsync=False, replication_factor=2)
            server = q.serve.RestServer(node)
            server.start()
            nodes.append(node)
            servers.append(server)
        member = q.mod("cluster.membership").ClusterMember
        for i, node in enumerate(nodes):
            node.cluster.upsert_heartbeat(member(
                node_id=f"rep-{1 - i}",
                roles=("searcher", "indexer", "metastore"),
                rest_endpoint=f"127.0.0.1:{servers[1 - i].port}"))
        try:
            status, _ = send(servers[0].port, "POST", "/api/v1/indexes",
                             REP_INDEX)
            assert status == 200
            uid = nodes[0].metastore.index_metadata("rep-logs").index_uid
            return body(q, nodes, servers, uid)
        finally:
            for server in servers:
                server.stop()
    return scenario


def _hits(server):
    status, result = send(server.port, "GET",
                          "/api/v1/rep-logs/search?query=body:doc&max_hits=0")
    assert status == 200
    return result["num_hits"]


@replicated
def failover_loses_nothing(q, nodes, servers, uid):
    leader, follower = nodes
    seen = [leader.ingest_v2("rep-logs", [
        {"ts": 1_700_000_000 + batch * 10 + i,
         "body": f"replicated doc {batch}-{i}"} for i in range(10)])
        ["num_docs"] for batch in range(3)]
    shard_id = leader.ingester.list_shards(uid)[0].shard_id
    replica = follower.ingester.shard(uid, "_ingest-source", shard_id)
    seen += [replica.role, replica.log.next_position,
             leader.ingester.shard(uid, "_ingest-source", shard_id)
             .log.next_position]
    leader.run_ingest_pass("rep-logs")
    leader.ingest_v2("rep-logs", [
        {"ts": 1_700_000_100 + i, "body": f"post-crash doc {i}"}
        for i in range(5)])
    servers[0].stop()
    follower.cluster.leave("rep-0")
    seen.append(follower.promote_orphaned_replicas(grace_secs=3600))
    seen.append(follower.promote_orphaned_replicas(grace_secs=0)
                == [shard_id])
    follower.run_ingest_pass("rep-logs")
    seen.append(_hits(servers[1]))
    seen.append(follower.run_ingest_pass("rep-logs")
                .get("num_docs_indexed", 0))
    follower.config.replication_factor = 1
    follower.ingester.replicate_to = None
    follower.ingest_v2("rep-logs", [{"ts": 1_700_000_200,
                                     "body": "after failover doc"}])
    follower.run_ingest_pass("rep-logs")
    seen.append(_hits(servers[1]))
    return seen


def test_persist_replicates_and_failover_loses_nothing(tmp_path):
    assert run_both(failover_loses_nothing, tmp_path) == [
        10, 10, 10, "replica", 30, 30, [], True, 35, 0, 36]


@replicated
def gap_backfill(q, nodes, servers, uid):
    leader, follower = nodes
    leader.ingest_v2("rep-logs", [{"ts": 1, "body": "a"},
                                  {"ts": 2, "body": "b"}])
    shard_id = leader.ingester.list_shards(uid)[0].shard_id
    replica = follower.ingester.shard(uid, "_ingest-source", shard_id)
    replica.log.reset_to(0)
    reset = replica.log.next_position
    leader.ingest_v2("rep-logs", [{"ts": 3, "body": "c"}])
    return [reset, replica.log.next_position, len(replica.log.read_from(0))]


def test_gap_backfill_catches_up_fresh_follower(tmp_path):
    assert run_both(gap_backfill, tmp_path) == [0, 3, 3]


@replicated
def truncation(q, nodes, servers, uid):
    leader, follower = nodes
    leader.ingest_v2("rep-logs", [{"ts": i, "body": f"doc {i}"}
                                  for i in range(5)])
    shard_id = leader.ingester.list_shards(uid)[0].shard_id
    leader.run_ingest_pass("rep-logs")
    leader.ingest_v2("rep-logs", [{"ts": 99, "body": "tail doc"}])
    leader.run_ingest_pass("rep-logs")
    replica = follower.ingester.shard(uid, "_ingest-source", shard_id)
    return replica.publish_position


def test_truncation_propagates_to_replica(tmp_path):
    assert run_both(truncation, tmp_path) >= 5


@replicated
def chain_registry(q, nodes, servers, uid):
    leader, follower = nodes
    leader.ingest_v2("rep-logs", [{"ts": 1, "body": "a"}])
    shard_id = leader.ingester.list_shards(uid)[0].shard_id
    seen = [follower.metastore.shard_chain(uid, "_ingest-source", shard_id)]
    servers[0].stop()
    follower.cluster.leave("rep-0")
    follower.metastore.record_shard_chain(
        uid, "_ingest-source", shard_id, leader="rep-0", follower="rep-9")
    seen.append(follower.promote_orphaned_replicas(grace_secs=0))
    follower.metastore.record_shard_chain(
        uid, "_ingest-source", shard_id, leader="rep-0", follower="rep-1")
    seen.append(follower.promote_orphaned_replicas(grace_secs=0)
                == [shard_id])
    seen.append(follower.metastore.shard_chain(uid, "_ingest-source",
                                               shard_id))
    seen.append(follower.ingester.shard(uid, "_ingest-source",
                                        shard_id).role)
    return seen


def test_chain_registry_recorded_and_gates_promotion(tmp_path):
    assert run_both(chain_registry, tmp_path) == [
        {"leader": "rep-0", "follower": "rep-1"}, [], True,
        {"leader": "rep-1", "follower": None}, "leader"]


@replicated
def stale_leader_rejoin(q, nodes, servers, uid):
    leader, follower = nodes
    leader.ingest_v2("rep-logs", [
        {"ts": 1_700_000_000 + i, "body": f"doc {i}"} for i in range(5)])
    shard_id = leader.ingester.list_shards(uid)[0].shard_id
    servers[0].stop()
    follower.cluster.leave("rep-0")
    seen = [follower.promote_orphaned_replicas(grace_secs=0) == [shard_id]]
    follower.run_ingest_pass("rep-logs")
    seen.append(leader.ingester.shard(uid, "_ingest-source", shard_id).role)
    leader.metastore.refresh()
    seen.append(leader.reconcile_stale_leaders() == [shard_id])
    demoted = leader.ingester.shard(uid, "_ingest-source", shard_id)
    seen += [demoted.role, demoted.log.next_position,
             demoted.log.read_from(0)]
    with pytest.raises(ValueError, match="replica"):
        leader.ingester.persist(uid, "_ingest-source", shard_id, [{"n": 99}])
    return seen


def test_stale_leader_rejoin_demotes_via_registry(tmp_path):
    assert run_both(stale_leader_rejoin, tmp_path) == [
        True, "leader", True, "replica", 5, []]


# --- what later slices bring is refused ---------------------------------------

PORT = "quickwit_tpu_torch"


@pytest.mark.parametrize("config,module", [
    ({"grpc_port": 0}, "serve/grpc_server.py"),
    ({"offload": {"endpoints": ["127.0.0.1:1"]}}, "offload/"),
    ({"offload_endpoint": "127.0.0.1:1"}, "offload/"),
    ({"metastore_uri": "sqlite:///tmp/ms.db"}, "metastore/sql.py"),
], ids=["grpc_port", "offload", "offload_endpoint", "sqlite"])
def test_unported_options_are_refused(config, module):
    q = load(PORT)
    started = threading.active_count()
    kw = {"metastore_uri": "ram:///refuse/ms", **config}
    with pytest.raises(ValueError, match="not ported yet") as exc:
        new_node(q, node_id="refuse", **kw)
    assert module in str(exc.value) and "ROADMAP item" in str(exc.value)
    assert threading.active_count() == started   # nothing was started


def test_sql_route_answers_501():
    q = load(PORT)
    node = new_node(q, node_id="sql", metastore_uri="ram:///sql/ms",
                    default_index_root_uri="ram:///sql/idx")
    server = q.serve.RestServer(node)
    server.start()
    try:
        status, body = send(server.port, "POST", "/api/v1/_sql",
                            {"query": "SELECT COUNT(*) FROM x"})
        assert status == 501
        assert "analytics/sql.py" in body["message"]
        assert "ROADMAP item 14" in body["message"]
    finally:
        server.stop()


def test_peers_are_reached_over_http_even_when_they_advertise_grpc():
    q = load(PORT)
    node = new_node(q, node_id="me", metastore_uri="ram:///peer/ms",
                    default_index_root_uri="ram:///peer/idx")
    member = q.mod("cluster.membership").ClusterMember(
        "peer", ("searcher",), rest_endpoint="127.0.0.1:9",
        grpc_endpoint="127.0.0.1:10")
    node.cluster.upsert_heartbeat(member)
    client = node.clients["peer"]
    assert type(client) is q.http_client.HttpSearchClient
    assert node._grpc_advertise() == ""
