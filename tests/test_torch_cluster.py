"""The port's cluster membership and gossip against the JAX package's.

`tests/test_gossip.py`'s six scenarios (discovery and transitivity, a
dead node ageing out, garbage datagrams, a restarted node's new
generation, a foreign cluster id, phi-accrual against cadence) run in
both packages (`cluster/{membership,gossip}.py`), each on its own
package's `ScaledClock`. On top of those: phi-accrual over a seeded
heartbeat script under each package's `FakeClock` gives the same phi and
the same verdicts, to the bit; the change stream a `Cluster` publishes
through its `EventBroker` is the same; and a JAX `GossipService` and a
port one, on loopback UDP, discover each other and age each other out
(the datagrams are one wire format).
"""

import importlib
import random
import socket
from contextlib import ExitStack
from types import SimpleNamespace

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def load(root):
    membership = importlib.import_module(f"{root}.cluster.membership")
    return SimpleNamespace(
        root=root, clock=importlib.import_module(f"{root}.common.clock"),
        membership=membership, Cluster=membership.Cluster,
        ClusterMember=membership.ClusterMember,
        ClusterChange=membership.ClusterChange,
        GossipService=importlib.import_module(
            f"{root}.cluster.gossip").GossipService)


@pytest.fixture(params=PACKAGES)
def q(request):
    pkg = load(request.param)
    # 0.25: gossip rounds and poll sleeps run at a quarter of real time;
    # ageing and phi see the full virtual durations
    with pkg.clock.use_clock(pkg.clock.ScaledClock(factor=0.25)):
        yield pkg


def make_node(q, node_id, seeds=(), interval=0.05, dead_after=1.0,
              cluster_id="quickwit-tpu"):
    cluster = q.Cluster(node_id, ("searcher",), rest_endpoint="127.0.0.1:0",
                        dead_after_secs=dead_after)
    service = q.GossipService(cluster, node_id, ("searcher",),
                              rest_endpoint="127.0.0.1:0",
                              bind_host="127.0.0.1", bind_port=0,
                              seeds=seeds, interval_secs=interval,
                              cluster_id=cluster_id)
    return cluster, service


def wait_until(q, predicate, timeout=10.0):
    deadline = q.clock.monotonic() + timeout
    while q.clock.monotonic() < deadline:
        if predicate():
            return True
        q.clock.get_clock().sleep(0.05)
    return predicate()


def alive(cluster):
    return {m.node_id for m in cluster.members()}


# --- tests/test_gossip.py, in both packages --------------------------------

def test_gossip_discovery_and_transitivity(q):
    ca, a = make_node(q, "ga")
    cb, b = make_node(q, "gb", seeds=(f"127.0.0.1:{a.port}",))
    cc, c = make_node(q, "gc", seeds=(f"127.0.0.1:{a.port}",))
    for s in (a, b, c):
        s.start()
    try:
        for cluster in (cb, cc, ca):
            assert wait_until(q, lambda: alive(cluster) >= {"ga", "gb", "gc"})
        assert cc.member("gb").roles == ("searcher",)
    finally:
        for s in (a, b, c):
            s.stop()


def test_gossip_dead_node_ages_out(q):
    ca, a = make_node(q, "da", dead_after=0.6)
    cb, b = make_node(q, "db", seeds=(f"127.0.0.1:{a.port}",),
                      dead_after=0.6)
    a.start()
    b.start()
    try:
        assert wait_until(q, lambda: ca.member("db") is not None)
        b.stop()
        assert wait_until(q, lambda: "db" not in alive(ca))
        assert "db" in {m.node_id for m in ca.members(alive_only=False)}
    finally:
        a.stop()
        b.stop()


def test_gossip_garbage_datagrams_ignored(q):
    ca, a = make_node(q, "ja")
    a.start()
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for junk in (b"\xff\x00 not json", b'{"kind": "syn"}',
                     b'{"kind": "syn-ack", "deltas": [{"node_id": 5}]}',
                     b'{"kind": "syn-ack", "deltas": "nope"}',
                     b'{"kind": "ack", "deltas": [17, null, "x"]}'):
            probe.sendto(junk, ("127.0.0.1", a.port))
        probe.close()
        q.clock.get_clock().sleep(0.3)
        cb, b = make_node(q, "jb", seeds=(f"127.0.0.1:{a.port}",))
        b.start()
        try:
            assert wait_until(q, lambda: ca.member("jb") is not None)
        finally:
            b.stop()
    finally:
        a.stop()


def test_gossip_restarted_node_rejoins_immediately(q):
    ca, a = make_node(q, "ra", dead_after=0.8)
    cb, b = make_node(q, "rb", seeds=(f"127.0.0.1:{a.port}",),
                      dead_after=0.8)
    a.start()
    b.start()
    try:
        assert wait_until(q, lambda: ca.member("rb") is not None)
        with b._lock:
            b._state["rb"]["version"] = 100_000
        assert wait_until(
            q, lambda: (ca.member("rb") is not None
                        and a._state.get("rb", {}).get("version", 0)
                        > 50_000))
        b.stop()
        assert wait_until(q, lambda: "rb" not in alive(ca))
        cb2, b2 = make_node(q, "rb", seeds=(f"127.0.0.1:{a.port}",),
                            dead_after=0.8)
        b2.start()
        try:
            assert wait_until(q, lambda: "rb" in alive(ca))
        finally:
            b2.stop()
    finally:
        a.stop()
        b.stop()


def test_gossip_rejects_cluster_id_mismatch(q):
    ca, a = make_node(q, "ma")
    cluster_b, b = make_node(q, "mb", seeds=(f"127.0.0.1:{a.port}",),
                             cluster_id="other-cluster")
    a.start()
    b.start()
    try:
        assert not wait_until(q, lambda: "mb" in alive(ca), timeout=1.0)
        assert "ma" not in alive(cluster_b)
    finally:
        a.stop()
        b.stop()


def test_phi_accrual_adapts_to_cadence(q):
    cluster = q.Cluster("self", ("searcher",), dead_after_secs=1000.0)
    fast = q.ClusterMember("fast", ("searcher",), rest_endpoint="h:1")
    slow = q.ClusterMember("slow", ("searcher",), rest_endpoint="h:2")
    cluster.join(fast)
    cluster.join(slow)
    now = q.clock.monotonic()
    fast.intervals = [0.1] * 8
    slow.intervals = [5.0] * 8
    fast.last_heartbeat = now - 3.0
    slow.last_heartbeat = now - 3.0
    assert cluster.phi(fast, now) > cluster.phi_threshold
    assert cluster.phi(slow, now) < cluster.phi_threshold
    assert not cluster.is_alive(fast, now)
    assert cluster.is_alive(slow, now)
    slow.last_heartbeat = now - 2000.0
    assert not cluster.is_alive(slow, now)
    fresh = q.ClusterMember("fresh", ("searcher",), rest_endpoint="h:3")
    cluster.join(fresh)
    fresh.last_heartbeat = now - 3.0
    assert cluster.is_alive(fresh, now)


# --- the same numbers and events in both packages --------------------------

def heartbeat_script(q, seed):
    """Peers with their own cadences and jitter heartbeat into one
    `Cluster` under a `FakeClock`; some fall silent. Every phi, verdict,
    member list and change event along the way."""
    rng = random.Random(seed)
    out, events = [], []
    with q.clock.use_clock(q.clock.FakeClock(start=5000.0)) as clock:
        cluster = q.Cluster("self", ("indexer",), dead_after_secs=12.0)
        cluster.subscribe(lambda change: events.append(
            (change.kind, change.member.node_id, change.member.roles)))
        cadence = {f"peer-{i}": rng.choice([0.1, 0.5, 1.0, 3.0])
                   for i in range(6)}
        silent_after = {peer: rng.randint(40, 400) for peer in cadence}
        last = {peer: clock.monotonic() for peer in cadence}
        for step in range(500):
            clock.advance(rng.uniform(0.01, 0.2))
            now = clock.monotonic()
            for peer, every in sorted(cadence.items()):
                if step > silent_after[peer]:
                    continue
                if now - last[peer] >= every * rng.uniform(0.7, 1.3):
                    roles = (("indexer",) if step < 250 or peer != "peer-0"
                             else ("indexer", "searcher"))
                    cluster.upsert_heartbeat(q.ClusterMember(
                        peer, roles, rest_endpoint=f"10.0.0.{peer[-1]}:7280"))
                    last[peer] = now
            if step % 7 == 0:
                members = cluster.members(alive_only=False)
                out.append((step, [(m.node_id, cluster.phi(m, now),
                                    cluster.is_alive(m, now),
                                    len(m.intervals)) for m in members],
                            cluster.nodes_with_role("indexer"),
                            cluster.nodes_with_role("searcher")))
            if step == 450:
                cluster.leave("peer-1")
    return out, events


def test_phi_accrual_script_matches_jax_to_the_bit():
    (want, want_events), (got, got_events) = (
        heartbeat_script(load(root), seed=11) for root in PACKAGES)
    assert got == want
    assert got_events == want_events
    phis = [phi for _, rows, _, _ in got for _, phi, _, _ in rows]
    verdicts = {ok for _, rows, _, _ in got for _, _, ok, _ in rows}
    assert verdicts == {True, False} and max(phis) > 8.0
    assert {kind for kind, _, _ in got_events} == {"add", "update", "remove"}


def test_wildcard_endpoint_substitution_matches_jax():
    for endpoint, host in (("0.0.0.0:7280", "10.1.2.3"), (":7280", "h"),
                           ("127.0.0.1:7280", "10.1.2.3"), ("", "h"),
                           ("[::]:1", "h"), ("0.0.0.0:1", "")):
        want, got = (load(root).membership.substitute_wildcard_host(
            endpoint, host) for root in PACKAGES)
        assert got == want


def test_gossip_between_the_packages():
    """A JAX node and a port node on loopback UDP: each discovers the
    other and reads its roles, and each ages the other out after it stops
    gossiping."""
    jax_pkg, port_pkg = (load(root) for root in PACKAGES)
    with ExitStack() as stack:
        for pkg in (jax_pkg, port_pkg):
            stack.enter_context(pkg.clock.use_clock(
                pkg.clock.ScaledClock(factor=0.25)))
        cj, j = make_node(jax_pkg, "jax-node", dead_after=0.6)
        cp, p = make_node(port_pkg, "port-node",
                          seeds=(f"127.0.0.1:{j.port}",), dead_after=0.6)
        j.start()
        p.start()
        try:
            assert wait_until(port_pkg, lambda: "jax-node" in alive(cp))
            assert wait_until(port_pkg, lambda: "port-node" in alive(cj))
            assert cj.member("port-node").roles == ("searcher",)
            assert cp.member("jax-node").roles == ("searcher",)
            p.stop()
            assert wait_until(jax_pkg, lambda: "port-node" not in alive(cj))
            cp2, p2 = make_node(port_pkg, "port-2",
                                seeds=(f"127.0.0.1:{j.port}",),
                                dead_after=0.6)
            p2.start()
            try:
                assert wait_until(port_pkg, lambda: "jax-node" in alive(cp2))
                j.stop()
                assert wait_until(port_pkg,
                                  lambda: "jax-node" not in alive(cp2))
            finally:
                p2.stop()
        finally:
            j.stop()
            p.stop()
