"""Cluster membership + failure detection.

Role of the reference's `quickwit-cluster` (chitchat scuttlebutt gossip +
phi-accrual failure detection, `cluster.rs:61,167`): who is in the cluster,
which roles they run, and liveness. This implementation keeps the same
surface — members with roles/generation, readiness, a change stream feeding
client pools — over a pluggable dissemination layer: in-process registry now
(single-process clusters, tests), heartbeats over the REST transport for
multi-process (serve layer); the gossip state machine is the same either way.

Failure detection is phi-accrual (reference: chitchat's
FailureDetectorConfig, cluster.rs:25-27): each member keeps a sliding
window of inter-arrival intervals; phi = age / mean_interval · log10(e)
(the exponential-distribution suspicion level). A node is suspected dead
when phi exceeds `phi_threshold` — adaptive to the OBSERVED cadence, so
jittery-but-alive peers are not declared dead the way a fixed age
threshold would. `dead_after_secs` remains a hard upper bound (and the
fallback before enough samples accumulate).

Carried over whole from the JAX package's `cluster/membership.py`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

from ..common.clock import monotonic
from ..common.pubsub import EventBroker

ALL_ROLES = ("searcher", "indexer", "metastore", "control_plane", "janitor",
             "ingester")

_WILDCARD_HOSTS = ("0.0.0.0", "::", "")


def substitute_wildcard_host(endpoint: str, reachable_host: str) -> str:
    """A node bound to a wildcard address advertises an unroutable
    `0.0.0.0:port` endpoint; replace the host with the address the peer
    was actually reached at (the reference solves this with a dedicated
    advertise-address config; here the transport knows the real address)."""
    if not endpoint:
        return endpoint
    host, _, port = endpoint.rpartition(":")
    if host in _WILDCARD_HOSTS and reachable_host:
        return f"{reachable_host}:{port}"
    return endpoint


@dataclass
class ClusterMember:
    node_id: str
    roles: tuple[str, ...]
    rest_endpoint: str = ""          # "host:port" for cross-process transport
    grpc_endpoint: str = ""          # "host:port" gRPC plane ("" = REST only)
    generation: int = 0
    is_ready: bool = True
    last_heartbeat: float = field(default_factory=monotonic)
    # sliding window of heartbeat inter-arrival intervals (phi-accrual)
    intervals: list = field(default_factory=list)


@dataclass
class ClusterChange:
    kind: str  # "add" | "remove" | "update"
    member: ClusterMember


class Cluster:
    def __init__(self, self_node_id: str, roles: tuple[str, ...],
                 rest_endpoint: str = "", heartbeat_interval_secs: float = 1.0,
                 dead_after_secs: float = 10.0,
                 broker: Optional[EventBroker] = None):
        self.self_node_id = self_node_id
        self.broker = broker or EventBroker()
        self._members: dict[str, ClusterMember] = {}
        # qwlint: disable-next-line=QW008 - gossip/membership background loops
        # run on real time outside the DST op path; leaf primitives with no
        # seam locks held inside
        self._lock = threading.Lock()
        self.heartbeat_interval_secs = heartbeat_interval_secs
        self.dead_after_secs = dead_after_secs
        # chitchat's default phi threshold is 8.0 (~1 false positive per
        # 10^8 under the model); jitter-tolerant
        self.phi_threshold = 8.0
        self_member = ClusterMember(self_node_id, roles, rest_endpoint)
        self._members[self_node_id] = self_member

    # --- membership --------------------------------------------------------
    def join(self, member: ClusterMember) -> None:
        with self._lock:
            existing = self._members.get(member.node_id)
            self._members[member.node_id] = member
        self.broker.publish(ClusterChange("update" if existing else "add", member))

    def leave(self, node_id: str) -> None:
        with self._lock:
            member = self._members.pop(node_id, None)
        if member is not None:
            self.broker.publish(ClusterChange("remove", member))

    PHI_WINDOW = 32
    MIN_SAMPLES = 4

    def record_heartbeat(self, node_id: str) -> None:
        with self._lock:
            member = self._members.get(node_id)
            if member is not None:
                now = monotonic()
                interval = now - member.last_heartbeat
                if 0 < interval < self.dead_after_secs * 4:
                    member.intervals.append(interval)
                    if len(member.intervals) > self.PHI_WINDOW:
                        member.intervals.pop(0)
                member.last_heartbeat = now

    def phi(self, member: ClusterMember, now: Optional[float] = None) -> float:
        """Suspicion level (phi-accrual): -log10 P(no heartbeat for this
        long | observed cadence), exponential model. Below MIN_SAMPLES the
        detector abstains (returns 0) and the hard age bound governs."""
        import math
        if len(member.intervals) < self.MIN_SAMPLES:
            return 0.0
        now = monotonic() if now is None else now
        mean = sum(member.intervals) / len(member.intervals)
        age = now - member.last_heartbeat
        return age / max(mean, 1e-6) * math.log10(math.e)

    def is_alive(self, member: ClusterMember,
                 now: Optional[float] = None) -> bool:
        """Hybrid accrual: phi ACCELERATES detection of fast-cadence peers
        (a 100ms heartbeater silent for seconds is suspect long before the
        wall-clock bound), floored so a single GC pause cannot flap
        membership; `dead_after_secs` stays the authoritative upper
        bound regardless of cadence."""
        if member.node_id == self.self_node_id:
            return True
        now = monotonic() if now is None else now
        age = now - member.last_heartbeat
        if age > self.dead_after_secs:
            return False  # hard bound
        if age < min(self.dead_after_secs / 4, 2.0):
            return True  # flap floor: brief pauses never kill a peer
        return self.phi(member, now) < self.phi_threshold

    def upsert_heartbeat(self, member: ClusterMember) -> None:
        """Gossip upsert shared by both heartbeat transports (outbound
        client + inbound REST route): join only when the peer is new or
        its roles/endpoint changed (avoids a ClusterChange broadcast per
        tick), then stamp liveness either way."""
        current = self.member(member.node_id)
        if (current is None or current.roles != member.roles
                or current.rest_endpoint != member.rest_endpoint
                or current.grpc_endpoint != member.grpc_endpoint):
            self.join(member)
        self.record_heartbeat(member.node_id)

    # --- queries -----------------------------------------------------------
    def members(self, alive_only: bool = True) -> list[ClusterMember]:
        now = monotonic()
        with self._lock:
            out = []
            for member in self._members.values():
                if alive_only and not self.is_alive(member, now):
                    continue
                out.append(member)
            return sorted(out, key=lambda m: m.node_id)

    def nodes_with_role(self, role: str, alive_only: bool = True) -> list[str]:
        return [m.node_id for m in self.members(alive_only) if role in m.roles]

    def member(self, node_id: str) -> Optional[ClusterMember]:
        with self._lock:
            return self._members.get(node_id)

    def is_ready(self) -> bool:
        return bool(self.nodes_with_role("searcher") or
                    self.nodes_with_role("indexer"))

    def subscribe(self, handler: Callable[[ClusterChange], None]):
        return self.broker.subscribe(ClusterChange, handler)
