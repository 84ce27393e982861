"""UDP scuttlebutt gossip — the cluster dissemination layer.

Role of the reference's chitchat (`quickwit-cluster/src/cluster.rs:61`,
chitchat crate): each node keeps a versioned key/value state per peer and
anti-entropy-syncs it over UDP with random peers. The three-way exchange
is chitchat's:

    SYN      {digest: {node_id: max_version_seen}}
    SYN-ACK  {deltas: entries the sender has newer than the digest,
              digest: sender's own digest}
    ACK      {deltas: entries the receiver has newer than that digest}

Each node's own state version bumps every gossip round, and applying a
newer (generation, version) records a Cluster heartbeat — so a peer that
stops gossiping stops producing versions and ages out through
`dead_after_secs` (the phi-accrual curve collapses to an age threshold
under regular intervals, like cluster/membership.py). `generation` is
the service start time: a restarted node begins a higher generation, so
peers accept its reset version immediately (chitchat's incarnation).

Gossip shares the REST port NUMBER over UDP (the reference's convention
— TCP and UDP namespaces don't collide), so `peer_seeds` work unchanged.
Messages are JSON datagrams; deltas are capped per packet to stay under
typical MTU for small clusters and rely on subsequent rounds for the
rest (scuttlebutt converges incrementally by design).

Carried over whole from the JAX package's `cluster/gossip.py`.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional

from ..common.clock import get_clock, get_rng
from .membership import Cluster, ClusterMember

logger = logging.getLogger(__name__)

_MAX_DELTAS_PER_PACKET = 16
_MAX_DATAGRAM = 60_000


class GossipService:
    """One node's gossip endpoint: a UDP listener + a periodic gossip loop,
    feeding discovered peers and liveness into the Cluster."""

    def __init__(self, cluster: Cluster, node_id: str, roles: tuple[str, ...],
                 rest_endpoint: str, bind_host: str, bind_port: int,
                 seeds: tuple[str, ...] = (), interval_secs: float = 1.0,
                 fanout: int = 3, cluster_id: str = "quickwit-tpu",
                 grpc_endpoint: str = ""):
        self.cluster = cluster
        self.node_id = node_id
        # chitchat embeds the cluster_id in every message and rejects
        # mismatches (`quickwit-cluster/src/cluster.rs:61`): without it a
        # spoofed datagram or a second cluster sharing seeds could inject
        # members the root searcher would fan leaf requests out to.
        self.cluster_id = cluster_id
        self.interval_secs = interval_secs
        self.fanout = fanout
        self.seeds = tuple(seeds)
        # versioned node states:
        # node_id -> {"generation", "version", "data"}; identity order is
        # (generation, version) so a restart (new generation, version 1)
        # supersedes any pre-crash version
        self._state: dict[str, dict] = {
            node_id: {"generation": get_clock().time_ns(), "version": 1,
                      "data": {"roles": list(roles),
                               "rest_endpoint": rest_endpoint,
                               "grpc_endpoint": grpc_endpoint,
                               "gossip_port": 0}},  # patched after bind
        }
        # qwlint: disable-next-line=QW008 - gossip/membership background loops
        # run on real time outside the DST op path; leaf primitives with no
        # seam locks held inside
        self._lock = threading.Lock()
        # qwlint: disable-next-line=QW008 - gossip/membership background loops
        # run on real time outside the DST op path; leaf primitives with no
        # seam locks held inside
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind_host, bind_port))
        self.port = self._sock.getsockname()[1]
        self._state[node_id]["data"]["gossip_port"] = self.port
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        for name, target in (("gossip-rx", self._listen_loop),
                             ("gossip-tx", self._gossip_loop)):
            # qwlint: disable-next-line=QW003 - cluster gossip loops are
            # node-lifetime background threads, never query-scoped
            # qwlint: disable-next-line=QW008 - gossip/membership background
            # loops run on real time outside the DST op path; leaf primitives
            # with no seam locks held inside
            thread = threading.Thread(target=target, name=name, daemon=True)
            thread.start()
            self._threads.append(thread)
        logger.info("gossip listening on udp:%d (%s)", self.port, self.node_id)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # --- state helpers -----------------------------------------------------
    def _digest(self) -> dict[str, list[int]]:
        """node_id -> [generation, version] (chitchat digests carry the
        incarnation too — a version-only digest would never re-ship a
        restarted node whose version reset below the peer's last view)."""
        with self._lock:
            return {nid: [s.get("generation", 0), s["version"]]
                    for nid, s in self._state.items()}

    def _deltas_for(self, digest: dict) -> list[dict]:
        """Entries the peer has not seen (newer (generation, version))."""
        out = []
        with self._lock:
            for nid, state in self._state.items():
                seen = digest.get(nid) or [0, 0]
                try:
                    seen_key = (int(seen[0]), int(seen[1]))
                except (TypeError, ValueError, IndexError):
                    seen_key = (0, 0)
                if (state.get("generation", 0), state["version"]) > seen_key:
                    out.append({"node_id": nid, **state})
                    if len(out) >= _MAX_DELTAS_PER_PACKET:
                        break
        return out

    def _apply_deltas(self, deltas: list[dict],
                      source_host: Optional[str] = None) -> None:
        from .membership import substitute_wildcard_host
        if not isinstance(deltas, list):
            return
        for delta in deltas:
            if not isinstance(delta, dict):
                continue
            nid = delta.get("node_id")
            if not isinstance(nid, str) or nid == self.node_id:
                continue  # own state is authoritative locally
            generation = int(delta.get("generation", 0))
            version = int(delta.get("version", 0))
            data = dict(delta.get("data") or {})
            # a wildcard-bound node advertises 0.0.0.0: substitute the
            # address the datagram actually came from (first-hop only —
            # the fixed endpoint then propagates onward)
            endpoint = str(data.get("rest_endpoint", ""))
            if source_host:
                data["rest_endpoint"] = substitute_wildcard_host(
                    endpoint, source_host)
                data["grpc_endpoint"] = substitute_wildcard_host(
                    str(data.get("grpc_endpoint", "")), source_host)
            with self._lock:
                current = self._state.get(nid)
                if current is not None and (
                        current.get("generation", 0),
                        current["version"]) >= (generation, version):
                    continue
                self._state[nid] = {"generation": generation,
                                    "version": version, "data": data}
            member = ClusterMember(
                node_id=nid, roles=tuple(data.get("roles", ())),
                rest_endpoint=str(data.get("rest_endpoint", "")),
                grpc_endpoint=str(data.get("grpc_endpoint", "")))
            self.cluster.upsert_heartbeat(member)

    def _gossip_addresses(self) -> list[tuple[str, int]]:
        """Seeds + every known peer's advertised gossip address."""
        addresses = {}
        for seed in self.seeds:
            host, _, port = seed.rpartition(":")
            try:
                addresses[(host, int(port))] = True
            except ValueError:
                logger.debug("bad gossip seed %r", seed)
        with self._lock:
            for nid, state in self._state.items():
                if nid == self.node_id:
                    continue
                endpoint = state["data"].get("rest_endpoint", "")
                gossip_port = state["data"].get("gossip_port")
                host = endpoint.rpartition(":")[0]
                if host and gossip_port:
                    addresses[(host, int(gossip_port))] = True
        return [a for a in addresses if a != ("127.0.0.1", self.port)]

    # --- protocol ----------------------------------------------------------
    def _send(self, message: dict, addr: tuple[str, int]) -> None:
        try:
            message = {"cluster_id": self.cluster_id, **message}
            payload = json.dumps(message).encode()
            if len(payload) <= _MAX_DATAGRAM:
                self._sock.sendto(payload, addr)
        except OSError as exc:
            logger.debug("gossip send to %s failed: %s", addr, exc)

    def _gossip_loop(self) -> None:
        # interval waits route through the process clock so an accelerated
        # clock compresses rounds; fanout sampling uses the process rng so
        # a seeded run picks the same targets
        while not get_clock().wait(self._stop, self.interval_secs):
            with self._lock:
                self._state[self.node_id]["version"] += 1
            targets = self._gossip_addresses()
            if not targets:
                continue
            digest = self._digest()
            for addr in get_rng().sample(targets,
                                         min(self.fanout, len(targets))):
                self._send({"kind": "syn", "digest": digest}, addr)

    def _listen_loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload, addr = self._sock.recvfrom(_MAX_DATAGRAM + 1024)
            except OSError as exc:
                if self._stop.is_set():
                    return  # socket closed on stop()
                # transient (e.g. WSAECONNRESET from a dead peer's ICMP):
                # a deaf gossip node is worse than a noisy one
                logger.debug("gossip recv error: %s", exc)
                continue
            try:
                message = json.loads(payload)
                if message.get("cluster_id") != self.cluster_id:
                    logger.debug("dropping gossip datagram from %s: "
                                 "cluster_id mismatch", addr)
                    continue
                kind = message.get("kind")
                digest = dict(message.get("digest") or {})
                if kind == "syn":
                    self._send({"kind": "syn-ack",
                                "deltas": self._deltas_for(digest),
                                "digest": self._digest()}, addr)
                elif kind == "syn-ack":
                    self._apply_deltas(message.get("deltas") or [],
                                       source_host=addr[0])
                    self._send({"kind": "ack",
                                "deltas": self._deltas_for(digest)}, addr)
                elif kind == "ack":
                    self._apply_deltas(message.get("deltas") or [],
                                       source_host=addr[0])
            except Exception as exc:  # noqa: BLE001 - a deaf gossip node
                # is invisible failure; any malformed datagram must be
                # droppable without killing the listener
                logger.debug("bad gossip datagram from %s: %s", addr, exc)

    # Liveness: _apply_deltas records a Cluster heartbeat whenever a newer
    # version arrives; a peer that stops gossiping stops producing versions
    # and ages out through Cluster.dead_after_secs.
