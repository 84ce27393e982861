"""SimCluster: a full in-process cluster assembled from the real components.

Every moving part is the production implementation — `Ingester` WAL shards
with chained replication, `IngestRouter`, `IndexingPipeline` drains,
`FileBackedMetastore` instances polling one shared object store,
`MergeExecutor`, `RootSearcher` fan-out over `SearchService` leaves,
`IndexingScheduler` planning, the offload `WorkerPool` + `Autoscaler` —
only the seams are simulated: the network (`SimNetwork`), time (the
process `FakeClock` the harness installs), randomness (the seeded process
rng), and faults (the run's `FaultInjector`).

Node liveness is modeled, not threaded: a killed node keeps its WAL
directory (the machine's disk) but is partitioned and excluded from every
role; orphaned replica shards on survivors are promoted, and a restart
re-runs the real `Ingester` recovery over the old WAL plus a fresh
metastore cache — exactly the failover path the zero-loss invariant is
about.

Every search of the cluster runs on its one device (`device`, default
`cuda`): each node's `SearchService`, its offload workers, and the
network-free ground truth. `mesh_devices`, when given, is each node's
device grid, so multi-split groups take the mesh route.

The deliberate-bug switches (`break_publish`, `break_wal` — the
`QW_DST_BREAK_{PUBLISH,WAL}` env flags) inject the two classes of bug the
harness self-test must catch: checkpoint-less drains (duplicate publish)
and a replication link that silently truncates batches (loss after
failover).
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Optional

from .. import resolve_device
from ..common import sync
from ..common.ctx import run_with_context
from ..common.deadline import CancellationToken
from ..common.faults import FaultInjector, FaultyMetastore, FaultyStorageResolver
from ..control_plane.scheduler import IndexingScheduler, IndexingTask
from ..index import SplitReader
from ..indexing import IndexingPipeline, PipelineParams, VecSource
from ..indexing.merge import MergeExecutor, StableLogMergePolicy
from ..indexing.pipeline import split_file_path
from ..indexing.sources import IngestSource
from ..ingest import Ingester, IngestRouter
from ..ingest.ingester import ReplicationGap, shard_queue_id
from ..ingest.router import INGEST_V2_SOURCE_ID
from ..metastore import FileBackedMetastore, ListSplitsQuery
from ..metastore.base import MetastoreError
from ..metastore.checkpoint import BEGINNING, IncompatibleCheckpointDelta
from ..models import DocMapper, FieldMapping, FieldType
from ..models.index_metadata import IndexConfig, IndexMetadata, SourceConfig
from ..models.split_metadata import SplitState
from ..offload.autoscaler import Autoscaler, WorkerLauncher
from ..offload.pool import WorkerPool
from ..query.ast import MatchAll, Range, RangeBound
from ..search.leaf import leaf_search_single_split
from ..search.models import SearchRequest, SortField
from ..search.cancel import CANCEL_REGISTRY
from ..search.root import RootSearcher
from ..search.service import LocalSearchClient, SearcherContext, SearchService
from ..storage import StorageResolver
from ..tenancy.overload import OverloadController
from .network import SimNetwork, SimSearchClient
from .scenario import Scenario

SIM_MAPPER = DocMapper(
    field_mappings=[
        FieldMapping("ts", FieldType.DATETIME, fast=True,
                     input_formats=("unix_timestamp",)),
        FieldMapping("n", FieldType.U64, fast=True),
        FieldMapping("body", FieldType.TEXT),
    ],
    timestamp_field="ts",
    default_search_fields=("body",),
)

METASTORE_POLL_SECS = 5.0  # < Scenario.step_secs: publishes surface next step
SPLIT_NUM_DOCS_TARGET = 50

# per-process namespace counter: the ram:// tree and WAL tempdir are unique
# per run; neither may ever appear in the trace
_NS_COUNTER = itertools.count()


class _StubWorkerLauncher(WorkerLauncher):
    """Autoscaler substrate for the sim: launch/terminate bookkeeping only
    (the pool-size invariant is about the controller, not the workers)."""

    def launch(self, worker_id: str):
        return object()

    def terminate(self, worker_id: str) -> None:
        pass


@dataclass
class SimNode:
    node_id: str
    wal_dir: str
    alive: bool = True
    ingester: Any = None
    router: Any = None
    metastore: Any = None
    service: Any = None
    client: Any = None
    extras: dict = field(default_factory=dict)


class SimCluster:
    def __init__(self, scenario: Scenario, injector: FaultInjector,
                 network: SimNetwork, clock,
                 break_publish: bool = False, break_wal: bool = False,
                 device=None, mesh_devices=None):
        self.scenario = scenario
        self.device = resolve_device(device)
        self.mesh_devices = mesh_devices
        self.injector = injector
        self.network = network
        self.clock = clock
        self.break_publish = break_publish
        self.break_wal = break_wal
        self._ns = next(_NS_COUNTER)
        self._drain_seq = itertools.count()
        self._cancel_seq = itertools.count()
        self.resolver = StorageResolver.for_test()
        self.faulty_resolver = FaultyStorageResolver(self.resolver, injector)
        self.meta_storage = self.resolver.resolve(
            f"ram:///dst{self._ns}/meta")
        self.base_dir = tempfile.mkdtemp(prefix="qw-dst-")
        # acked ledger: doc `n`s whose ingest the cluster ACKNOWLEDGED
        # (persist + replication chain succeeded) — the zero-loss floor
        self.acked: dict[str, list[int]] = {i: [] for i in scenario.indexes}
        # skip-cache over the durable chain registry (metastore
        # shard_chains): queue_id -> (leader, follower) last recorded, so
        # the per-batch replicate hook only writes on chain changes
        self._chain_cache: dict[str, tuple[str, Optional[str]]] = {}

        bootstrap = FileBackedMetastore(self.meta_storage,
                                        polling_interval_secs=None)
        for index_id in scenario.indexes:
            bootstrap.create_index(IndexMetadata(
                index_uid=self._uid(index_id),
                index_config=IndexConfig(
                    index_id=index_id,
                    index_uri=self._index_uri(index_id),
                    doc_mapper=SIM_MAPPER,
                    split_num_docs_target=SPLIT_NUM_DOCS_TARGET),
                sources={INGEST_V2_SOURCE_ID: SourceConfig(
                    INGEST_V2_SOURCE_ID, "ingest")}))

        self.nodes: dict[str, SimNode] = {}
        for i in range(scenario.nodes):
            node_id = f"sim-{i}"
            self.nodes[node_id] = self._build_node(node_id)

        self.merge_policy = StableLogMergePolicy(
            merge_factor=2, max_merge_factor=4, min_level_num_docs=20)
        self.cp_scheduler = IndexingScheduler()
        self.worker_pool = WorkerPool()
        self.autoscaler = Autoscaler(
            self.worker_pool, _StubWorkerLauncher(),
            min_workers=1, max_workers=4, queue_per_worker=8,
            overload=OverloadController())

    # --- identifiers -------------------------------------------------------
    def _uid(self, index_id: str) -> str:
        return f"{index_id}:01"

    def _index_uri(self, index_id: str) -> str:
        return f"ram:///dst{self._ns}/{index_id}"

    # --- node lifecycle ----------------------------------------------------
    def _build_node(self, node_id: str) -> SimNode:
        wal_dir = os.path.join(self.base_dir, node_id)
        node = SimNode(node_id=node_id, wal_dir=wal_dir)
        replicate = (self._make_replicate(node_id)
                     if self.scenario.replication and self.scenario.nodes > 1
                     else None)
        node.ingester = Ingester(wal_dir, fsync=False,
                                 replicate_to=replicate,
                                 fault_injector=self.injector)
        node.ingester.on_truncate = self._make_on_truncate(node_id)
        node.router = IngestRouter(node.ingester, shards_per_source=1,
                                   shard_prefix=node_id)
        node.metastore = FileBackedMetastore(
            self.meta_storage, polling_interval_secs=METASTORE_POLL_SECS)
        context_kwargs: dict[str, Any] = {}
        if self.scenario.offload:
            # production-shaped fan-out in-process: a two-worker fleet per
            # node, `max_local_splits=1` + `task_splits=1` so ANY leaf
            # request beyond one cold split exercises the dispatcher's
            # spawn/steal/hedge threads against the shared cache tiers.
            # Workers are full SearchServices over the same faulty
            # resolver, reached through LocalSearchClient (deterministic:
            # no sockets, no real network)
            context_kwargs["offload"] = {
                "endpoints": [f"{node_id}-w0", f"{node_id}-w1"],
                "max_local_splits": 1,
                "task_splits": 1,
                "max_inflight_per_worker": 2,
            }
            context_kwargs["offload_client_factory"] = (
                lambda endpoint: LocalSearchClient(SearchService(
                    SearcherContext(self.faulty_resolver, prefetch=False,
                                    device=self.device),
                    node_id=endpoint)))
        node.service = SearchService(
            SearcherContext(self.faulty_resolver, prefetch=False,
                            device=self.device,
                            mesh_devices=self.mesh_devices,
                            **context_kwargs),
            node_id=node_id)
        node.client = LocalSearchClient(node.service)
        return node

    def _make_replicate(self, leader_id: str):
        def replicate(index_uid: str, source_id: str, shard_id: str,
                      first: int, payloads: list[bytes]) -> None:
            follower_id = self._follower_for(leader_id)
            if follower_id is None:
                # the replication chain cannot be completed: NACK rather
                # than ack a leader-only write a later kill would lose —
                # reference semantics: persist fails when no follower is
                # available, clients retry against a healthy chain
                raise ConnectionError("simnet: no replica available")
            if self.network.is_partitioned(follower_id):
                raise ConnectionError(
                    f"simnet: replica {follower_id} unreachable")
            queue_id = shard_queue_id(index_uid, source_id, shard_id)
            if self._chain_cache.get(queue_id) != (leader_id, follower_id):
                # durable registration BEFORE the first batch reaches a
                # new follower: failover may only promote the REGISTERED
                # follower, so the record must exist before that follower
                # can hold acked data (qwmc's stale-replica-promotion
                # counterexample is exactly an unregistered-copy takeover)
                self.nodes[leader_id].metastore.record_shard_chain(
                    index_uid, source_id, shard_id,
                    leader=leader_id, follower=follower_id)
                self._chain_cache[queue_id] = (leader_id, follower_id)
            if self.break_wal:
                # QW_DST_BREAK_WAL: the link silently truncates each batch
                # — the acked tail exists only on the leader, so a leader
                # kill + replica promotion loses it (zero-loss violation)
                payloads = payloads[:-1]
            follower = self.nodes[follower_id].ingester
            try:
                follower.replica_persist(index_uid, source_id, shard_id,
                                         first, payloads)
            except ReplicationGap as gap:
                if self.break_wal:
                    return  # the buggy link also swallows gap reports
                leader_shard = self.nodes[leader_id].ingester.shard(
                    index_uid, source_id, shard_id)
                records = leader_shard.log.read_from(gap.have, 1_000_000)
                if not records:
                    return
                start = records[0][0]
                if start > gap.have:
                    # the leader's retained WAL starts past the follower's
                    # position (truncated behind the published checkpoint):
                    # restart the replica log at what the leader still
                    # holds — the checkpoint covers everything below
                    # (serve/node.py's reset= backfill path)
                    follower.replica_reset(index_uid, source_id, shard_id,
                                           start)
                follower.replica_persist(index_uid, source_id, shard_id,
                                         start,
                                         [payload for _, payload in records])
        return replicate

    def _make_on_truncate(self, leader_id: str):
        def on_truncate(index_uid: str, source_id: str, shard_id: str,
                        position: int) -> None:
            for node_id in self.alive_nodes():
                if node_id != leader_id:
                    self.nodes[node_id].ingester.replica_truncate(
                        index_uid, source_id, shard_id, position)
        return on_truncate

    def _follower_for(self, leader_id: str) -> Optional[str]:
        for node_id in self.alive_nodes():
            if node_id != leader_id:
                return node_id
        return None

    def alive_nodes(self) -> list[str]:
        return sorted(n for n, node in self.nodes.items() if node.alive)

    def kill(self, node_id: str) -> dict[str, Any]:
        """Crash the node: partitioned and excluded from every role, but its
        WAL directory (the machine's disk) survives — a later restart runs
        real recovery over it. Kills are crashes, not machine loss, so the
        zero-loss ledger invariant is checkable under any kill sequence."""
        node = self.nodes[node_id]
        if not node.alive:
            return {"skipped": "already-dead"}
        node.alive = False
        self.network.partition(node_id)
        if self.break_wal:
            self._drop_unfsynced_tail(node)
        return {"killed": node_id,
                "promoted": self.promote_orphans()}

    def _drop_unfsynced_tail(self, node: SimNode) -> None:
        """QW_DST_BREAK_WAL, crash half: the last acked record of each
        leader shard was never durably fsynced, so the crash loses it —
        rewrite the on-disk WAL without its tail record (positions
        preserved). Combined with the truncating replication link, the
        acked tail then exists on no surviving copy."""
        for shard in node.ingester.list_shards(include_replicas=False):
            records = shard.log.read_from(0, 1_000_000)
            if not records:
                continue
            first = records[0][0]
            shard.log.reset_to(first)
            if len(records) > 1:
                shard.log.append_batch(
                    [payload for _, payload in records[:-1]])

    def restart(self, node_id: str) -> dict[str, Any]:
        node = self.nodes[node_id]
        if node.alive:
            return {"skipped": "already-alive"}
        # real recovery: a fresh Ingester re-reads the old WAL directory,
        # a fresh metastore instance starts cold (must re-poll state)
        self.nodes[node_id] = self._build_node(node_id)
        self.network.heal(node_id)
        demoted = self._reconcile_rejoined(node_id)
        shards = sorted(
            s.shard_id
            for s in self.nodes[node_id].ingester.list_shards(
                include_replicas=True))
        result = {"restarted": node_id, "recovered_shards": shards}
        if demoted:
            result["demoted"] = demoted
        return result

    def _reconcile_rejoined(self, node_id: str) -> list[str]:
        """A rejoined node recovers its shards with the role they had when
        it crashed — a stale LEADER role when another copy was promoted
        meanwhile (qwmc's stale-leader-rejoin counterexample: the
        split-brain re-uses published positions and loses an acked
        record). The durable chain registry is the truth: demote the local
        copy, resetting its WAL at the published checkpoint — the
        registered chain holds every acked record, so nothing is lost."""
        node = self.nodes[node_id]
        node.metastore.refresh()  # cold start must not serve a stale view
        demoted = []
        for shard in node.ingester.list_shards(include_replicas=False):
            chain = node.metastore.shard_chain(
                shard.index_uid, shard.source_id, shard.shard_id)
            if chain is None or chain.get("leader") == node_id:
                continue
            queue_id = shard_queue_id(shard.index_uid, shard.source_id,
                                      shard.shard_id)
            if node.ingester.demote_to_replica(
                    queue_id, self._published_floor(node, shard)):
                demoted.append(queue_id)
        return sorted(demoted)

    def _published_floor(self, node: SimNode, shard) -> int:
        """Published checkpoint for the shard (exclusive end position):
        everything below it is in published splits."""
        checkpoint = node.metastore.source_checkpoint(shard.index_uid,
                                                      shard.source_id)
        position = checkpoint.position_for(shard.shard_id)
        return 0 if position == BEGINNING else int(position)

    def _checkpoint_total(self, node: SimNode, uid: str) -> int:
        """Sum of the source checkpoint's partition positions (each one an
        EXCLUSIVE end = records published from that shard) — the concrete
        image of the qwmc checkpoint model's `ckpt` counter, recorded in
        drain summaries so `tools.qwmc.conformance` can replay the trace
        against the abstract transition relation."""
        checkpoint = node.metastore.source_checkpoint(uid,
                                                      INGEST_V2_SOURCE_ID)
        return sum(int(p) for p in checkpoint.positions.values()
                   if p != BEGINNING)

    def promote_orphans(self) -> list[str]:
        """Promote replica shards whose leader node is dead (the reference's
        AdviseResetShards failover) on every surviving node.

        The durable chain registry gates the takeover: the current leader
        is whoever the registry records (falling back to the shard-id
        prefix for never-replicated shards), and only the REGISTERED
        follower is eligible — a copy that merely looks healthy may have
        crashed out of the chain and be missing acked batches (qwmc's
        stale-replica-promotion counterexample). A promoted log behind the
        published checkpoint forward-resets to it, or fresh appends would
        collide with already-consumed positions (behind-checkpoint
        counterexample)."""
        alive = set(self.alive_nodes())
        promoted = []
        for node_id in self.alive_nodes():
            node = self.nodes[node_id]
            refreshed = False
            for queue_id, shard in node.ingester.replica_shards():
                if not refreshed:
                    # promotion decisions must read the registry and the
                    # checkpoint fresh, not from the polling cache
                    node.metastore.refresh()
                    refreshed = True
                chain = node.metastore.shard_chain(
                    shard.index_uid, shard.source_id, shard.shard_id)
                if chain is not None and chain.get("leader") == node_id:
                    # a crash between the registry write and the role flip
                    # left the record already naming us: finish the
                    # promotion (idempotent — the registry is the truth)
                    if node.ingester.promote_replica(
                            queue_id,
                            min_position=self._published_floor(node, shard)):
                        promoted.append(queue_id)
                    continue
                leader = (chain["leader"] if chain is not None
                          else shard.shard_id.rsplit("-shard-", 1)[0])
                if leader in alive:
                    continue
                if chain is not None and chain.get("follower") != node_id:
                    continue
                # registry BEFORE the role flip: if we crash in between,
                # the next failover round finds the record naming us and
                # finishes the flip (branch above) instead of demoting a
                # copy that holds acked data back to the checkpoint
                node.metastore.record_shard_chain(
                    shard.index_uid, shard.source_id, shard.shard_id,
                    leader=node_id, follower=None)
                self._chain_cache[queue_id] = (node_id, None)
                if node.ingester.promote_replica(
                        queue_id,
                        min_position=self._published_floor(node, shard)):
                    promoted.append(queue_id)
        return sorted(promoted)

    # --- ops ---------------------------------------------------------------
    def ingest(self, node_id: str, index_id: str,
               docs: list[dict[str, Any]]) -> dict[str, Any]:
        node = self.nodes[node_id]
        if not node.alive:
            return {"skipped": "dead"}
        try:
            result = node.router.ingest(self._uid(index_id), docs)
        except Exception as exc:  # noqa: BLE001 - any failure means NACK
            # chained replication rolled the leader WAL back: the batch is
            # durable on both or neither, so nothing joins the acked ledger
            return {"error": type(exc).__name__}
        self.acked[index_id].extend(int(d["n"]) for d in docs)
        return {"acked": result["num_docs"]}

    def drain(self, node_id: str) -> dict[str, Any]:
        node = self.nodes[node_id]
        if not node.alive:
            return {"skipped": "dead"}
        summary: dict[str, Any] = {}
        for index_id in self.scenario.indexes:
            if self.break_publish:
                summary[index_id] = self._drain_break_publish(node, index_id)
            else:
                summary[index_id] = self._drain_index(node, index_id)
        return summary

    def _drain_index(self, node: SimNode, index_id: str) -> dict[str, Any]:
        uid = self._uid(index_id)
        storage = self.resolver.resolve(self._index_uri(index_id))
        params = PipelineParams(
            index_uid=uid, source_id=INGEST_V2_SOURCE_ID,
            node_id=node.node_id,
            split_num_docs_target=SPLIT_NUM_DOCS_TARGET, batch_num_docs=25)
        counters = None
        for attempt in (0, 1):
            source = IngestSource(node.ingester, uid, INGEST_V2_SOURCE_ID)
            pipeline = IndexingPipeline(params, SIM_MAPPER, source,
                                        node.metastore, storage)
            try:
                counters = pipeline.run_to_completion()
                break
            except IncompatibleCheckpointDelta:
                # another node already published these positions (post-
                # failover double drain): exactly-once enforcement worked
                return {"skipped": "checkpoint",
                        "checkpoint": self._checkpoint_total(node, uid)}
            except MetastoreError as exc:
                if attempt or getattr(exc, "kind", "") != "failed_precondition":
                    return {"error": "metastore"}
                # stale cache lost the CAS: age it past the polling TTL so
                # the retry reloads, exactly like a node would on its next
                # poll tick
                self.clock.advance(METASTORE_POLL_SECS + 1.0)
        if counters is None:
            return {"error": "metastore"}
        checkpoint = node.metastore.source_checkpoint(uid,
                                                      INGEST_V2_SOURCE_ID)
        for shard in node.ingester.list_shards(uid):
            position = checkpoint.position_for(shard.shard_id)
            if position != BEGINNING:
                node.ingester.truncate(uid, INGEST_V2_SOURCE_ID,
                                       shard.shard_id, int(position))
        return {"indexed": counters.num_docs_processed,
                "splits": counters.num_splits_published,
                "checkpoint": self._checkpoint_total(node, uid)}

    def _drain_break_publish(self, node: SimNode,
                             index_id: str) -> dict[str, Any]:
        """QW_DST_BREAK_PUBLISH: drain the WAL from position zero with a
        fresh checkpoint partition each pass and never truncate — the
        'lost the checkpoint linkage' bug class. Every re-drain republishes
        the same records (exactly-once violation)."""
        uid = self._uid(index_id)
        storage = self.resolver.resolve(self._index_uri(index_id))
        docs: list[dict[str, Any]] = []
        for shard in node.ingester.list_shards(uid):
            for _, doc in node.ingester.fetch(uid, INGEST_V2_SOURCE_ID,
                                              shard.shard_id,
                                              from_position=0,
                                              max_records=1_000_000):
                docs.append(doc)
        if not docs:
            return {"indexed": 0, "splits": 0,
                    "checkpoint": self._checkpoint_total(node, uid)}
        params = PipelineParams(
            index_uid=uid, source_id=INGEST_V2_SOURCE_ID,
            node_id=node.node_id,
            split_num_docs_target=SPLIT_NUM_DOCS_TARGET, batch_num_docs=25)
        source = VecSource(
            docs, partition_id=f"bp-{node.node_id}-{next(self._drain_seq)}")
        pipeline = IndexingPipeline(params, SIM_MAPPER, source,
                                    node.metastore, storage)
        counters = pipeline.run_to_completion()
        # the checkpoint never advances here (fresh partition each pass):
        # exactly the divergence the conformance check is built to catch
        return {"indexed": counters.num_docs_processed,
                "splits": counters.num_splits_published,
                "checkpoint": self._checkpoint_total(node, uid)}

    def _make_root(self, alive: list[str]) -> RootSearcher:
        searcher = self.nodes[alive[0]]
        clients = {
            node_id: SimSearchClient(self.network, node_id,
                                     self.nodes[node_id].client)
            for node_id in alive
        }
        return RootSearcher(
            FaultyMetastore(searcher.metastore, self.injector), clients,
            nodes_provider=lambda: self.alive_nodes(),
            default_timeout_secs=self.scenario.search_timeout_secs)

    def search(self, index_id: str, max_hits: int,
               sort: Optional[str] = None,
               repeat: int = 2) -> list[dict[str, Any]]:
        """Run the query `repeat` times through the full root fan-out —
        the second pass hits the warm cache tiers, which is exactly what
        the cache≡cold invariant compares."""
        alive = self.alive_nodes()
        if not alive:
            return [{"error": "NoAliveNodes"}]
        root = self._make_root(alive)
        # a fast-field sort arms threshold pruning: the leaf's shared
        # ThresholdBox is then written by the local execute loop and read
        # by the offload dispatch thread — the interleaving the qwrace
        # schedule exploration targets
        request = SearchRequest(
            index_ids=[index_id], query_ast=MatchAll(), max_hits=max_hits,
            sort_fields=([SortField(sort, "desc")] if sort else []))
        outs: list[dict[str, Any]] = []
        for _ in range(repeat):
            try:
                resp = root.search(request)
            except Exception as exc:  # noqa: BLE001 - typed outcome per run
                outs.append({"error": type(exc).__name__})
                continue
            complete = (not resp.timed_out and not resp.errors
                        and not resp.failed_splits)
            outs.append({
                "ns": sorted(int(h.doc["n"]) for h in resp.hits),
                "num_hits": int(resp.num_hits),
                "complete": bool(complete),
            })
        return outs

    def cancel_search(self, index_id: str, max_hits: int) -> dict[str, Any]:
        """Execute a search whose handle was cancelled BEFORE the query
        started — the REST DELETE racing ahead of the query it targets.
        The root adopts the pre-cancelled token from the registry, so the
        cancel deterministically lands before any split executes: the
        response is typed-cancelled (when splits existed to cut short),
        carries zero hits, and the registry entry is gone afterwards —
        exactly what the cancel_responsiveness invariant audits."""
        alive = self.alive_nodes()
        if not alive:
            return {"error": "NoAliveNodes"}
        # same staleness as the root's own view: whether the query HAD
        # splits to cancel is judged through the node's polling metastore
        uid = self._uid(index_id)
        had_splits = bool(self.nodes[alive[0]].metastore.list_splits(
            ListSplitsQuery(index_uids=[uid],
                            states=[SplitState.PUBLISHED])))
        root = self._make_root(alive)
        qid = f"dst-cancel-{next(self._cancel_seq)}"
        token = CancellationToken()
        CANCEL_REGISTRY.register(qid, token)
        accepted = CANCEL_REGISTRY.cancel(qid, reason="dst cancel op")
        request = SearchRequest(index_ids=[index_id], query_ast=MatchAll(),
                                max_hits=max_hits, query_id=qid)
        try:
            resp = root.search(request)
        except Exception as exc:  # noqa: BLE001 - typed outcome per op
            return {"error": type(exc).__name__,
                    "registry_drained": CANCEL_REGISTRY.get(qid) is None}
        return {"accepted": accepted,
                "cancelled": bool(resp.cancelled),
                "num_hits": int(resp.num_hits),
                "had_splits": had_splits,
                "registry_drained": CANCEL_REGISTRY.get(qid) is None}

    def dashboard(self, index_id: str, max_hits: int, panels: int,
                  cancel_panel: bool = False) -> dict[str, Any]:
        """N concurrent shape-compatible panel searches through ONE root —
        the workload the query batcher (search/batcher.py) stacks into a
        single device dispatch. Panels share structure (Range on the "ts"
        fast field, same sort + max_hits) but carry distinct window bounds,
        so they are distinct queries under one group key. Each panel runs
        cold+warm like `search` (the cache≡cold invariant audits every
        lane); with `cancel_panel` one extra panel's handle is cancelled
        up front, so the batcher sheds it AFTER group formation — the
        masked-rider path, audited by cancel_responsiveness."""
        alive = self.alive_nodes()
        if not alive:
            return {"error": "NoAliveNodes"}
        root = self._make_root(alive)
        t0_us = 1_600_000_000 * 1_000_000

        def request_for(i: int, qid: Optional[str] = None) -> SearchRequest:
            # distinct upper bound per panel: distinct query, same shape
            window = Range(
                "ts", lower=RangeBound(t0_us, True),
                upper=RangeBound(t0_us + (i + 1) * 1_000 * 1_000_000, False))
            return SearchRequest(
                index_ids=[index_id], query_ast=window, max_hits=max_hits,
                sort_fields=[SortField("ts", "desc")], query_id=qid)

        panel_outs: list[Any] = [None] * panels

        def run_panel(i: int) -> None:
            outs: list[dict[str, Any]] = []
            for _ in range(2):
                try:
                    resp = root.search(request_for(i))
                except Exception as exc:  # noqa: BLE001 - typed outcome
                    outs.append({"error": type(exc).__name__})
                    continue
                complete = (not resp.timed_out and not resp.errors
                            and not resp.failed_splits)
                outs.append({
                    "ns": sorted(int(h.doc["n"]) for h in resp.hits),
                    "num_hits": int(resp.num_hits),
                    "complete": bool(complete),
                })
            panel_outs[i] = outs

        cancelled_out: dict[str, Any] = {}
        # same staleness as the root's own view (read before the threads
        # start, so the result is independent of panel interleaving)
        uid = self._uid(index_id)
        had_splits = bool(self.nodes[alive[0]].metastore.list_splits(
            ListSplitsQuery(index_uids=[uid],
                            states=[SplitState.PUBLISHED])))

        def run_cancelled(i: int) -> None:
            qid = f"dst-dashboard-{next(self._cancel_seq)}"
            token = CancellationToken()
            CANCEL_REGISTRY.register(qid, token)
            accepted = CANCEL_REGISTRY.cancel(qid, reason="dst dashboard shed")
            try:
                resp = root.search(request_for(i, qid=qid))
            except Exception as exc:  # noqa: BLE001 - typed outcome
                cancelled_out.update(
                    error=type(exc).__name__,
                    registry_drained=CANCEL_REGISTRY.get(qid) is None)
                return
            cancelled_out.update(
                accepted=accepted, cancelled=bool(resp.cancelled),
                num_hits=int(resp.num_hits), had_splits=had_splits,
                registry_drained=CANCEL_REGISTRY.get(qid) is None)

        threads = [sync.thread(target=run_with_context(run_panel),
                               args=(i,), name=f"dashboard-panel-{i}")
                   for i in range(panels)]
        if cancel_panel:
            threads.append(sync.thread(target=run_with_context(run_cancelled),
                                       args=(panels,),
                                       name="dashboard-shed"))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        result: dict[str, Any] = {"panels": panel_outs}
        if cancel_panel:
            result["cancelled_panel"] = cancelled_out
        return result

    def merge(self, node_id: str, index_id: str) -> dict[str, Any]:
        node = self.nodes[node_id]
        if not node.alive:
            return {"skipped": "dead"}
        uid = self._uid(index_id)
        storage = self.resolver.resolve(self._index_uri(index_id))
        query = ListSplitsQuery(index_uids=[uid],
                                states=[SplitState.PUBLISHED])
        try:
            splits = node.metastore.list_splits(query)
            docs_before = sum(s.metadata.num_docs for s in splits)
            operations = self.merge_policy.operations(splits)
            if not operations:
                return {"merged": 0}
            executor = MergeExecutor(uid, SIM_MAPPER, node.metastore, storage)
            executor.execute(operations[0])
            docs_after = sum(
                s.metadata.num_docs
                for s in node.metastore.list_splits(query))
        except Exception as exc:  # noqa: BLE001 - typed outcome per op
            return {"error": type(exc).__name__}
        return {"merged": 1, "docs_before": docs_before,
                "docs_after": docs_after}

    def autoscale(self, queue_depth: int) -> dict[str, Any]:
        size = self.autoscaler.tick(queue_depth)
        return {"pool_size": size,
                "min": self.autoscaler.min_workers,
                "max": self.autoscaler.max_workers}

    def plan(self) -> dict[str, Any]:
        tasks = [IndexingTask(self._uid(index_id), INGEST_V2_SOURCE_ID)
                 for index_id in self.scenario.indexes]
        alive = self.alive_nodes()
        physical = self.cp_scheduler.schedule(tasks, alive)
        assignment_counts: dict[str, int] = {}
        for node_id, node_tasks in sorted(physical.assignments.items()):
            for task in node_tasks:
                key = f"{task.index_uid}/{task.source_id}"
                assignment_counts[key] = assignment_counts.get(key, 0) + 1
        return {"nodes": alive, "assignments": assignment_counts,
                "num_tasks": len(tasks),
                "assigned_to_dead": sorted(
                    n for n in physical.assignments
                    if physical.assignments[n] and n not in alive)}

    # --- quiescence + oracle ------------------------------------------------
    def quiesce(self) -> dict[str, Any]:
        """Drain everything outstanding deterministically: restart every
        crashed node (disks are durable — WAL recovery is exactly what the
        zero-loss invariant audits), age past the metastore TTL, then drain
        every node (twice — a first pass may publish positions a second
        node's drain needs to observe before truncating)."""
        summary: dict[str, Any] = {
            "restarted": [node_id for node_id in sorted(self.nodes)
                          if not self.nodes[node_id].alive
                          and self.restart(node_id)],
            "promoted": self.promote_orphans()}
        for round_index in range(2):
            self.clock.advance(METASTORE_POLL_SECS * 2)
            for node_id in self.alive_nodes():
                summary[f"drain{round_index}:{node_id}"] = self.drain(node_id)
        return summary

    def searchable_ns(self, index_id: str) -> list[int]:
        """Ground truth, network-free: every doc `n` searchable across the
        index's published splits, duplicates preserved, via direct split
        reads against the shared object store."""
        uid = self._uid(index_id)
        storage = self.resolver.resolve(self._index_uri(index_id))
        metastore = FileBackedMetastore(self.meta_storage,
                                        polling_interval_secs=None)
        out: list[int] = []
        splits = metastore.list_splits(ListSplitsQuery(
            index_uids=[uid], states=[SplitState.PUBLISHED]))
        for split in splits:
            reader = SplitReader(
                storage, split_file_path(split.metadata.split_id))
            resp = leaf_search_single_split(
                SearchRequest(index_ids=[index_id], query_ast=MatchAll(),
                              max_hits=1_000_000),
                SIM_MAPPER, reader, split.metadata.split_id,
                device=self.device)
            docs = reader.fetch_docs([h.doc_id for h in resp.partial_hits])
            out.extend(int(d["n"]) for d in docs)
        return sorted(out)

    def close(self) -> None:
        shutil.rmtree(self.base_dir, ignore_errors=True)
