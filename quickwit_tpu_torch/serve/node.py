"""Node bootstrap + service wiring.

Role of the reference's `serve_quickwit` (`quickwit-serve/src/lib.rs:557`):
instantiate the services a node's roles require — searcher, indexer,
metastore, janitor — over a shared storage resolver and cluster membership,
and wire remote clients (gRPC or HTTP) for peers. A node runs any subset
of roles (`lib.rs:566-700`); single-process all-roles is the default.

Counterpart of the JAX package's `serve/node.py`, taking the same
`NodeConfig`. The node searches on `NodeConfig.device` (default `cuda`):
its `SearcherContext`, the offload fallback and the janitor's delete probes
run there. With `grpc_port` it serves the gRPC plane (`grpc_server.py`),
and peers that advertise one are reached over it; `offload` /
`offload_endpoint` give its leaf searches an offload pool (`offload/`),
and a `sqlite://<path>` metastore URI opens the SQL metastore.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from .. import resolve_device
from ..common.clock import get_clock, monotonic as _clock_monotonic
from ..cluster.membership import Cluster, ClusterChange, ClusterMember
from ..indexing.merge import MergeExecutor, merge_policy_from_config
from ..indexing.pipeline import IndexingPipeline, PipelineParams
from ..indexing.sources import VecSource, make_source
from ..ingest.router import INGEST_API_SOURCE_ID
from ..metastore.base import ListSplitsQuery, Metastore
from ..metastore.file_backed import FileBackedMetastore
from ..models.doc_mapper import DocMapper
from ..models.index_metadata import IndexConfig, IndexMetadata, SourceConfig
from ..models.split_metadata import SplitState
from ..query import ast as Q
from ..search.root import RootSearcher
from ..search.service import LocalSearchClient, SearcherContext, SearchService
from ..storage.base import StorageResolver

logger = logging.getLogger(__name__)

ALL_SERVICES = ("searcher", "indexer", "metastore", "janitor", "control_plane")


@dataclass
class NodeConfig:
    node_id: str = "node-0"
    cluster_id: str = "quickwit-tpu"
    roles: tuple[str, ...] = ALL_SERVICES
    metastore_uri: str = "ram:///qw/metastore"
    default_index_root_uri: str = "ram:///qw/indexes"
    rest_host: str = "127.0.0.1"
    rest_port: int = 7280
    peers: tuple[str, ...] = ()  # "host:port" seeds
    data_dir: Optional[str] = None  # WAL + scratch; tmp dir when unset
    wal_fsync: bool = True
    # TLS (role of quickwit-transport's rustls config): server cert/key
    # enable HTTPS on the REST listener; clusters are homogeneous, so a
    # TLS-enabled node speaks HTTPS to its peers too. `tls_ca_path`
    # verifies peer certs (self-signed deployments); `tls_skip_verify`
    # disables verification (tests only).
    tls_cert_path: Optional[str] = None
    tls_key_path: Optional[str] = None
    tls_ca_path: Optional[str] = None
    tls_skip_verify: bool = False
    # mTLS (reference quickwit-transport `validate_client`): the REST
    # listener REQUIRES peer client certificates signed by tls_ca_path,
    # and peer clients present the node cert/key as their identity
    tls_verify_client: bool = False
    # UDP scuttlebutt gossip (role of chitchat): when enabled, membership
    # disseminates over UDP on the REST port number and the REST heartbeat
    # loop is not started. peer_seeds serve as gossip seeds unchanged.
    gossip_enabled: bool = False
    # ingest v2 chained replication (reference replication_factor): 2 =
    # every persisted batch is synchronously replicated to one follower
    # before the ack; follower replicas promote when the leader dies
    replication_factor: int = 1
    # per-shard ingestion throughput target (MiB/s) driving the shard
    # autoscaling arbiter (reference: DEFAULT_SHARD_THROUGHPUT_LIMIT)
    max_shard_throughput_mib: float = 5.0
    # self-tracing (reference: quickwit-telemetry-exporters, opt-in via
    # QW_ENABLE_OPENTELEMETRY_OTLP_EXPORTER there): export the node's own
    # request spans into its own otel-traces index
    self_tracing: bool = False
    # cooperative indexing (reference cooperative_indexing.rs): WAL-drain
    # pipelines take phase-spread turns over each index's commit window,
    # at most max_concurrent_pipelines building splits at once. Off by
    # default: every tick drains every index immediately.
    cooperative_indexing: bool = False
    max_concurrent_pipelines: int = 3
    # serverless offload (reference: quickwit-lambda leaf offload): cold
    # splits beyond offload_max_local_splits per leaf request fan out over
    # an elastic worker pool (quickwit_tpu/offload/) — any servers
    # speaking the internal leaf-search protocol (peer nodes, FaaS
    # workers). `offload` is the pool config dict (keys: endpoints,
    # max_local_splits, task_splits, hedging/health/autoscale knobs);
    # offload_endpoint is the legacy single-endpoint form, normalized to
    # a pool of one. None/None = all-local.
    offload: Optional[dict] = None
    offload_endpoint: Optional[str] = None
    offload_max_local_splits: int = 16
    # disk-resident split cache (reference split_cache/mod.rs): None
    # disables; the dir is created on startup and scanned for leftovers
    split_cache_dir: Optional[str] = None
    split_cache_max_bytes: int = 10 << 30
    split_cache_max_splits: int = 10_000
    # gRPC listener (reference: the tonic server in grpc.rs — OTLP
    # collector services + Jaeger SpanReaderPlugin over stdlib HTTP/2).
    # None = disabled; 0 = ephemeral port.
    grpc_port: Optional[int] = None
    # standalone compactor role: bounded concurrent merge executions
    # (reference compactor_supervisor.rs slots)
    max_concurrent_merges: int = 2
    # multi-tenant workload isolation (tenancy/): per-tenant classes,
    # weights, rate limits and the overload controller. None/absent =
    # tenancy disabled, the tenant-blind neutral path.
    tenancy: Optional[dict] = None
    # the device the node searches on (`cuda` when None; `QW_DEVICE`)
    device: Optional[str] = None

    @property
    def tls_enabled(self) -> bool:
        return self.tls_cert_path is not None and self.tls_key_path is not None

    def server_ssl_context(self, alpn=None):
        """Server-side TLS context (role of quickwit-transport's rustls
        server config), shared by the REST listener and the gRPC plane
        (the latter passes alpn=["h2"])."""
        if not self.tls_enabled:
            return None
        import ssl
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(self.tls_cert_path, self.tls_key_path)
        if self.tls_verify_client:
            if not self.tls_ca_path:
                raise ValueError(
                    "rest.tls.verify_client requires rest.tls.ca_path "
                    "(the CA that signs peer client certificates)")
            # mTLS: only peers holding a CA-signed client cert connect
            context.verify_mode = ssl.CERT_REQUIRED
            context.load_verify_locations(cafile=self.tls_ca_path)
        if alpn:
            try:
                context.set_alpn_protocols(alpn)
            except NotImplementedError:
                pass
        return context

    def client_tls_kwargs(self) -> dict:
        """kwargs for HttpSearchClient toward peers of this cluster."""
        if not self.tls_enabled:
            return {}
        kwargs = {"tls": True, "ca_path": self.tls_ca_path,
                  "skip_verify": self.tls_skip_verify}
        if self.tls_verify_client:
            kwargs["client_cert_path"] = self.tls_cert_path
            kwargs["client_key_path"] = self.tls_key_path
        return kwargs


def _validate_doc_mapping(doc_mapper: DocMapper) -> None:
    """Create-time schema validation (reference: doc-mapper build errors,
    `tag_pruning.rs` allowed tag types + default-search-field checks).
    Raises ValueError → HTTP 400."""
    from ..models.doc_mapper import FieldType
    for tag in doc_mapper.tag_fields:
        fm = doc_mapper.field(tag)
        if fm is None:
            raise ValueError(f"tag field {tag!r} is not a mapped field")
        allowed = (fm.type in (FieldType.U64, FieldType.I64)
                   or (fm.type is FieldType.TEXT and fm.tokenizer == "raw"))
        if not allowed:
            raise ValueError(
                f"tag field {tag!r} must be a raw-tokenized text, u64, or "
                f"i64 field (got {fm.type.value}"
                f"{'/' + fm.tokenizer if fm.type is FieldType.TEXT else ''})")
    if doc_mapper.partition_key:
        # malformed expressions already raised RoutingExprError (a
        # ValueError → 400) in DocMapper.__post_init__; here we only
        # catch typos that can never resolve. Routing evaluates on the
        # RAW doc, so lenient/dynamic modes and subpaths of mapped JSON
        # fields resolve at runtime — only strict mode pins the schema.
        if doc_mapper.mode == "strict":
            for field in doc_mapper._routing_expr.field_names():
                if doc_mapper.field(field) is not None:
                    continue
                parts = field.split(".")
                # subpaths of a mapped JSON field hold arbitrary keys
                # even under strict mode; a PARENT path of concretely
                # mapped fields ("resource" over "resource.service")
                # also resolves at runtime (routing hashes the object)
                json_ancestor = any(
                    (fm := doc_mapper.field(".".join(parts[:i])))
                    is not None and fm.type is FieldType.JSON
                    for i in range(1, len(parts)))
                mapped_descendant = any(
                    fm.name.startswith(field + ".")
                    for fm in doc_mapper.field_mappings)
                if not json_ancestor and not mapped_descendant:
                    raise ValueError(
                        f"partition_key references unknown field `{field}`")
    for field in doc_mapper.default_search_fields:
        fm = doc_mapper.field(field)
        if fm is None:
            if (doc_mapper.mode == "dynamic"
                    and not doc_mapper.shadows_concrete_field(field)):
                # resolvable dynamically — but only if dynamic fields are
                # indexed (reference: dynamic default-field validation)
                fm = doc_mapper.dynamic_field(field)
            else:
                raise ValueError(
                    f"unknown default search field `{field}`")
        if not fm.indexed:
            raise ValueError(
                f"default search field `{field}` is not indexed")


def _require_string_list(name: str, value) -> tuple:
    if not isinstance(value, list) \
            or not all(isinstance(v, str) for v in value):
        raise ValueError(f"{name} must be a list of strings")
    return tuple(value)


class IndexService:
    """Index management operations (role of `quickwit-index-management`)."""

    def __init__(self, metastore: Metastore, storage_resolver: StorageResolver,
                 default_index_root_uri: str):
        self.metastore = metastore
        self.storage_resolver = storage_resolver
        self.default_index_root_uri = default_index_root_uri

    def create_index(self, index_config_json: dict[str, Any]) -> IndexMetadata:
        if not isinstance(index_config_json, dict):
            raise ValueError("index config must be a JSON object")
        index_id = index_config_json.get("index_id")
        if not isinstance(index_id, str) or not index_id \
                or not index_id.replace("-", "").replace("_", "").isalnum():
            raise ValueError(f"invalid index id {index_id!r}")
        for key in ("search_settings", "indexing_settings", "retention"):
            value = index_config_json.get(key)
            if value is not None and not isinstance(value, dict):
                raise ValueError(f"{key} must be a JSON object")
        doc_mapping = index_config_json.get("doc_mapping", {})
        doc_mapper = DocMapper.from_dict(doc_mapping)
        # search_settings.default_search_fields (reference config shape)
        # overrides/augments the doc_mapping-level list
        search_settings = index_config_json.get("search_settings") or {}
        fields = search_settings.get("default_search_fields")
        if fields:
            doc_mapper.default_search_fields = _require_string_list(
                "default_search_fields", fields)
        _validate_doc_mapping(doc_mapper)
        index_uri = index_config_json.get(
            "index_uri", f"{self.default_index_root_uri}/{index_id}")
        commit_timeout = index_config_json.get(
            "indexing_settings", {}).get("commit_timeout_secs", 60)
        if not isinstance(commit_timeout, (int, float)) \
                or commit_timeout <= 0:
            # cooperative indexing divides by this; a zero would halt the
            # node's whole WAL-drain loop
            raise ValueError(
                f"commit_timeout_secs must be positive, got {commit_timeout!r}")
        config = IndexConfig(
            index_id=index_id, index_uri=index_uri, doc_mapper=doc_mapper,
            commit_timeout_secs=commit_timeout,
            split_num_docs_target=index_config_json.get(
                "indexing_settings", {}).get("split_num_docs_target", 10_000_000),
            merge_policy=index_config_json.get(
                "indexing_settings", {}).get("merge_policy", {"type": "stable_log"}),
        )
        retention = index_config_json.get("retention")
        if retention:
            if not isinstance(retention.get("period"), str):
                raise ValueError(
                    'retention requires {"period": "<n> days", ...}')
            from ..models.index_metadata import RetentionPolicy
            config.retention = RetentionPolicy(
                period_seconds=_parse_period(retention["period"]),
                schedule=retention.get("schedule", "hourly"))
        metadata = IndexMetadata(
            # ULID-style unique incarnation (reference uses a ULID suffix):
            # wall-clock-derived values collide on delete+recreate within
            # the same second, defeating uid-based conflict detection.
            index_uid=f"{index_id}:{uuid.uuid4().hex[:13]}",
            index_config=config,
            sources={INGEST_API_SOURCE_ID: SourceConfig(INGEST_API_SOURCE_ID, "vec")},
        )
        self.metastore.create_index(metadata)
        return metadata

    def update_index(self, index_id: str,
                     update_json: dict[str, Any]) -> IndexMetadata:
        """Live index-config update (reference `update_index`,
        `index_api/rest_handler.rs` PUT route): search settings,
        retention, indexing settings, and APPEND-ONLY doc-mapping
        changes — existing fields must stay byte-identical (old splits
        were built with them); new fields only apply to future splits,
        which is exactly the reference's compatibility rule."""
        metadata = self.metastore.index_metadata(index_id)
        current = metadata.index_config
        for key in ("search_settings", "indexing_settings"):
            if update_json.get(key) is not None \
                    and not isinstance(update_json[key], dict):
                raise ValueError(f"{key} must be a JSON object")
        # round-trip copy: index_metadata() returns the metastore's LIVE
        # cached object — mutating it before validation would corrupt
        # the running config on a rejected request
        doc_mapper = DocMapper.from_dict(current.doc_mapper.to_dict())
        if "doc_mapping" in update_json:
            new_mapper = DocMapper.from_dict(update_json["doc_mapping"])
            old_fields = {f.name: f.to_dict()
                          for f in current.doc_mapper.field_mappings}
            new_fields = {f.name: f.to_dict()
                          for f in new_mapper.field_mappings}
            for name, old in old_fields.items():
                if name not in new_fields:
                    raise ValueError(
                        f"doc_mapping update cannot REMOVE field "
                        f"{name!r} (existing splits were built with it)")
                if new_fields[name] != old:
                    raise ValueError(
                        f"doc_mapping update cannot CHANGE field "
                        f"{name!r} (existing splits were built with it); "
                        "only new fields may be appended")
            if new_mapper.timestamp_field != \
                    current.doc_mapper.timestamp_field:
                raise ValueError("timestamp_field is immutable")
            if not new_mapper.default_search_fields:
                new_mapper.default_search_fields = \
                    current.doc_mapper.default_search_fields
            doc_mapper = new_mapper
        search_settings = update_json.get("search_settings") or {}
        if "default_search_fields" in search_settings:
            doc_mapper.default_search_fields = _require_string_list(
                "default_search_fields",
                search_settings["default_search_fields"])
        _validate_doc_mapping(doc_mapper)
        indexing = update_json.get("indexing_settings") or {}
        commit_timeout = indexing.get(
            "commit_timeout_secs", current.commit_timeout_secs)
        if not isinstance(commit_timeout, (int, float)) \
                or commit_timeout <= 0:
            raise ValueError(
                f"commit_timeout_secs must be positive, got "
                f"{commit_timeout!r}")
        merge_policy = indexing.get("merge_policy", current.merge_policy)
        if not isinstance(merge_policy, dict):
            raise ValueError("merge_policy must be a JSON object")
        # reject now, not on every future merge pass
        merge_policy_from_config(merge_policy)
        config = IndexConfig(
            index_id=current.index_id,          # immutable
            index_uri=current.index_uri,        # immutable
            doc_mapper=doc_mapper,
            commit_timeout_secs=commit_timeout,
            split_num_docs_target=indexing.get(
                "split_num_docs_target", current.split_num_docs_target),
            merge_policy=merge_policy,
            retention=current.retention,
        )
        if "retention" in update_json:
            retention = update_json["retention"]
            if retention is None:
                config.retention = None
            elif not isinstance(retention, dict) \
                    or not isinstance(retention.get("period"), str):
                raise ValueError(
                    'retention must be null or {"period": "<n> days", '
                    '"schedule"?: ...}')
            else:
                from ..models.index_metadata import RetentionPolicy
                config.retention = RetentionPolicy(
                    period_seconds=_parse_period(retention["period"]),
                    schedule=retention.get("schedule", "hourly"))
        self.metastore.update_index_config(metadata.index_uid, config)
        return self.metastore.index_metadata(index_id)

    def delete_index(self, index_id: str) -> list[str]:
        metadata = self.metastore.index_metadata(index_id)
        splits = self.metastore.list_splits(
            ListSplitsQuery(index_uids=[metadata.index_uid]))
        storage = self.storage_resolver.resolve(metadata.index_config.index_uri)
        removed = []
        for split in splits:
            try:
                storage.delete(f"{split.metadata.split_id}.split")
                removed.append(split.metadata.split_id)
            except Exception:  # noqa: BLE001 - missing files are fine
                pass
        self.metastore.delete_index(metadata.index_uid)
        return removed


def _parse_period(period: str) -> int:
    period = period.strip()
    units = {"seconds": 1, "minutes": 60, "hours": 3600, "days": 86400,
             "weeks": 7 * 86400}
    parts = period.split()
    if len(parts) == 2 and parts[1] in units:
        return int(parts[0]) * units[parts[1]]
    raise ValueError(f"cannot parse retention period {period!r}")


class Node:
    """A running node: metastore + searcher + indexer + janitor services
    according to roles, plus the client pool for distributed search."""

    def __init__(self, config: NodeConfig,
                 storage_resolver: Optional[StorageResolver] = None):
        resolve_device(config.device)   # raise before any thread starts
        self.config = config
        if config.tenancy is not None:
            # arm the process-global registry from the node config's
            # `tenancy` section (absent config leaves whatever state the
            # registry already has — embedded/test nodes stay neutral)
            from ..tenancy import configure_tenancy
            configure_tenancy(config.tenancy)
        self.storage_resolver = storage_resolver or StorageResolver.default()
        if config.metastore_uri.startswith("sqlite://"):
            # SQL backend (reference: PostgresqlMetastore): transactional
            # publish on a database instead of object-store CAS
            from ..metastore.sql import SqlMetastore
            self.metastore: Metastore = SqlMetastore(
                config.metastore_uri[len("sqlite://"):])
        else:
            self.metastore = FileBackedMetastore(
                self.storage_resolver.resolve(config.metastore_uri))
        self.cluster = Cluster(
            config.node_id, config.roles,
            rest_endpoint=f"{config.rest_host}:{config.rest_port}")
        self.split_cache = None
        if config.split_cache_dir:
            from ..storage.split_cache import DiskSplitCache
            self.split_cache = DiskSplitCache(
                config.split_cache_dir, self.storage_resolver,
                max_bytes=config.split_cache_max_bytes,
                max_splits=config.split_cache_max_splits)
            self.split_cache.start()
        self.searcher_context = SearcherContext(
            self.storage_resolver,
            offload=config.offload,
            offload_endpoint=config.offload_endpoint,
            offload_max_local_splits=config.offload_max_local_splits,
            split_cache=self.split_cache, device=config.device)
        self.search_service = SearchService(self.searcher_context, config.node_id)
        self.index_service = IndexService(self.metastore, self.storage_resolver,
                                          config.default_index_root_uri)
        self.clients: dict[str, Any] = {
            config.node_id: LocalSearchClient(self.search_service)}
        # node_id -> (grpc_endpoint, rest_endpoint) the client was built
        # for, so role-only membership updates don't churn live sockets
        self._client_endpoints: dict[str, tuple] = {}
        self._transform_cache: dict[tuple, Any] = {}
        # cached external-source clients (kafka connections survive passes)
        self._external_sources: dict[tuple, Any] = {}
        # one pass at a time per (index_uid, source_id): a REST-triggered
        # pass and the background tick must not drain the same cached
        # source concurrently (the per-source pipeline-actor guarantee)
        self._source_pass_locks: dict[tuple, threading.Lock] = {}
        self.root_searcher = RootSearcher(
            self.metastore, self.clients,
            nodes_provider=lambda: self.cluster.nodes_with_role("searcher"))
        self.cluster.subscribe(self._on_cluster_change)
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._lock = threading.Lock()
        # ingest v2: WAL-backed write path (router -> ingester shards)
        import os
        import tempfile
        from ..ingest.ingester import Ingester
        from ..ingest.router import IngestRouter
        data_dir = config.data_dir or tempfile.mkdtemp(prefix="qwt-data-")
        self.data_dir = data_dir
        self.ingester = Ingester(
            os.path.join(data_dir, "wal"), fsync=config.wal_fsync,
            replicate_to=(self._replicate_batch
                          if config.replication_factor > 1 else None))
        if config.replication_factor > 1:
            self.ingester.on_truncate = self._replica_truncate
        self.ingest_router = IngestRouter(
            self.ingester, shard_prefix=config.node_id,
            get_or_create_shards=self._live_open_shards)
        from ..control_plane.scheduler import IndexingScheduler
        self.indexing_scheduler = IndexingScheduler()
        # None until a control-plane plan is first applied (legacy
        # rendezvous election gates external sources until then).
        self._applied_indexing_tasks: Optional[list[dict]] = None
        self._assigned_sources: set[tuple[str, str]] = set()
        from ..control_plane.arbiter import (ScalingArbiter, ScalingPermits,
                                             ShardRateTracker)
        self.scaling_arbiter = ScalingArbiter(
            max_shard_throughput_mib=config.max_shard_throughput_mib)
        self.scaling_permits = ScalingPermits()
        self.shard_rate_tracker = ShardRateTracker()
        from ..search.scroll import ScrollStore
        self.scroll_store = ScrollStore()
        from .otel import OtelService
        self.otel = OtelService(self)
        self.grpc_server = None
        if config.grpc_port is not None:
            from .grpc_server import GrpcServer
            self.grpc_server = GrpcServer(
                self, host=config.rest_host, port=config.grpc_port,
                ssl_context=config.server_ssl_context(alpn=["h2"]))
        # standalone compactor role (reference quickwit-compaction):
        # planner + bounded supervisor; when any alive compactor exists,
        # indexers stop running merges themselves
        self.compactor = None
        self.compaction_planner = None
        if "compactor" in config.roles:
            from ..compaction import CompactionPlanner, CompactorSupervisor
            self.compactor = CompactorSupervisor(
                self.metastore, self.storage_resolver,
                node_id=config.node_id,
                max_concurrent_merges=config.max_concurrent_merges)
            self.compaction_planner = CompactionPlanner(self.metastore)
        # cooperative indexing state (shared across every index pipeline)
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._coop_permits = threading.Semaphore(
            max(1, config.max_concurrent_pipelines))
        self._coop_cycles: dict[str, Any] = {}
        self._coop_next_wake: dict[str, float] = {}
        self._coop_clock = _clock_monotonic  # process clock; tests/DST swap in a virtual one
        self.pipeline_metrics: dict[str, Any] = {}
        self.span_exporter = None
        self._ensure_span_exporter()

    def _ensure_span_exporter(self) -> None:
        """Create + register the self-tracing exporter if configured.

        Called from __init__ AND start_background_services: stop tears the
        exporter down, so a stop/start cycle must recreate it or the node
        would keep serving with `self_tracing: true` while silently
        exporting nothing."""
        if not self.config.self_tracing or self.span_exporter is not None:
            return
        from ..observability.tracing import TRACER, BatchSpanExporter
        self.span_exporter = BatchSpanExporter(
            self.otel.ingest_traces, service_name="quickwit-tpu",
            node_id=self.config.node_id, scope=self.config.node_id)
        TRACER.add_processor(self.span_exporter)

    def _live_open_shards(self, index_uid: str,
                          source_id: str) -> list[str]:
        """Routing-table resolver: the LIVE open leader shards for the
        source (autoscaling changes the set); falls back to the router's
        static default for the very first batch."""
        from ..ingest.ingester import ShardState
        live = sorted(
            s.shard_id for s in self.ingester.list_shards(index_uid)
            if s.source_id == source_id and s.role == "leader"
            and s.state is ShardState.OPEN)
        return live or self.ingest_router._default_shards(index_uid,
                                                          source_id)

    # ------------------------------------------------------------------
    def _grpc_advertise(self) -> str:
        """This node's gRPC endpoint for peers ("" when disabled). A TLS
        cluster advertises too — the gRPC plane runs h2-over-TLS with the
        same cert/CA/mTLS settings as the REST listener."""
        if self.grpc_server is None:
            return ""
        return f"{self.config.rest_host}:{self.grpc_server.port}"

    def _make_peer_client(self, member: ClusterMember):
        """Search client for one peer: the gRPC plane (binary payloads on a
        persistent HTTP/2 connection — the reference's codegen'd tonic
        client role) when the peer advertises it, JSON/HTTP otherwise.
        Under TLS both planes carry the cluster's TLS settings."""
        if member.grpc_endpoint:
            from .grpc_server import GrpcSearchClient
            return GrpcSearchClient(member.grpc_endpoint,
                                    member.rest_endpoint,
                                    **self.config.client_tls_kwargs())
        from .http_client import HttpSearchClient
        return HttpSearchClient(member.rest_endpoint,
                                **self.config.client_tls_kwargs())

    def _on_cluster_change(self, change: ClusterChange) -> None:
        member = change.member
        if change.kind == "remove":
            if member.node_id != self.config.node_id:
                self._close_client(self.clients.pop(member.node_id, None))
                self._client_endpoints.pop(member.node_id, None)
            return
        if member.node_id == self.config.node_id:
            return
        if "searcher" in member.roles and member.rest_endpoint:
            # replace the client only when the peer's endpoints changed (a
            # rejoin under new ports): closing a live client mid-flight
            # fails in-flight RPCs and trips the circuit breaker, so
            # role-only updates must keep the existing connection
            endpoints = (member.grpc_endpoint, member.rest_endpoint)
            if self._client_endpoints.get(member.node_id) == endpoints \
                    and member.node_id in self.clients:
                return
            # publish the replacement BEFORE closing the old reference: a
            # concurrent search thread that already fetched the old client
            # may still fail, but no thread can fetch an already-closed
            # client from the map
            old = self.clients.get(member.node_id)
            self._client_endpoints[member.node_id] = endpoints
            self.clients[member.node_id] = self._make_peer_client(member)
            self._close_client(old)

    @staticmethod
    def _close_client(client) -> None:
        close = getattr(client, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass

    # ------------------------------------------------------------------
    # ingest (v1-style: REST batch → immediate split, commit semantics
    # per-request; the WAL-based v2 path lives in quickwit_tpu.ingest)
    def ingest(self, index_id: str, docs: list[dict],
               commit: str = "auto") -> dict[str, Any]:
        metadata = self._metadata_or_template(index_id)
        if not self._source_enabled(metadata, INGEST_API_SOURCE_ID):
            from ..metastore.base import MetastoreError
            raise MetastoreError(
                f"ingest source for index {index_id!r} is disabled",
                kind="failed_precondition")
        doc_mapper = metadata.index_config.doc_mapper
        storage = self.storage_resolver.resolve(metadata.index_config.index_uri)
        params = PipelineParams(
            index_uid=metadata.index_uid,
            source_id=INGEST_API_SOURCE_ID,
            node_id=self.config.node_id,
            split_num_docs_target=metadata.index_config.split_num_docs_target,
        )
        source = VecSource(docs, partition_id=f"ingest-{get_clock().time_ns()}")
        pipeline = IndexingPipeline(
            params, doc_mapper, source, self.metastore, storage,
            transform=self._transform_for(metadata, INGEST_API_SOURCE_ID))
        counters = pipeline.run_to_completion()
        return {"num_docs_for_processing": len(docs),
                "num_ingested_docs": counters.num_docs_processed,
                "num_invalid_docs": counters.num_docs_invalid}

    # source types with their own drive paths (REST ingest / WAL drain)
    _INTERNAL_SOURCE_TYPES = ("vec", "void", "ingest_api", "ingest_v2")

    def run_source_pass(self, index_id: str, source_id: str):
        """Drain one configured EXTERNAL source (file/kafka) through an
        indexing pipeline pass — the role of the reference's per-(index,
        source) pipeline actors under IndexingService
        (`indexing_service.rs:1152`). Checkpoints make each pass resume
        exactly where the last one stopped; source clients are cached so
        broker connections persist across passes."""
        with self._lock:
            pass_lock = self._source_pass_locks.setdefault(
                # qwlint: disable-next-line=QW008 - serve-layer transport
                # infrastructure (sockets, real IO) outside the DST-raced path;
                # gating it would block the token on real IO
                (index_id, source_id), threading.Lock())
        with pass_lock:
            # metadata is read INSIDE the lock: a pass queued behind a
            # running one must see config changes (source deleted /
            # re-pointed) made while it waited
            metadata = self.metastore.index_metadata(index_id)
            return self._run_source_pass_locked(metadata, source_id)

    def _run_source_pass_locked(self, metadata, source_id: str):
        source_config = metadata.sources.get(source_id)
        if (source_config is None or not source_config.enabled
                or source_config.source_type in self._INTERNAL_SOURCE_TYPES):
            # a deleted/disabled source releases its cached client (and
            # its broker sockets) immediately, not at index deletion
            stale = self._external_sources.pop(
                (metadata.index_uid, source_id), None)
            if stale is not None:
                self._close_source(stale[1])
            return None
        # config fingerprint in the key: delete + re-add with the same
        # source_id but a new topic/brokers must not keep consuming the
        # old config through a stale cached client
        fingerprint = json.dumps(
            [source_config.source_type, source_config.params],
            sort_keys=True)
        key = (metadata.index_uid, source_id)
        cached = self._external_sources.get(key)
        if cached is not None and cached[0] != fingerprint:
            self._close_source(cached[1])
            cached = None
        if cached is None:
            cached = (fingerprint,
                      make_source(source_config.source_type,
                                  source_config.params,
                                  resolver=self.storage_resolver))
            self._external_sources[key] = cached
        source = cached[1]
        storage = self.storage_resolver.resolve(
            metadata.index_config.index_uri)
        pipeline = IndexingPipeline(
            PipelineParams(
                index_uid=metadata.index_uid, source_id=source_id,
                node_id=self.config.node_id,
                split_num_docs_target=metadata.index_config
                .split_num_docs_target),
            metadata.index_config.doc_mapper, source, self.metastore,
            storage, transform=self._transform_for(metadata, source_id))
        try:
            return pipeline.run_to_completion()
        except Exception:
            # a broken source connection must not wedge future passes on
            # a stale cached client
            self._external_sources.pop(key, None)
            self._close_source(source)
            raise

    @staticmethod
    def _close_source(source) -> None:
        close = getattr(source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort socket cleanup
                logger.debug("source close failed", exc_info=True)

    def _transform_for(self, metadata: IndexMetadata, source_id: str):
        """Compiled doc transform from the source config's
        `transform: {script: ...}` params, if any (the reference's VRL
        source transforms, doc_processor.rs:94). Compiled once per
        (index, source, script) — the reference compiles VRL at pipeline
        spawn, not per batch."""
        from ..indexing.transform import Transform, transform_script_of
        source = metadata.sources.get(source_id)
        if source is None:
            return None
        script = transform_script_of(source.params)
        if script is None:
            return None
        key = (metadata.index_uid, source_id, script)
        if key not in self._transform_cache:
            self._transform_cache[key] = Transform(script)
        return self._transform_cache[key]

    def _source_enabled(self, metadata: IndexMetadata, source_id: str) -> bool:
        source = metadata.sources.get(source_id)
        return source is None or source.enabled

    def _metadata_or_template(self, index_id: str) -> IndexMetadata:
        """Existing index, or auto-created from a matching index template
        (reference: template matching by index-id patterns)."""
        from ..metastore.base import MetastoreError
        try:
            return self.metastore.index_metadata(index_id)
        except MetastoreError as exc:
            if exc.kind != "not_found":
                raise
            template = getattr(self.metastore, "find_index_template",
                               lambda _i: None)(index_id)
            if template is None:
                raise
            config = dict(template.get("index_config", {}))
            config["index_id"] = index_id
            logger.info("auto-creating index %s from template %s",
                        index_id, template["template_id"])
            try:
                return self.index_service.create_index(config)
            except MetastoreError as create_exc:
                if create_exc.kind != "already_exists":
                    raise
                # lost a concurrent auto-create race: the index exists now
                return self.metastore.index_metadata(index_id)

    # ------------------------------------------------------------------
    def _replicate_batch(self, index_uid: str, source_id: str,
                         shard_id: str, first_position: int,
                         payloads: list[bytes]) -> None:
        """Leader side of chained replication: pick the follower by
        rendezvous on the shard's queue id among OTHER live indexer nodes
        and replicate synchronously; the persist ack implies follower
        durability (reference: replication.rs + persist semantics)."""
        import base64

        from ..common.rendezvous import sort_by_rendezvous_hash
        from ..ingest.ingester import shard_queue_id
        peers = [m for m in self.cluster.members()
                 if m.node_id != self.config.node_id
                 and "indexer" in m.roles and m.rest_endpoint]
        if not peers:
            raise IOError(
                "replication_factor > 1 but no live follower is available")
        queue_id = shard_queue_id(index_uid, source_id, shard_id)
        ordered = sort_by_rendezvous_hash(queue_id,
                                          [m.node_id for m in peers])
        follower = next(m for m in peers if m.node_id == ordered[0])
        recorded = getattr(self, "_recorded_chains", None)
        if recorded is None:
            recorded = self._recorded_chains = {}
        chain = (self.config.node_id, follower.node_id)
        if recorded.get(queue_id) != chain:
            # durable chain registration BEFORE the first batch reaches a
            # new follower: failover promotes only the REGISTERED follower
            # (a rejoined copy with a stale WAL is not eligible), so the
            # record must exist before this follower can hold acked data.
            # A registry write failure fails the persist — acking a batch
            # on an unregistered chain would void the promotion-safety
            # argument (tools/qwmc replication model).
            self.metastore.record_shard_chain(
                index_uid, source_id, shard_id,
                leader=self.config.node_id, follower=follower.node_id)
            recorded[queue_id] = chain
        client = self.clients.get(follower.node_id)
        if client is None:
            # same construction _on_cluster_change would use (gRPC plane
            # when advertised) — a plain HTTP client cached here would
            # otherwise pin this peer to JSON/HTTP forever once the
            # endpoints are recorded. Cache: per-batch client construction
            # would defeat the circuit breaker and pay a TCP/TLS handshake
            # per persist. Recording the endpoints keeps the next no-op
            # gossip update from closing a client mid-replication
            # (_on_cluster_change keeps clients whose endpoints are
            # unchanged).
            client = self._make_peer_client(follower)
            self.clients[follower.node_id] = client
            self._client_endpoints[follower.node_id] = (
                follower.grpc_endpoint, follower.rest_endpoint)

        def send(first: int, batch: list[bytes], reset: bool = False):
            return client.replicate({
                "index_uid": index_uid, "source_id": source_id,
                "shard_id": shard_id, "first_position": first,
                "payloads": [base64.b64encode(p).decode() for p in batch],
                **({"reset": True} if reset else {}),
            })

        from .http_client import HttpStatusError
        try:
            send(first_position, payloads)
            return
        except HttpStatusError as exc:
            if exc.status != 409:
                raise
            gap_body = exc.body
        # gap: a fresh follower (rendezvous re-pick after membership change)
        # is missing earlier records — backfill from the local WAL. When our
        # retained WAL starts past the follower's position (truncated behind
        # the published checkpoint), the follower resets to what we hold:
        # the metastore checkpoint already covers the records below.
        shard = self.ingester.shard(index_uid, source_id, shard_id)
        replica_pos = json.loads(gap_body or b"{}").get(
            "replica_position", 0)
        records = shard.log.read_from(int(replica_pos), max_records=1 << 20)
        if not records:
            raise IOError(f"cannot backfill follower for {shard_id!r}: "
                          "no retained records")
        start = records[0][0]
        send(start, [p for _, p in records], reset=(start > replica_pos))

    def _replica_truncate(self, index_uid: str, source_id: str,
                          shard_id: str, position: int) -> None:
        """Best-effort truncation propagation to the follower (replica
        WALs must not grow without bound while the leader reclaims)."""
        from ..common.rendezvous import sort_by_rendezvous_hash
        from ..ingest.ingester import shard_queue_id
        peers = [m for m in self.cluster.members()
                 if m.node_id != self.config.node_id
                 and "indexer" in m.roles and m.rest_endpoint]
        if not peers:
            return
        queue_id = shard_queue_id(index_uid, source_id, shard_id)
        ordered = sort_by_rendezvous_hash(queue_id,
                                          [m.node_id for m in peers])
        follower = next(m for m in peers if m.node_id == ordered[0])
        client = self.clients.get(follower.node_id)
        if client is None:
            return
        client._post("/internal/replica_truncate", {
            "index_uid": index_uid, "source_id": source_id,
            "shard_id": shard_id, "position": position})

    def _shard_chain(self, shard) -> Optional[dict]:
        """Registered replication chain for the shard, or None when it
        never formed one (or the index is gone)."""
        from ..metastore.base import MetastoreError
        try:
            return self.metastore.shard_chain(shard.index_uid,
                                              shard.source_id,
                                              shard.shard_id)
        except MetastoreError:
            return None

    def _published_floor(self, shard) -> int:
        """Published checkpoint for the shard (exclusive end): everything
        below it is already in published splits."""
        from ..metastore.base import MetastoreError
        from ..metastore.checkpoint import BEGINNING
        try:
            checkpoint = self.metastore.source_checkpoint(shard.index_uid,
                                                          shard.source_id)
        except MetastoreError:
            return 0
        position = checkpoint.position_for(shard.shard_id)
        return 0 if position == BEGINNING else int(position)

    def promote_orphaned_replicas(self, grace_secs: float = 30.0) -> list[str]:
        """Replica shards whose leader node is no longer a live cluster
        member get promoted and drained from here (the reference's
        AdviseResetShards / shard re-open on ingester death). The durable
        chain registry (metastore.shard_chain) names the current leader —
        shard-id prefixes ("{node_id}-shard-NN") only seed it for shards
        that never replicated — and gates the takeover: only the
        REGISTERED follower is eligible, because a copy that merely looks
        healthy may have crashed out of the chain and be missing acked
        batches (qwmc's stale-replica-promotion counterexample). A
        promoted log behind the published checkpoint forward-resets to it,
        or fresh appends would land on already-consumed positions.

        Promotion is irreversible (the old leader's persists are refused
        after it), so it only fires after the leader has been CONTINUOUSLY
        absent for `grace_secs` — a heartbeat blip, GC pause, or this
        node's own fresh restart (empty membership view) must not
        split-brain the shard."""
        alive = {m.node_id for m in self.cluster.members()}
        dead_since = getattr(self, "_leader_dead_since", None)
        if dead_since is None:
            dead_since = self._leader_dead_since = {}
        now = _clock_monotonic()
        promoted = []
        refreshed = False
        for queue_id, shard in self.ingester.replica_shards():
            chain = self._shard_chain(shard)
            if chain is not None and chain.get("leader") == self.config.node_id:
                # a crash between the registry write and the role flip left
                # the record already naming this node: finish the promotion
                if self.ingester.promote_replica(
                        queue_id, min_position=self._published_floor(shard)):
                    promoted.append(shard.shard_id)
                continue
            leader_node = (chain["leader"] if chain is not None
                           else shard.shard_id.rsplit("-shard-", 1)[0])
            if leader_node in alive:
                dead_since.pop(leader_node, None)
                continue
            first_seen_dead = dead_since.setdefault(leader_node, now)
            if now - first_seen_dead < grace_secs:
                continue
            if not refreshed:
                # the takeover decision must read the registry and the
                # checkpoint fresh, not from the polling cache
                self.metastore.refresh()
                refreshed = True
                chain = self._shard_chain(shard)
            if chain is not None and chain.get("follower") != self.config.node_id:
                continue  # not the registered follower: not eligible
            # registry BEFORE the role flip: a crash in between leaves the
            # record naming this node, and the next tick finishes the flip
            # (branch above) instead of another copy taking over
            from ..metastore.base import MetastoreError
            try:
                self.metastore.record_shard_chain(
                    shard.index_uid, shard.source_id, shard.shard_id,
                    leader=self.config.node_id, follower=None)
            except MetastoreError:
                continue  # retry next tick; the old record still gates
            if self.ingester.promote_replica(
                    queue_id, min_position=self._published_floor(shard)):
                promoted.append(shard.shard_id)
                logger.warning(
                    "promoted replica shard %s (leader %s dead for %.0fs)",
                    shard.shard_id, leader_node, now - first_seen_dead)
        return promoted

    def reconcile_stale_leaders(self) -> list[str]:
        """Demote local leader-role shards whose REGISTERED leader is
        another node: this node crashed, its replica was promoted
        elsewhere, and WAL recovery restored the stale leader role — the
        split-brain that qwmc's stale-leader-rejoin counterexample turns
        into an acked-record loss (re-used published positions). The WAL
        resets at the published checkpoint; the registered chain holds
        every acked record, so the stale copy is redundant."""
        from ..ingest.ingester import shard_queue_id
        demoted = []
        for shard in self.ingester.list_shards(include_replicas=False):
            chain = self._shard_chain(shard)
            if chain is None or chain.get("leader") == self.config.node_id:
                continue
            queue_id = shard_queue_id(shard.index_uid, shard.source_id,
                                      shard.shard_id)
            if self.ingester.demote_to_replica(queue_id,
                                               self._published_floor(shard)):
                demoted.append(shard.shard_id)
                logger.warning(
                    "demoted stale leader shard %s (registry names %s)",
                    shard.shard_id, chain["leader"])
        return demoted

    def ingest_v2(self, index_id: str, docs: list[dict]) -> dict[str, Any]:
        """Durable WAL ingest (v2 path): docs are fsync'd into shard queues
        and become searchable after the next ingest pipeline pass."""
        metadata = self._metadata_or_template(index_id)
        return self.ingest_router.ingest(metadata.index_uid, docs)

    def run_ingest_pass(self, index_id: str) -> dict[str, Any]:
        """Drain WAL shards into splits, publish, truncate behind the
        published checkpoint (the decoupled indexer side of ingest v2)."""
        from ..indexing.sources import IngestSource
        from ..ingest.router import INGEST_V2_SOURCE_ID
        metadata = self.metastore.index_metadata(index_id)
        uid = metadata.index_uid
        if not self._source_enabled(metadata, INGEST_V2_SOURCE_ID):
            return {"num_docs_indexed": 0, "num_splits_published": 0,
                    "source_disabled": True}
        if INGEST_V2_SOURCE_ID not in metadata.sources:
            self.metastore.add_source(
                uid, SourceConfig(INGEST_V2_SOURCE_ID, "ingest"))
        source = IngestSource(self.ingester, uid, INGEST_V2_SOURCE_ID)
        params = PipelineParams(
            index_uid=uid, source_id=INGEST_V2_SOURCE_ID,
            node_id=self.config.node_id,
            split_num_docs_target=metadata.index_config.split_num_docs_target)
        pipeline = IndexingPipeline(
            params, metadata.index_config.doc_mapper, source, self.metastore,
            self.storage_resolver.resolve(metadata.index_config.index_uri),
            transform=self._transform_for(metadata, INGEST_V2_SOURCE_ID))
        counters = pipeline.run_to_completion()
        # truncate WAL behind the (now durable) published checkpoint
        checkpoint = self.metastore.source_checkpoint(uid, INGEST_V2_SOURCE_ID)
        from ..metastore.checkpoint import BEGINNING
        for shard in self.ingester.list_shards(uid):
            position = checkpoint.position_for(shard.shard_id)
            if position != BEGINNING:
                self.ingester.truncate(uid, INGEST_V2_SOURCE_ID,
                                       shard.shard_id, int(position))
        return {"num_docs_indexed": counters.num_docs_processed,
                "num_splits_published": counters.num_splits_published,
                "uncompressed_bytes": counters.num_published_bytes}

    def _cooperative_drain(self, metadata: IndexMetadata) -> None:
        """One cooperative-indexing turn for an index's WAL pipeline
        (reference cooperative_indexing.rs): drain only at this
        pipeline's phase of the commit window, under the node-wide
        concurrency permit; the post-work sleep re-phases the cycle."""
        from ..indexing.cooperative import CooperativeIndexingCycle
        uid = metadata.index_uid
        now = self._coop_clock()
        cycle = self._coop_cycles.get(uid)
        if cycle is None:
            cycle = CooperativeIndexingCycle(
                uid, metadata.index_config.commit_timeout_secs,
                self._coop_permits, clock=self._coop_clock)
            self._coop_cycles[uid] = cycle
            self._coop_next_wake[uid] = now + cycle.initial_sleep_duration()
        if now < self._coop_next_wake[uid]:
            return
        # never block the shared tick loop on the semaphore: a full house
        # means another pipeline is indexing — retry next tick
        period = cycle.begin_period(timeout=0.001)
        if period is None:
            return
        published_bytes = 0
        try:
            result = self.run_ingest_pass(metadata.index_id)
            published_bytes = int(result.get("uncompressed_bytes", 0))
        finally:
            sleep_secs, metrics = period.end_of_work(published_bytes)
            self._coop_next_wake[uid] = self._coop_clock() + sleep_secs
            self.pipeline_metrics[uid] = metrics

    # -- control-plane convergence (§3.4) -------------------------------
    def apply_indexing_plan(self, tasks: list[dict]) -> dict[str, Any]:
        """This node's slice of the physical indexing plan (the role of
        the reference's per-indexer ApplyIndexingPlanRequest,
        `indexing_service.rs:1152`): external-source passes run only for
        assigned (index, source) pairs once a plan is applied. With no
        plan ever applied, the legacy per-index rendezvous election
        gates instead, so single-node/CLI deployments need no control
        plane."""
        applied = [
            {"index_uid": t["index_uid"], "source_id": t["source_id"],
             "shard_id": t.get("shard_id")}
            for t in tasks]
        # The ingest actor thread reads both fields; the gate checks
        # _applied_indexing_tasks last, so publish the source set FIRST
        # to avoid one tick seeing new tasks with the stale set.
        self._assigned_sources = {
            (t["index_uid"], t["source_id"]) for t in applied}
        self._applied_indexing_tasks = applied
        return {"applied": len(applied)}

    def owns_index(self, index_uid: str) -> bool:
        """Deterministic single-worker election per index: every node
        computes the same owner from the same alive set (rendezvous
        hash, stateless — unlike the scheduler's affinity memory), so
        concurrent cli-run indexer nodes sharing one file-backed
        metastore don't race merge writes on the same index. The legacy
        source gate when no indexing plan was ever applied."""
        from ..common.rendezvous import sort_by_rendezvous_hash
        indexers = self.cluster.nodes_with_role("indexer")
        if not indexers:
            return False
        return sort_by_rendezvous_hash(index_uid, indexers)[0] \
            == self.config.node_id

    def indexing_tasks(self) -> list[dict]:
        """What this node believes it is running (drift-check input)."""
        return list(self._applied_indexing_tasks or [])

    def indexing_tasks_report(self) -> dict[str, Any]:
        """Drift-check wire report. `applied` distinguishes an EMPTY plan
        slice from NO plan ever applied: a never-applied node still gates
        sources by the legacy election, so the leader must push even an
        empty slice to converge it onto the plan."""
        return {"applied": self._applied_indexing_tasks is not None,
                "tasks": self.indexing_tasks()}

    def source_assignment_allows(self, index_uid: str,
                                 source_id: str) -> "Optional[bool]":
        """True/False per the applied plan; None when no plan was ever
        applied OR no control-plane node is alive (caller falls back to
        the rendezvous election, so decommissioning every control-plane
        node cannot strand newly added sources behind a stale plan)."""
        if self._applied_indexing_tasks is None:
            return None
        if not self.cluster.nodes_with_role("control_plane"):
            return None
        return (index_uid, source_id) in self._assigned_sources

    def run_control_plane_pass(self) -> dict[str, Any]:
        """One scheduler convergence pass: plan, drift-check against what
        indexers report running, re-apply on drift (the reference's
        periodic re-check, §3.4). Runs on the elected control-plane node
        (lowest alive node id with the role); others no-op."""
        controllers = self.cluster.nodes_with_role("control_plane")
        if controllers and min(controllers) != self.config.node_id:
            return {"role": "follower"}
        # One membership read for both the plan and the poll/apply loops:
        # a node joining between two reads would otherwise receive an
        # empty slice (gating all its sources off for a full tick) or
        # have its planned tasks run nowhere this pass.
        indexers = self.cluster.nodes_with_role("indexer")
        plan = self.schedule_indexing(indexers)
        # Poll indexers concurrently: a few blackholed-but-member nodes
        # must not stretch one pass by N x the client timeout.
        running: dict[str, dict] = {
            n: {"applied": False, "tasks": []} for n in indexers}

        def poll_one(node_id: str) -> None:
            client = self.clients.get(node_id)
            if client is None:
                return
            try:
                report = client._post("/internal/indexing_tasks", {})
                if report:
                    running[node_id] = report
            except Exception:  # noqa: BLE001 - dead node: drift
                pass

        workers = []
        for node_id in indexers:
            if node_id == self.config.node_id:
                running[node_id] = self.indexing_tasks_report()
            else:
                # qwlint: disable-next-line=QW003 - control-plane poll of
                # peer nodes; admin path with its own 10s join budget
                # qwlint: disable-next-line=QW008 - serve-layer transport
                # infrastructure (sockets, real IO) outside the DST-raced path;
                # gating it would block the token on real IO
                worker = threading.Thread(target=poll_one, args=(node_id,),
                                          daemon=True)
                worker.start()
                workers.append(worker)
        deadline = time.monotonic() + 10.0
        for worker in workers:
            worker.join(timeout=max(0.0, deadline - time.monotonic()))

        def task_key(t: dict) -> tuple:
            return (t["index_uid"], t["source_id"], t.get("shard_id"))

        want = {node_id: [{"index_uid": t.index_uid,
                           "source_id": t.source_id,
                           "shard_id": t.shard_id}
                          for t in plan.assignments.get(node_id, [])]
                for node_id in indexers}
        # Re-apply ONLY to nodes whose reported state differs from the
        # plan: one unreachable indexer (permanent drift) must not spam
        # already-converged nodes with apply POSTs every tick. A node
        # that never applied ANY plan is always drifted — even with an
        # empty slice — because until a plan lands it consumes sources
        # via the legacy election, racing the planned consumer.
        changed = [node_id for node_id in indexers
                   if not running[node_id].get("applied")
                   or {task_key(t) for t in want[node_id]}
                   != {task_key(t) for t in running[node_id].get("tasks", [])}]
        applied = 0
        for node_id in changed:
            if node_id == self.config.node_id:
                self.apply_indexing_plan(want[node_id])
                applied += 1
                continue
            client = self.clients.get(node_id)
            if client is None:
                continue
            try:
                client._post("/internal/apply_indexing_plan",
                             {"tasks": want[node_id]})
                applied += 1
            except Exception as exc:  # noqa: BLE001 - next tick
                logger.warning("apply plan to %s failed: %s",
                               node_id, exc)
        return {"role": "leader", "drift": bool(changed),
                "nodes_applied": applied,
                "planned_tasks": sum(len(t) for t in want.values())}

    def schedule_indexing(
            self, indexers: Optional[list[str]] = None) -> "Any":
        """Control-plane convergence pass: logical tasks from metastore
        sources/shards → physical plan over live indexer nodes (§3.4)."""
        from ..control_plane.scheduler import IndexingTask
        tasks = []
        for metadata in self.metastore.list_indexes():
            for source_id, source in metadata.sources.items():
                if not source.enabled or source.source_type == "void":
                    continue
                shards = [s for s in self.ingester.list_shards(metadata.index_uid)
                          if s.source_id == source_id]
                if shards:
                    tasks.extend(IndexingTask(metadata.index_uid, source_id,
                                              shard_id=s.shard_id)
                                 for s in shards)
                else:
                    tasks.append(IndexingTask(metadata.index_uid, source_id))
        if indexers is None:
            indexers = self.cluster.nodes_with_role("indexer")
        return self.indexing_scheduler.schedule(tasks, indexers)

    def autoscale_shards(self) -> list[tuple[str, str, str]]:
        """One shard-scaling convergence pass (role of the reference's
        IngestController scale decisions, `ingest_controller.rs:424`):
        sample per-shard ingestion rates, consult the arbiter per source,
        and open/close local leader shards under permit rate limits.
        Returns the actions taken as (kind, index_uid, shard_id)."""
        from ..control_plane.arbiter import (ScaleUp,
                                             find_scale_down_candidate)
        from ..ingest.ingester import ShardState, shard_queue_id
        groups: dict[tuple[str, str], list[str]] = {}
        live_queue_ids: list[str] = []
        for s in self.ingester.list_shards():
            if s.state is ShardState.OPEN and s.role == "leader":
                groups.setdefault((s.index_uid, s.source_id),
                                  []).append(s.shard_id)
                queue_id = shard_queue_id(s.index_uid, s.source_id,
                                          s.shard_id)
                live_queue_ids.append(queue_id)
                self.shard_rate_tracker.observe(queue_id, s.bytes_written)
        # shards closed/deleted by ANY path leave the tracker (bounded)
        self.shard_rate_tracker.retain(live_queue_ids)
        actions: list[tuple[str, str, str]] = []
        for (index_uid, source_id), shard_ids in sorted(groups.items()):
            stats = self.shard_rate_tracker.source_stats(
                [shard_queue_id(index_uid, source_id, sid)
                 for sid in shard_ids])
            decision = self.scaling_arbiter.should_scale(stats)
            if decision is None:
                continue
            key = f"{index_uid}/{source_id}"
            granted = self.scaling_permits.acquire(key, decision)
            if granted == 0:
                continue
            try:
                if isinstance(decision, ScaleUp):
                    # a large scale-up may be granted partially (burst
                    # cap); the rest re-requests on later ticks as
                    # permits refill
                    ords = [int(sid.rsplit("-", 1)[-1]) for sid in shard_ids
                            if sid.rsplit("-", 1)[-1].isdigit()]
                    base = max(ords, default=-1)
                    for k in range(granted):
                        sid = (f"{self.config.node_id}-shard-"
                               f"{base + 1 + k:02d}")
                        self.ingester.open_shard(index_uid, source_id, sid)
                        actions.append(("open", index_uid, sid))
                else:
                    candidate = find_scale_down_candidate(
                        {sid: self.config.node_id for sid in shard_ids})
                    if candidate is None:
                        self.scaling_permits.release(key, decision,
                                                     granted=granted)
                        continue
                    _, sid = candidate
                    self.ingester.close_shard(index_uid, source_id, sid)
                    self.shard_rate_tracker.forget(
                        shard_queue_id(index_uid, source_id, sid))
                    actions.append(("close", index_uid, sid))
            except Exception:  # noqa: BLE001
                # a failed open/close must not eat the rate budget for
                # the retry on the next convergence tick
                self.scaling_permits.release(key, decision, granted=granted)
                raise
            self.ingest_router.refresh(index_uid, source_id)
        return actions

    # ------------------------------------------------------------------
    def advertised_roles(self) -> tuple[str, ...]:
        """Roles this node advertises to peers. A DRAINED compactor
        withdraws the role so indexers resume merging and other
        compactors take over its rendezvous ownership; a DRAINING one
        keeps advertising (its in-flight merges still claim splits only
        it knows about — letting indexers race in would duplicate
        merges), it just plans no new work."""
        from ..compaction import CompactorState
        roles = self.config.roles
        if (self.compactor is not None
                and self.compactor.state is CompactorState.DRAINED):
            roles = tuple(r for r in roles if r != "compactor")
        return roles

    def run_compaction_pass(self, synchronous: bool = False) -> int:
        """One compactor tick (reference compaction_planner tick +
        supervisor dispatch): plan merges for the indexes this compactor
        owns (rendezvous over alive compactor nodes) and submit them up
        to the supervisor's free slots. Returns tasks submitted."""
        from ..common.rendezvous import sort_by_rendezvous_hash
        if self.compactor is None or self.compaction_planner is None:
            return 0
        compactors = self.cluster.nodes_with_role("compactor") \
            or [self.config.node_id]
        indexes = self.metastore.list_indexes()
        owned = [m for m in indexes
                 if sort_by_rendezvous_hash(m.index_uid, compactors)[0]
                 == self.config.node_id]
        if not owned:
            return 0
        slots = self.compactor.available_slots()
        if slots == 0:
            return 0
        planner = self.compaction_planner

        def on_done(task, ok):
            (planner.complete_task if ok else planner.fail_task)(
                task.task_id)

        submitted = 0
        for task in planner.plan(max_tasks=slots, indexes=owned):
            if self.compactor.submit(task, on_done=on_done,
                                     synchronous=synchronous):
                submitted += 1
            else:
                planner.fail_task(task.task_id)  # slot raced away
        return submitted

    def run_merges(self, index_id: str) -> int:
        """One merge-planner pass (role of MergePlanner + MergePipeline)."""
        metadata = self.metastore.index_metadata(index_id)
        policy = merge_policy_from_config(metadata.index_config.merge_policy)
        splits = self.metastore.list_splits(ListSplitsQuery(
            index_uids=[metadata.index_uid], states=[SplitState.PUBLISHED]))
        operations = policy.operations(splits)
        if not operations:
            return 0
        storage = self.storage_resolver.resolve(metadata.index_config.index_uri)
        executor = MergeExecutor(metadata.index_uid,
                                 metadata.index_config.doc_mapper,
                                 self.metastore, storage, self.config.node_id)
        delete_tasks = self.metastore.list_delete_tasks(metadata.index_uid)
        for operation in operations:
            executor.execute(operation, delete_tasks=delete_tasks or None)
        return len(operations)

    # ------------------------------------------------------------------
    def start_scroll(self, request, ttl_secs: float) -> dict[str, Any]:
        """First page + scroll id (reference scroll flow, scroll.md)."""
        from dataclasses import replace
        from ..search.scroll import CACHE_WINDOW, ScrollContext
        page_size = request.max_hits
        window_request = replace(request,
                                 max_hits=max(CACHE_WINDOW, page_size),
                                 start_offset=0)
        response = self.root_searcher.search(window_request)
        context = ScrollContext(
            request=request, cached_hits=response.hits,
            cursor=min(page_size, len(response.hits)),
            total_hits=response.num_hits, ttl_secs=ttl_secs)
        scroll_id = self.scroll_store.put(context)
        self._replicate_scroll(scroll_id, context)
        page = response.to_dict()
        page["hits"] = page["hits"][:page_size]
        if "snippets" in page:  # parallel array: keep aligned with hits
            page["snippets"] = page["snippets"][:page_size]
        page["scroll_id"] = scroll_id
        page["index"] = request.index_ids[0] if request.index_ids else ""
        return page

    def end_scroll(self, scroll_id: str) -> bool:
        """Release a scroll context early (clear-scroll)."""
        return self.scroll_store.delete(scroll_id)

    def _scroll_affinity_peers(self, scroll_id: str) -> list:
        """ALL other searcher members in rendezvous order (rendezvous
        weights are per-node, so every node computes the same relative
        order regardless of which node is excluded): replication targets
        the first, recovery walks the whole list — a 3-node cluster where
        the serving node restarts still finds the replica wherever the
        next page lands."""
        from ..common.rendezvous import sort_by_rendezvous_hash
        peers = {m.node_id: m for m in self.cluster.members()
                 if m.node_id != self.config.node_id
                 and "searcher" in m.roles and m.rest_endpoint}
        if not peers:
            return []
        ordered = sort_by_rendezvous_hash(scroll_id, list(peers))
        return [peers[n] for n in ordered]

    def _replicate_scroll(self, scroll_id: str, context) -> None:
        """Best-effort put_kv to the best-affinity peer (reference:
        scroll_context.rs:146): a node restart then no longer kills live
        scrolls — the next page is served from the replica."""
        from ..search.scroll import context_to_dict
        for member in self._scroll_affinity_peers(scroll_id)[:1]:
            client = self.clients.get(member.node_id)
            if client is None:
                continue
            try:
                client._post("/internal/kv", {
                    "key": scroll_id, "kind": "scroll",
                    "value": context_to_dict(context)})
            except Exception:  # noqa: BLE001 - best-effort replication
                logger.debug("scroll replication to %s failed",
                             member.node_id)

    def _replicate_scroll_cursor(self, scroll_id: str, cursor: int) -> None:
        """Per-page cursor sync: a few bytes instead of re-shipping the
        whole cached window on every page."""
        for member in self._scroll_affinity_peers(scroll_id)[:1]:
            client = self.clients.get(member.node_id)
            if client is None:
                continue
            try:
                client._post("/internal/kv", {
                    "key": scroll_id, "kind": "scroll_cursor",
                    "value": cursor})
            except Exception:  # noqa: BLE001
                pass

    def _fetch_scroll(self, scroll_id: str):
        """Local miss (e.g. this node restarted, or the client hit a
        different node): recover the context from the affinity replica."""
        from ..search.scroll import context_from_dict
        for member in self._scroll_affinity_peers(scroll_id):
            client = self.clients.get(member.node_id)
            if client is None:
                continue
            try:
                payload = client._post("/internal/kv_get",
                                       {"key": scroll_id})
            except Exception:  # noqa: BLE001
                continue
            if payload and payload.get("value"):
                context = context_from_dict(payload["value"])
                self.scroll_store.put_with_id(scroll_id, context)
                return context
        return None

    def continue_scroll(self, scroll_id: str) -> dict[str, Any]:
        from dataclasses import replace
        context = self.scroll_store.get(scroll_id)
        if context is None:
            context = self._fetch_scroll(scroll_id)
        if context is None:
            raise ValueError("scroll id not found or expired")
        page_size = context.request.max_hits
        hits = context.cached_hits
        if context.cursor >= len(hits) and len(hits) < context.total_hits and hits:
            # refill the window via search_after from the last cached hit
            from ..search.scroll import CACHE_WINDOW
            # string search_after markers make text-sort refills work the
            # same as numeric ones (the raw term string IS the marker)
            last = hits[-1]
            sort_value = last.sort_values[0] if last.sort_values else last.score
            if len(context.request.sort_fields) > 1 and len(last.sort_values) > 1:
                marker = [sort_value, last.sort_values[1],
                          last.split_id, last.doc_id]
            else:
                marker = [sort_value, last.split_id, last.doc_id]
            refill_request = replace(
                context.request, start_offset=0, max_hits=CACHE_WINDOW,
                search_after=marker)
            response = self.root_searcher.search(refill_request)
            hits.extend(response.hits)
            self._replicate_scroll(scroll_id, context)  # window changed
        page_hits = hits[context.cursor: context.cursor + page_size]
        context.cursor += len(page_hits)
        self._replicate_scroll_cursor(scroll_id, context.cursor)
        return {
            "num_hits": context.total_hits,
            "hits": [h.doc for h in page_hits],
            "scroll_id": scroll_id,
            "index": (context.request.index_ids[0]
                      if context.request.index_ids else ""),
            "elapsed_time_micros": 0,
            "errors": [],
        }

    # ------------------------------------------------------------------
    # background service loops (role of the reference's long-running actors:
    # ingest pipelines, MergePlanner, janitor actors, chitchat heartbeats).
    # Supervision-lite: each loop catches and logs failures and keeps going.
    def start_background_services(self,
                                  ingest_interval_secs: float = 2.0,
                                  merge_interval_secs: float = 30.0,
                                  janitor_interval_secs: float = 300.0,
                                  heartbeat_interval_secs: float = 2.0) -> None:
        if getattr(self, "_bg_stop", None) is not None:
            return
        self._ensure_span_exporter()
        if self.grpc_server is None and self.config.grpc_port is not None:
            # stop/start cycles recreate the listener (stop tears it down)
            from .grpc_server import GrpcServer
            self.grpc_server = GrpcServer(
                self, host=self.config.rest_host,
                port=self.config.grpc_port,
                ssl_context=self.config.server_ssl_context(alpn=["h2"]))
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        stop = self._bg_stop = threading.Event()
        owns_index = self.owns_index

        def ingest_tick() -> None:
            # Drains the LOCAL WAL — no ownership gate: only this node can
            # drain its own shards (node-prefixed ids keep checkpoint
            # partitions collision-free across nodes; a raced metastore
            # publish fails the version check and retries next tick).
            if "indexer" not in self.config.roles:
                return
            # failover: adopt replica shards whose leader died before
            # draining (checkpoints continue at the same positions), and
            # step down from shards the registry says another node now
            # leads (stale role recovered from a pre-crash WAL)
            self.reconcile_stale_leaders()
            self.promote_orphaned_replicas()
            live_uids = set()
            for metadata in self.metastore.list_indexes():
                live_uids.add(metadata.index_uid)
                shards = self.ingester.list_shards(metadata.index_uid)
                if any(s.log.next_position > s.publish_position for s in shards):
                    if self.config.cooperative_indexing:
                        self._cooperative_drain(metadata)
                    else:
                        self.run_ingest_pass(metadata.index_id)
                # configured external sources (file/kafka): owner-gated so
                # one node consumes each index's partitions (the reference
                # control plane assigns (source,partition)→indexer; our
                # rendezvous election is the same single-consumer rule)
                for source_id, source_config in metadata.sources.items():
                    # cheap filters FIRST: internal/disabled sources must
                    # not pay cluster-lock + rendezvous-hash per tick
                    if (not source_config.enabled
                            or source_config.source_type
                            in self._INTERNAL_SOURCE_TYPES):
                        continue
                    allowed = self.source_assignment_allows(
                        metadata.index_uid, source_id)
                    if allowed is None:  # no plan applied: legacy election
                        allowed = owns_index(metadata.index_uid)
                    if allowed:
                        try:
                            self.run_source_pass(metadata.index_id,
                                                 source_id)
                        except Exception as exc:  # noqa: BLE001
                            logger.warning(
                                "source %s/%s pass failed: %s",
                                metadata.index_id, source_id, exc)
            # deleted indexes release their cooperative state (index
            # churn must not grow these dicts forever)
            for state in (self._coop_cycles, self._coop_next_wake,
                          self.pipeline_metrics):
                for uid in list(state):
                    if uid not in live_uids:
                        del state[uid]
            for key in list(self._external_sources):
                if key[0] not in live_uids:
                    self._close_source(self._external_sources.pop(key)[1])

        def merge_tick() -> None:
            # compactor nodes own merging when present; indexers merge
            # only in clusters WITHOUT compactors (reference: the
            # standalone compactor role takes merge work off indexers).
            # DRAINING still holds the merge baton (its in-flight tasks
            # claim splits); only DRAINED hands merging back to indexers
            # — locally at once, remotely via withdrawn heartbeat roles.
            from ..compaction import CompactorState
            if self.compactor is not None:
                if self.compactor.state is CompactorState.RUNNING:
                    self.run_compaction_pass()
                if self.compactor.state is not CompactorState.DRAINED:
                    return
            if "indexer" not in self.config.roles:
                return
            others = [n for n in self.cluster.nodes_with_role("compactor")
                      if n != self.config.node_id]
            if others:
                return
            for metadata in self.metastore.list_indexes():
                if owns_index(metadata.index_uid):
                    self.run_merges(metadata.index_id)

        def janitor_tick() -> None:
            if "janitor" in self.config.roles:
                self.run_janitor()

        heartbeat_clients: dict[str, object] = {}

        def heartbeat_one(endpoint: str, payload: dict) -> None:
            # Runs in a bare worker thread (outside loop()'s supervision):
            # must never let an exception escape, or a malformed peer
            # response kills the worker with a traceback every tick.
            try:
                from ..common.tower import CircuitOpen
                from ..cluster.membership import substitute_wildcard_host
                from .http_client import HttpSearchClient, HttpTransportError
                client = heartbeat_clients.get(endpoint)
                if client is None:
                    client = heartbeat_clients[endpoint] = HttpSearchClient(
                        endpoint, timeout_secs=2.0,
                        **self.config.client_tls_kwargs())
                try:
                    info = client.heartbeat(payload)
                except (HttpTransportError, CircuitOpen) as exc:
                    # CircuitOpen: the cached client's breaker backs off from
                    # a dead peer; half-open probes re-admit it on recovery.
                    logger.debug("heartbeat to %s failed: %s", endpoint, exc)
                    return
                self.cluster.upsert_heartbeat(ClusterMember(
                    node_id=info["node_id"], roles=tuple(info["roles"]),
                    rest_endpoint=substitute_wildcard_host(
                        info.get("rest_endpoint", endpoint),
                        endpoint.rpartition(":")[0]),
                    grpc_endpoint=substitute_wildcard_host(
                        info.get("grpc_endpoint", ""),
                        endpoint.rpartition(":")[0])))
            except Exception:  # noqa: BLE001 - supervised worker
                logger.exception("heartbeat to %s: bad peer response", endpoint)

        def heartbeat_tick() -> None:
            payload = {"node_id": self.config.node_id,
                       "roles": list(self.advertised_roles()),
                       "rest_endpoint":
                           f"{self.config.rest_host}:{self.config.rest_port}",
                       "grpc_endpoint": self._grpc_advertise()}
            peers = set(self.config.peers)
            peers.update(m.rest_endpoint for m in self.cluster.members()
                         if m.node_id != self.config.node_id and m.rest_endpoint)
            # Fan out concurrently: N slow/unreachable peers must not stretch
            # the heartbeat period past the liveness window for healthy ones.
            # qwlint: disable-next-line=QW003 - liveness heartbeats to
            # peers; cluster plumbing, not query work
            # qwlint: disable-next-line=QW008 - serve-layer transport
            # infrastructure (sockets, real IO) outside the DST-raced path;
            # gating it would block the token on real IO
            workers = [threading.Thread(target=heartbeat_one,
                                        args=(endpoint, payload), daemon=True)
                       for endpoint in peers]
            for worker in workers:
                worker.start()
            for worker in workers:
                worker.join(timeout=4.0)

        def autoscale_tick() -> None:
            if "indexer" in self.config.roles:
                self.autoscale_shards()

        def control_plane_tick() -> None:
            # scheduler convergence (§3.4): plan, drift-check, re-apply.
            # Leader election happens inside the pass (lowest alive
            # control-plane node); followers no-op.
            if "control_plane" not in self.config.roles:
                return
            try:
                self.run_control_plane_pass()
            except Exception as exc:  # noqa: BLE001 - next tick retries
                logger.warning("control-plane pass failed: %s", exc)

        loops = [("ingest", ingest_interval_secs, ingest_tick),
                 ("merge", merge_interval_secs, merge_tick),
                 ("janitor", janitor_interval_secs, janitor_tick),
                 ("autoscale", max(ingest_interval_secs, 2.0),
                  autoscale_tick),
                 ("control-plane", max(merge_interval_secs, 10.0),
                  control_plane_tick)]
        if self.config.gossip_enabled:
            # UDP scuttlebutt replaces the REST heartbeat loop entirely
            from ..cluster.gossip import GossipService
            self._gossip = GossipService(
                self.cluster, self.config.node_id, self.config.roles,
                rest_endpoint=f"{self.config.rest_host}:"
                              f"{self.config.rest_port}",
                bind_host=self.config.rest_host,
                bind_port=self.config.rest_port,
                seeds=self.config.peers,
                interval_secs=min(heartbeat_interval_secs, 1.0),
                cluster_id=self.config.cluster_id,
                grpc_endpoint=self._grpc_advertise())
            self._gossip.start()
        else:
            loops.append(("heartbeat", heartbeat_interval_secs,
                          heartbeat_tick))
        # each background service is an actor on the shared Universe
        # (reference: the quickwit-actors supervision trees hosting
        # IndexingService / janitor / pipelines): one mailbox each,
        # periodic Tick messages from the scheduler, supervised restarts,
        # and tick coalescing (try_send) so a slow pass skips beats
        # instead of queueing them up
        from ..common.actors import Actor, Universe
        universe = self._bg_universe = Universe()

        class _Service(Actor):
            def __init__(self, name: str, tick):
                self.name = f"bg-{name}"
                self._tick = tick

            def on_message(self, message) -> None:
                if stop.is_set():
                    return
                self._tick()

        for name, interval, tick in loops:
            mailbox, _handle = universe.spawn(
                _Service(name, tick), capacity=1, supervised=True,
                max_restarts=1 << 30)  # services restart forever
            universe.schedule_periodic(
                interval, lambda m=mailbox: m.try_send("tick"))
        logger.info("background services started (%s)", self.config.node_id)

    def stop_background_services(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.stop()
            self.grpc_server = None
        if self.span_exporter is not None:
            from ..observability.tracing import TRACER
            TRACER.remove_processor(self.span_exporter)
            self.span_exporter.stop()
            self.span_exporter = None
        stop = getattr(self, "_bg_stop", None)
        if stop is not None:
            stop.set()
            self._bg_stop = None
        universe = getattr(self, "_bg_universe", None)
        if universe is not None:
            universe.quit(timeout=2.0)
            self._bg_universe = None
        gossip = getattr(self, "_gossip", None)
        if gossip is not None:
            gossip.stop()
            self._gossip = None
        if self.split_cache is not None:
            self.split_cache.stop()

    # ------------------------------------------------------------------
    def warmup_index(self, index_id: str,
                     requests: Optional[list] = None) -> dict[str, Any]:
        """Pre-warm the searcher for an index: run the given
        SearchRequests once, discarding results, so reader opens, storage
        byte-range fetches, host→device transfers, AND the
        per-plan-structure jit compilations happen before user traffic
        (the round-4 weak-point: first-query warmup costs seconds per
        plan structure). The REST route builds the requests through the
        SAME parser production queries use, so warmed plan structures
        match real traffic; `requests=None` warms a default match-all
        top-k + a date-histogram shape."""
        from ..query.ast import MatchAll
        from ..search.models import SearchRequest
        if not requests:
            metadata = self._metadata_or_template(index_id)
            doc_mapper = metadata.index_config.doc_mapper
            requests = [SearchRequest(index_ids=[index_id],
                                      query_ast=MatchAll(), max_hits=10)]
            if doc_mapper.timestamp_field:
                requests.append(SearchRequest(
                    index_ids=[index_id], query_ast=MatchAll(), max_hits=0,
                    aggs={"_warm_hist": {"date_histogram": {
                        "field": doc_mapper.timestamp_field,
                        "fixed_interval": "1d"}}}))
        timings = []
        for request in requests:
            t0 = time.monotonic()
            try:
                self.root_searcher.search(request)
                status = "ok"
            except Exception as exc:  # noqa: BLE001 - report, keep warming
                status = f"error: {exc}"
            timings.append({"status": status,
                            "elapsed_ms": round(
                                (time.monotonic() - t0) * 1000, 1)})
        return {"warmed": timings}

    # ------------------------------------------------------------------
    def run_janitor(self) -> dict[str, int]:
        """GC + retention + delete-task planning pass (role of
        quickwit-janitor's actors)."""
        from ..janitor.delete_planner import run_delete_planner
        from ..janitor.gc import run_garbage_collection
        from ..janitor.retention import apply_retention
        gc_stats = run_garbage_collection(self.metastore, self.storage_resolver)
        retention_stats = apply_retention(self.metastore)
        delete_stats = run_delete_planner(self.metastore,
                                          self.storage_resolver,
                                          node_id=self.config.node_id,
                                          device=self.config.device)
        return {**gc_stats, **retention_stats, **delete_stats}
