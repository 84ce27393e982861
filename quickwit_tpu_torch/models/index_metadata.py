"""Index metadata: config + sources + checkpoints.

Role of the reference's `quickwit-metastore/src/metastore/index_metadata.rs`:
the per-index record held by the metastore — the index config (doc mapping,
settings, retention), registered sources, and per-source checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..common.clock import wall_time
from .doc_mapper import DocMapper


@dataclass
class RetentionPolicy:
    period_seconds: int
    schedule: str = "hourly"

    def to_dict(self) -> dict[str, Any]:
        return {"period_seconds": self.period_seconds, "schedule": self.schedule}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "RetentionPolicy":
        return RetentionPolicy(d["period_seconds"], d.get("schedule", "hourly"))


@dataclass
class IndexConfig:
    """Reference: `quickwit-config/src/index_config/mod.rs`."""
    index_id: str
    index_uri: str
    doc_mapper: DocMapper
    commit_timeout_secs: int = 60
    split_num_docs_target: int = 10_000_000
    merge_policy: dict[str, Any] = field(default_factory=lambda: {"type": "stable_log"})
    retention: Optional[RetentionPolicy] = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "index_id": self.index_id,
            "index_uri": self.index_uri,
            "doc_mapping": self.doc_mapper.to_dict(),
            "commit_timeout_secs": self.commit_timeout_secs,
            "split_num_docs_target": self.split_num_docs_target,
            "merge_policy": self.merge_policy,
            "retention": self.retention.to_dict() if self.retention else None,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "IndexConfig":
        return IndexConfig(
            index_id=d["index_id"],
            index_uri=d["index_uri"],
            doc_mapper=DocMapper.from_dict(d["doc_mapping"]),
            commit_timeout_secs=d.get("commit_timeout_secs", 60),
            split_num_docs_target=d.get("split_num_docs_target", 10_000_000),
            merge_policy=d.get("merge_policy", {"type": "stable_log"}),
            retention=RetentionPolicy.from_dict(d["retention"]) if d.get("retention") else None,
        )


@dataclass
class SourceConfig:
    """Reference: `quickwit-config/src/source_config/mod.rs`."""
    source_id: str
    source_type: str  # "file" | "vec" | "void" | "ingest" | "kafka-stub" | ...
    params: dict[str, Any] = field(default_factory=dict)
    enabled: bool = True
    num_pipelines: int = 1

    def to_dict(self) -> dict[str, Any]:
        return {
            "source_id": self.source_id, "source_type": self.source_type,
            "params": self.params, "enabled": self.enabled,
            "num_pipelines": self.num_pipelines,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SourceConfig":
        return SourceConfig(
            source_id=d["source_id"], source_type=d["source_type"],
            params=d.get("params", {}), enabled=d.get("enabled", True),
            num_pipelines=d.get("num_pipelines", 1),
        )


@dataclass
class IndexMetadata:
    index_uid: str  # "{index_id}:{incarnation}"
    index_config: IndexConfig
    sources: dict[str, SourceConfig] = field(default_factory=dict)
    # source_id -> partition_id -> position (exactly-once checkpoints,
    # reference: quickwit-metastore/src/checkpoint.rs)
    checkpoints: dict[str, dict[str, str]] = field(default_factory=dict)
    create_timestamp: int = field(default_factory=lambda: int(wall_time()))

    @property
    def index_id(self) -> str:
        return self.index_uid.split(":", 1)[0]

    def to_dict(self) -> dict[str, Any]:
        return {
            "index_uid": self.index_uid,
            "index_config": self.index_config.to_dict(),
            "sources": {sid: s.to_dict() for sid, s in self.sources.items()},
            "checkpoints": self.checkpoints,
            "create_timestamp": self.create_timestamp,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "IndexMetadata":
        return IndexMetadata(
            index_uid=d["index_uid"],
            index_config=IndexConfig.from_dict(d["index_config"]),
            sources={sid: SourceConfig.from_dict(s) for sid, s in d.get("sources", {}).items()},
            checkpoints=d.get("checkpoints", {}),
            create_timestamp=d.get("create_timestamp", 0),
        )
