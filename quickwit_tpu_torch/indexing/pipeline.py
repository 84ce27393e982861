"""Indexing pipeline: source → typed docs → split files → atomic publish.

Role of the reference's actor chain (`quickwit-indexing/src/actors/`:
DocProcessor → Indexer → IndexSerializer → Packager → Uploader → Sequencer →
Publisher, SURVEY.md §3.3), collapsed into a synchronous pipeline object —
the stage boundaries and failure semantics are preserved (stage splits
before upload; upload before publish; publish carries the checkpoint delta
so crash-replays dedupe), while threading/supervision live one level up in
the IndexingService.

A split is cut when `split_num_docs_target` is reached or the source batch
is force-committed (commit_timeout's role for bounded sources).

Carried over whole from the JAX package's `indexing/pipeline.py`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..common.clock import wall_time
from ..index.writer import SplitWriter
from ..metastore.base import Metastore
from ..metastore.checkpoint import CheckpointDelta, SourceCheckpoint
from ..models.doc_mapper import DocMapper, DocParsingError
from ..models.split_metadata import SplitMetadata, new_split_id
from ..storage.base import Storage
from .sources import Source, SourceBatch
from .transform import TransformRuntimeError

logger = logging.getLogger(__name__)


def split_file_path(split_id: str) -> str:
    return f"{split_id}.split"


@dataclass
class PipelineParams:
    index_uid: str
    source_id: str
    node_id: str = "node-0"
    split_num_docs_target: int = 10_000_000
    batch_num_docs: int = 10_000
    doc_mapping_uid: str = "default"


@dataclass
class PipelineCounters:
    """Observable pipeline state (role of the actors' observable states)."""
    num_docs_processed: int = 0
    num_docs_invalid: int = 0
    num_splits_published: int = 0
    num_published_docs: int = 0
    num_published_bytes: int = 0  # uncompressed (cooperative metrics)


class IndexingPipeline:
    """One (index, source) pipeline (reference `indexing_pipeline.rs:80`)."""

    def __init__(self, params: PipelineParams, doc_mapper: DocMapper,
                 source: Source, metastore: Metastore, split_storage: Storage,
                 transform=None, fault_injector=None):
        self.params = params
        self.doc_mapper = doc_mapper
        self.source = source
        self.metastore = metastore
        self.split_storage = split_storage
        self.transform = transform  # compiled Transform (VRL analogue) or None
        # chaos hook (common/faults.FaultInjector): perturbs the commit's
        # stage/upload/publish boundaries ("indexing.stage",
        # "indexing.upload", "indexing.publish") so the crash-between-stages
        # claims above are test-driven, not asserted
        self.fault_injector = fault_injector
        self.counters = PipelineCounters()
        # one writer per partition id (reference `indexer.rs:146-160`);
        # partition 0 is the unpartitioned default
        self._writers: dict[int, SplitWriter] = {}
        self._pending_delta = CheckpointDelta()

    # ------------------------------------------------------------------
    def run_to_completion(self) -> PipelineCounters:
        """Drain a bounded source fully, publishing splits along the way."""
        checkpoint = self._current_checkpoint()
        # splits cut at batch boundaries, so batches must not exceed the
        # split target (checkpoint deltas stay aligned with published splits)
        batch_num_docs = min(self.params.batch_num_docs,
                             self.params.split_num_docs_target)
        for batch in self.source.batches(checkpoint, batch_num_docs):
            self.process_batch(batch)
        self.commit(force=True)
        return self.counters

    def _current_checkpoint(self) -> SourceCheckpoint:
        return self.metastore.source_checkpoint(  # type: ignore[attr-defined]
            self.params.index_uid, self.params.source_id)

    # ------------------------------------------------------------------
    # overflow partition once max_num_partitions writers exist
    # (reference `indexer.rs:61,157-160` maps excess docs to OTHER)
    OTHER_PARTITION = 2**64 - 1

    def _writer_for(self, partition: int) -> SplitWriter:
        writer = self._writers.get(partition)
        if writer is None:
            if (partition != self.OTHER_PARTITION
                    and len(self._writers)
                    >= self.doc_mapper.max_num_partitions):
                return self._writer_for(self.OTHER_PARTITION)
            writer = self._writers[partition] = SplitWriter(self.doc_mapper)
        return writer

    def process_batch(self, batch: SourceBatch) -> None:
        """DocProcessor + Indexer stages."""
        for doc in batch.docs:
            try:
                if self.transform is not None:
                    doc = self.transform.apply(doc, copy=False)
                    if doc is None:  # drop()ped by the script (filtering)
                        continue
                # parse BEFORE fetching the writer: an invalid doc must
                # not register a phantom partition writer (the partition
                # budget would fill with empties, mis-routing later docs)
                tdoc = self.doc_mapper.doc_from_json(doc)
                partition = self.doc_mapper.partition_id(doc)
                self._writer_for(partition).add_typed_doc(tdoc)
                self.counters.num_docs_processed += 1
            except (DocParsingError, TransformRuntimeError) as exc:
                self.counters.num_docs_invalid += 1
                logger.debug("dropping invalid doc: %s", exc)
        self._pending_delta.extend(batch.checkpoint_delta)
        total = sum(w.num_docs for w in self._writers.values())
        if (total >= self.params.split_num_docs_target
                or batch.force_commit):
            self.commit(force=True)

    def commit(self, force: bool = False) -> Optional[str]:
        """Packager + Uploader + Publisher stages: serialize one split per
        partition, stage them, upload them, publish them TOGETHER with the
        pending checkpoint delta (partitioned docs from one batch window
        must land atomically, like the reference's per-partition
        IndexedSplitBatch)."""
        writers = {p: w for p, w in self._writers.items() if w.num_docs > 0}
        if not writers:
            if not self._pending_delta.is_empty:
                # batches that produced no valid docs still advance the
                # checkpoint (otherwise they would replay forever)
                self.metastore.publish_splits(
                    self.params.index_uid, [],
                    source_id=self.params.source_id,
                    checkpoint_delta=self._pending_delta)
                self._pending_delta = CheckpointDelta()
            return None
        staged: list[tuple[SplitMetadata, bytes]] = []
        for partition in sorted(writers):
            writer = writers[partition]
            data = writer.finish()
            staged.append((SplitMetadata(
                split_id=new_split_id(),
                index_uid=self.params.index_uid,
                source_id=self.params.source_id,
                node_id=self.params.node_id,
                num_docs=writer.num_docs,
                uncompressed_docs_size_bytes=writer._uncompressed_docs_size,
                footprint_bytes=len(data),
                time_range_start=writer._time_min,
                time_range_end=writer._time_max,
                tags=frozenset(writer.tags),
                create_timestamp=int(wall_time()),
                doc_mapping_uid=self.params.doc_mapping_uid,
                partition_id=partition,
                column_bounds=dict(writer.column_bounds),
            ), data))
        # stage → upload → publish: a crash between stages leaves either a
        # staged-but-absent split (GC'd) or an uploaded-but-unpublished file
        # (GC'd); never a published split without its file. Each boundary
        # perturbs BEFORE its mutation so an error-kind fault models a crash
        # that left the previous stage durable and this one not started.
        if self.fault_injector is not None:
            self.fault_injector.perturb("indexing.stage")
        self.metastore.stage_splits(self.params.index_uid,
                                    [m for m, _ in staged])
        if self.fault_injector is not None:
            self.fault_injector.perturb("indexing.upload")
        for metadata, data in staged:
            self.split_storage.put(split_file_path(metadata.split_id), data)
        delta = self._pending_delta if not self._pending_delta.is_empty else None
        split_ids = [m.split_id for m, _ in staged]
        if self.fault_injector is not None:
            self.fault_injector.perturb("indexing.publish")
        self.metastore.publish_splits(
            self.params.index_uid, split_ids,
            source_id=self.params.source_id,
            checkpoint_delta=delta)
        for metadata, _ in staged:
            self.counters.num_splits_published += 1
            self.counters.num_published_docs += metadata.num_docs
            self.counters.num_published_bytes += \
                metadata.uncompressed_docs_size_bytes
            logger.info("published split %s (%d docs, partition %d)",
                        metadata.split_id, metadata.num_docs,
                        metadata.partition_id)
        self._writers = {}
        self._pending_delta = CheckpointDelta()
        return split_ids[0]
