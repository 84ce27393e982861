"""Merge policies + merge execution.

Role of the reference's merge side (`merge_planner.rs`, `merge_policy/
stable_log_merge_policy.rs`, `merge_executor.rs`): decide which published
splits to merge and replace N splits by one, through the same atomic
stage/upload/publish(replace) protocol so no document is ever lost or
duplicated (`no_split_loss`/`rows_conserved` invariants of quickwit-dst).

The executor merges at the ARRAY level (index/merge_arrays.py: term-dict
k-way merge, postings offset-concat, compressed docstore blocks reused) in
the common case; when delete tasks newer than the inputs' delete_opstamp
are pending, it falls back to a doc-level rewrite that applies them — like
the reference's delete-task pipeline applies deletes at merge time.

Carried over whole from the JAX package's `indexing/merge.py`.
"""

from __future__ import annotations

import logging
import zlib
from dataclasses import dataclass
from typing import Optional

from ..common.clock import wall_time
from ..index.reader import SplitReader
from ..index.writer import SplitWriter
from ..metastore.base import ListSplitsQuery, Metastore
from ..models.doc_mapper import DocMapper
from ..models.split_metadata import Split, SplitMetadata, SplitState, new_split_id
from ..storage.base import Storage
from .pipeline import split_file_path

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class MergeOperation:
    splits: tuple[Split, ...]

    @property
    def split_ids(self) -> list[str]:
        return [s.metadata.split_id for s in self.splits]


class MergePolicy:
    def operations(self, splits: list[Split]) -> list[MergeOperation]:
        raise NotImplementedError


class NopMergePolicy(MergePolicy):
    def operations(self, splits: list[Split]) -> list[MergeOperation]:
        return []


class StableLogMergePolicy(MergePolicy):
    """Size-tiered merging (reference `stable_log_merge_policy.rs`): splits
    bucket into levels by doc-count magnitude; a level reaching
    `merge_factor` members merges its oldest members into one split.
    Splits at or above `split_num_docs_target` are mature and never merge.
    """

    def __init__(self, merge_factor: int = 10, max_merge_factor: int = 12,
                 split_num_docs_target: int = 10_000_000,
                 min_level_num_docs: int = 100_000):
        self.merge_factor = merge_factor
        self.max_merge_factor = max_merge_factor
        self.split_num_docs_target = split_num_docs_target
        self.min_level_num_docs = min_level_num_docs

    def _level(self, num_docs: int) -> int:
        level = 0
        threshold = self.min_level_num_docs
        while num_docs >= threshold:
            level += 1
            threshold *= self.merge_factor
        return level

    def operations(self, splits: list[Split]) -> list[MergeOperation]:
        candidates = [
            s for s in splits
            if s.state is SplitState.PUBLISHED
            and s.metadata.num_docs < self.split_num_docs_target
        ]
        # partitioned splits only merge within their partition (reference
        # split_metadata.rs:75-78: merging across partition_id defeats
        # routing-based pruning), so the level buckets key on both
        by_level: dict[tuple[int, int], list[Split]] = {}
        for split in candidates:
            key = (split.metadata.partition_id,
                   self._level(split.metadata.num_docs))
            by_level.setdefault(key, []).append(split)
        operations = []
        for level_splits in by_level.values():
            level_splits.sort(key=lambda s: s.metadata.split_id)  # ULIDs: time order
            while len(level_splits) >= self.merge_factor:
                group = level_splits[: self.max_merge_factor]
                level_splits = level_splits[len(group):]
                operations.append(MergeOperation(tuple(group)))
        return operations


def merge_policy_from_config(config: dict) -> MergePolicy:
    kind = config.get("type", "stable_log")
    if kind == "stable_log":
        return StableLogMergePolicy(
            merge_factor=config.get("merge_factor", 10),
            max_merge_factor=config.get("max_merge_factor", 12),
            split_num_docs_target=config.get("split_num_docs_target", 10_000_000),
            min_level_num_docs=config.get("min_level_num_docs", 100_000),
        )
    if kind in ("no_merge", "nop", "none"):
        return NopMergePolicy()
    raise ValueError(f"unknown merge policy {kind!r}")


def _merge_column_bounds(splits) -> dict:
    """Zonemap union over merge inputs: min of mins / max of maxes. A
    field is kept only when EVERY input carries bounds for it — a split
    without the entry might be a pre-zonemap split that still holds
    values, so dropping the field is the only sound choice."""
    if not splits:
        return {}
    common = set(splits[0].metadata.column_bounds)
    for split in splits[1:]:
        common &= set(split.metadata.column_bounds)
    out = {}
    for name in common:
        bounds = [s.metadata.column_bounds[name] for s in splits]
        out[name] = (min(b[0] for b in bounds), max(b[1] for b in bounds))
    return out


def _iter_all_docs(reader: SplitReader):
    """Stream every stored document of a split in doc-id order."""
    import json
    block_first = reader.array("store.block_first_doc")
    block_offsets = reader.array("store.block_offsets")
    for block in range(len(block_first) - 1):
        raw = reader.array_slice(
            "store.data", int(block_offsets[block]),
            int(block_offsets[block + 1] - block_offsets[block]))
        for line in zlib.decompress(raw.tobytes()).split(b"\n"):
            if line:
                yield json.loads(line)


class MergeExecutor:
    """Reference `merge_executor.rs`: N published splits → 1, atomically."""

    def __init__(self, index_uid: str, doc_mapper: DocMapper,
                 metastore: Metastore, split_storage: Storage,
                 node_id: str = "node-0", fault_injector=None):
        self.index_uid = index_uid
        self.doc_mapper = doc_mapper
        self.metastore = metastore
        self.split_storage = split_storage
        self.node_id = node_id
        # chaos hook (common/faults.FaultInjector): "merge.execute" perturbs
        # the read/merge phase, "merge.publish" the atomic replace — a fault
        # at either point must leave every input split PUBLISHED and
        # searchable (no_split_loss), and a retry must conserve rows.
        # "merge.reorder" perturbs only the cluster-aware doc reordering:
        # the merge must then degrade to append order, never fail or corrupt
        self.fault_injector = fault_injector

    def execute(self, operation: MergeOperation,
                delete_tasks: Optional[list[dict]] = None) -> Optional[str]:
        """`delete_tasks`: metastore task dicts ({"opstamp", "query_ast"}).
        Only tasks NEWER than every input split's delete_opstamp still need
        applying — already-applied tasks must not push merges onto the slow
        doc-level path forever."""
        if self.fault_injector is not None:
            self.fault_injector.perturb("merge.execute")
        max_delete_opstamp = self.metastore.last_delete_opstamp(self.index_uid)
        min_applied = min(s.metadata.delete_opstamp for s in operation.splits)
        applicable = [t for t in (delete_tasks or [])
                      if t["opstamp"] > min_applied]
        from ..query.ast import ast_from_dict
        delete_matchers = self._delete_matchers(
            [ast_from_dict(t["query_ast"]) for t in applicable])
        readers = [SplitReader(self.split_storage,
                               split_file_path(s.metadata.split_id))
                   for s in operation.splits]
        if not delete_matchers:
            # fast path: array-level segment merge, no re-tokenization;
            # stats come from the authoritative split metadata. The merged
            # split clusters doc ids by timestamp so zonemaps tighten;
            # "merge.reorder" chaos faults (and any other reorder failure)
            # degrade to the plain append-order merge inside merge_splits
            from ..index.merge_arrays import merge_splits
            reorder_hook = None
            if self.fault_injector is not None:
                reorder_hook = (
                    lambda: self.fault_injector.perturb("merge.reorder"))
            data = merge_splits(readers,
                                reorder_field=self.doc_mapper.timestamp_field,
                                fault_hook=reorder_hook)
            num_docs = sum(s.metadata.num_docs for s in operation.splits)
            uncompressed = sum(s.metadata.uncompressed_docs_size_bytes
                               for s in operation.splits)
            time_min = min((s.metadata.time_range_start
                            for s in operation.splits
                            if s.metadata.time_range_start is not None),
                           default=None)
            time_max = max((s.metadata.time_range_end
                            for s in operation.splits
                            if s.metadata.time_range_end is not None),
                           default=None)
            tags = frozenset().union(*(s.metadata.tags for s in operation.splits))
            return self._publish_merged(
                operation, data, num_docs, uncompressed, time_min, time_max,
                tags, max_delete_opstamp,
                _merge_column_bounds(operation.splits))
        # delete tasks pending: doc-level rewrite applies them
        writer = SplitWriter(self.doc_mapper)
        for reader in readers:
            for doc in _iter_all_docs(reader):
                if any(matcher(doc) for matcher in delete_matchers):
                    continue
                writer.add_json_doc(doc)
        if writer.num_docs == 0:
            # all docs deleted: publish the replacement as a pure removal
            self.metastore.publish_splits(
                self.index_uid, [], replaced_split_ids=operation.split_ids)
            return None
        data = writer.finish()
        return self._publish_merged(
            operation, data, writer.num_docs, writer._uncompressed_docs_size,
            writer._time_min, writer._time_max, frozenset(writer.tags),
            max_delete_opstamp,
            dict(writer.column_bounds))

    def _publish_merged(self, operation, data, num_docs, uncompressed,
                        time_min, time_max, tags, max_delete_opstamp,
                        column_bounds=None):
        merged_id = new_split_id()
        metadata = SplitMetadata(
            split_id=merged_id,
            index_uid=self.index_uid,
            source_id=operation.splits[0].metadata.source_id,
            node_id=self.node_id,
            num_docs=num_docs,
            uncompressed_docs_size_bytes=uncompressed,
            footprint_bytes=len(data),
            time_range_start=time_min,
            time_range_end=time_max,
            tags=tags,
            create_timestamp=int(wall_time()),
            num_merge_ops=1 + max(s.metadata.num_merge_ops for s in operation.splits),
            delete_opstamp=max_delete_opstamp,
            doc_mapping_uid=operation.splits[0].metadata.doc_mapping_uid,
            partition_id=operation.splits[0].metadata.partition_id,
            column_bounds=column_bounds or {},
        )
        self.metastore.stage_splits(self.index_uid, [metadata])
        self.split_storage.put(split_file_path(merged_id), data)
        if self.fault_injector is not None:
            # pre-publish crash: the merged split stays STAGED (GC fodder)
            # and every input stays PUBLISHED — the replace is all-or-nothing
            self.fault_injector.perturb("merge.publish")
        self.metastore.publish_splits(
            self.index_uid, [merged_id],
            replaced_split_ids=operation.split_ids)
        logger.info("merged %d splits -> %s (%d docs)",
                    len(operation.splits), merged_id, num_docs)
        return merged_id

    def _delete_matchers(self, delete_query_asts: list):
        """Host-side doc matchers for delete tasks. Round-1 subset: term and
        bool-of-terms queries on mapped fields evaluated against the raw doc;
        complex deletes are applied by search-based planners later."""
        from ..query import ast as Q

        def matcher_for(ast):
            if isinstance(ast, Q.Term):
                field_path = ast.field.split(".")

                def match(doc, path=field_path, value=ast.value):
                    node = doc
                    for key in path:
                        if not isinstance(node, dict) or key not in node:
                            return False
                        node = node[key]
                    return str(node) == value
                return match
            if isinstance(ast, Q.Bool):
                subs = [matcher_for(c) for c in ast.must + ast.filter]
                nots = [matcher_for(c) for c in ast.must_not]
                shoulds = [matcher_for(c) for c in ast.should]

                def match(doc):
                    if subs and not all(m(doc) for m in subs):
                        return False
                    if nots and any(m(doc) for m in nots):
                        return False
                    if shoulds and not (subs or any(m(doc) for m in shoulds)):
                        return False
                    return bool(subs or shoulds)
                return match
            raise ValueError(
                f"delete query node {type(ast).__name__} not supported")
        return [matcher_for(ast) for ast in delete_query_asts]
