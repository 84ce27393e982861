"""Compaction planner: merge-task planning with in-flight tracking.

Role of the reference's standalone compaction planner
(`quickwit-compaction/src/planner/compaction_planner.rs`): each tick it
re-scans the immature published split set per index (most-urgent first),
runs the index's merge policy, and emits merge tasks — EXCLUDING splits
already claimed by an in-flight task, so a slow merge is never
double-scheduled. Completed/failed/expired tasks release their claims.

The planner is deliberately stateless across restarts (like the
reference: "wait for two intervals to let in-progress workers report"
— here a fresh planner simply re-plans; the metastore's replace-splits
publish is idempotent per input set, and executors fail cleanly when an
input split was already replaced).

Carried over whole from the JAX package's `compaction/planner.py`.
"""

from __future__ import annotations

import logging
import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from ..common.clock import monotonic
from ..indexing.merge import merge_policy_from_config
from ..metastore.base import ListSplitsQuery, Metastore
from ..models.split_metadata import Split, SplitState

logger = logging.getLogger(__name__)

# cap on splits considered per index per tick (reference
# MAX_SPLITS_PER_TICK rationale: a backlog bubbles into range as the
# front of the queue merges off)
MAX_SPLITS_PER_TICK = 1000


@dataclass
class MergeTask:
    task_id: str
    index_uid: str
    split_ids: tuple[str, ...]
    created_at: float = 0.0


@dataclass
class _InFlight:
    task: MergeTask
    deadline: float


class CompactionPlanner:
    """Plans merge tasks over the metastore's published split set."""

    def __init__(self, metastore: Metastore,
                 task_timeout_secs: float = 600.0,
                 clock: Callable[[], float] = monotonic):
        self.metastore = metastore
        self.task_timeout_secs = task_timeout_secs
        self.clock = clock
        # completion hooks fire on merge WORKER threads while plan()
        # runs on the tick thread — every _in_flight access locks
        # qwlint: disable-next-line=QW008 - compaction supervisor background
        # loop, outside the DST-raced path; leaf primitives only
        self._lock = threading.Lock()
        self._in_flight: dict[str, _InFlight] = {}

    # -- claims --------------------------------------------------------
    def _claimed_split_ids(self) -> set[str]:
        now = self.clock()
        with self._lock:
            expired = [tid for tid, inf in self._in_flight.items()
                       if inf.deadline < now]
            for tid in expired:
                task = self._in_flight.pop(tid).task
                logger.warning("merge task %s on %s timed out; "
                               "re-planning its splits", tid,
                               task.index_uid)
            return {sid for inf in self._in_flight.values()
                    for sid in inf.task.split_ids}

    def complete_task(self, task_id: str) -> None:
        with self._lock:
            self._in_flight.pop(task_id, None)

    def fail_task(self, task_id: str) -> None:
        """Failed merges release their claim immediately (the reference's
        pipelines own retries; re-planning reissues the same merge)."""
        with self._lock:
            self._in_flight.pop(task_id, None)

    @property
    def num_in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    # -- planning ------------------------------------------------------
    def plan(self, index_uids: Optional[list[str]] = None,
             max_tasks: Optional[int] = None,
             indexes: Optional[list] = None) -> list[MergeTask]:
        """One planning tick → new merge tasks (claims recorded).
        `indexes` short-circuits the metastore scan when the caller
        already fetched the metadata (the node's tick does)."""
        claimed = self._claimed_split_ids()
        tasks: list[MergeTask] = []
        if indexes is None:
            indexes = self.metastore.list_indexes()
        for metadata in indexes:
            if index_uids is not None and \
                    metadata.index_uid not in index_uids:
                continue
            policy = merge_policy_from_config(
                metadata.index_config.merge_policy)
            splits = self.metastore.list_splits(ListSplitsQuery(
                index_uids=[metadata.index_uid],
                states=[SplitState.PUBLISHED]))
            # most-urgent first: oldest splits merge first under backlog
            splits.sort(key=lambda s: s.metadata.split_id)
            eligible: list[Split] = [
                s for s in splits[:MAX_SPLITS_PER_TICK]
                if s.metadata.split_id not in claimed]
            for operation in policy.operations(eligible):
                task = MergeTask(
                    task_id=uuid.uuid4().hex[:16],
                    index_uid=metadata.index_uid,
                    split_ids=tuple(s.metadata.split_id
                                    for s in operation.splits),
                    created_at=self.clock())
                with self._lock:
                    self._in_flight[task.task_id] = _InFlight(
                        task, self.clock() + self.task_timeout_secs)
                claimed.update(task.split_ids)
                tasks.append(task)
                if max_tasks is not None and len(tasks) >= max_tasks:
                    return tasks
        return tasks
