"""Compactor supervisor: a bounded pool of merge executions + lifecycle.

Role of the reference's `compactor_supervisor.rs`: a compactor node
accepts merge tasks up to `max_concurrent_merges` slots, executes each
through the MergeExecutor (the reference's CompactionPipeline), and
supports decommission — Draining rejects new tasks (reports zero free
slots) while in-flight merges finish, then Drained.

Carried over whole from the JAX package's `compaction/supervisor.py`.
"""

from __future__ import annotations

import enum
import logging
import threading
from typing import Callable, Optional

from ..indexing.merge import MergeExecutor, MergeOperation
from ..metastore.base import ListSplitsQuery, Metastore
from ..models.split_metadata import SplitState
from .planner import MergeTask

logger = logging.getLogger(__name__)


class CompactorState(enum.Enum):
    RUNNING = "running"
    DRAINING = "draining"
    DRAINED = "drained"


class CompactorSupervisor:
    def __init__(self, metastore: Metastore, storage_resolver,
                 node_id: str = "compactor-0",
                 max_concurrent_merges: int = 2):
        self.metastore = metastore
        self.storage_resolver = storage_resolver
        self.node_id = node_id
        self.max_concurrent_merges = max_concurrent_merges
        # qwlint: disable-next-line=QW008 - compaction supervisor background
        # loop, outside the DST-raced path; leaf primitives only
        self._lock = threading.Lock()
        self._active: set[str] = set()
        self._state = CompactorState.RUNNING
        # qwlint: disable-next-line=QW008 - compaction supervisor background
        # loop, outside the DST-raced path; leaf primitives only
        self._drained = threading.Event()
        self.num_completed = 0
        self.num_failed = 0

    # -- status --------------------------------------------------------
    @property
    def state(self) -> CompactorState:
        with self._lock:
            return self._state

    def available_slots(self) -> int:
        with self._lock:
            if self._state is not CompactorState.RUNNING:
                return 0  # draining compactors report zero capacity
            return max(0, self.max_concurrent_merges - len(self._active))

    def status(self) -> dict:
        with self._lock:
            return {"state": self._state.value,
                    "active_tasks": sorted(self._active),
                    "available_slots":
                        0 if self._state is not CompactorState.RUNNING
                        else max(0, self.max_concurrent_merges
                                 - len(self._active)),
                    "num_completed": self.num_completed,
                    "num_failed": self.num_failed}

    # -- execution -----------------------------------------------------
    def submit(self, task: MergeTask,
               on_done: Optional[Callable[[MergeTask, bool], None]] = None,
               synchronous: bool = False) -> bool:
        """Accept a merge task if a slot is free. `on_done(task, ok)`
        fires after execution (the planner's completion hook)."""
        with self._lock:
            if self._state is not CompactorState.RUNNING:
                return False
            if len(self._active) >= self.max_concurrent_merges:
                return False
            self._active.add(task.task_id)
        if synchronous:
            self._execute(task, on_done)
        else:
            # qwlint: disable-next-line=QW003 - merge tasks are background
            # maintenance; they must NOT inherit a submitting query's
            # deadline or the merge would be shed mid-write
            # qwlint: disable-next-line=QW008 - compaction supervisor
            # background loop, outside the DST-raced path; leaf primitives only
            threading.Thread(
                target=self._execute, args=(task, on_done),
                name=f"merge-{task.task_id}", daemon=True).start()
        return True

    def _execute(self, task: MergeTask, on_done):
        ok = False
        try:
            ok = self._run_merge(task)
        except Exception:  # noqa: BLE001 - supervised execution
            logger.exception("merge task %s failed", task.task_id)
        finally:
            with self._lock:
                self._active.discard(task.task_id)
                if ok:
                    self.num_completed += 1
                else:
                    self.num_failed += 1
                if (self._state is CompactorState.DRAINING
                        and not self._active):
                    self._state = CompactorState.DRAINED
                    self._drained.set()
            if on_done is not None:
                on_done(task, ok)

    def _run_merge(self, task: MergeTask) -> bool:
        for metadata in self.metastore.list_indexes():
            if metadata.index_uid == task.index_uid:
                break
        else:
            logger.warning("merge task %s: index %s is gone",
                           task.task_id, task.index_uid)
            return False
        want = set(task.split_ids)
        splits = [s for s in self.metastore.list_splits(ListSplitsQuery(
            index_uids=[task.index_uid], states=[SplitState.PUBLISHED]))
            if s.metadata.split_id in want]
        if len(splits) != len(want):
            # an input was already replaced (e.g. by a pre-split-brain
            # merge): abandoning is safe, the planner re-plans
            logger.info("merge task %s: inputs changed; skipping",
                        task.task_id)
            return False
        storage = self.storage_resolver.resolve(
            metadata.index_config.index_uri)
        executor = MergeExecutor(task.index_uid,
                                 metadata.index_config.doc_mapper,
                                 self.metastore, storage, self.node_id)
        delete_tasks = self.metastore.list_delete_tasks(task.index_uid)
        executor.execute(MergeOperation(tuple(splits)),
                         delete_tasks=delete_tasks or None)
        return True

    # -- lifecycle -----------------------------------------------------
    def decommission(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting tasks; wait for in-flight merges to finish."""
        with self._lock:
            if self._state is CompactorState.DRAINED:
                return True
            self._state = CompactorState.DRAINING
            if not self._active:
                self._state = CompactorState.DRAINED
                self._drained.set()
                return True
        return self._drained.wait(timeout=timeout)
