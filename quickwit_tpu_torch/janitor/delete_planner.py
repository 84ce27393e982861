"""Delete-task planner: schedules delete-applying merges.

Role of the reference's `DeleteTaskPlanner`
(`quickwit-janitor/src/actors/delete_task_planner.rs:75`): find published
splits whose `delete_opstamp` lags the index's latest delete task, probe
each with a COUNT search for the pending delete queries, and

- splits with zero matching docs get their `delete_opstamp` fast-forwarded
  in place (no rewrite — the reference does exactly this to keep GDPR
  sweeps cheap on untouched splits),
- splits with matching docs are rewritten through the normal merge
  protocol (`MergeExecutor.execute` with the pending tasks), which
  publishes the replacement atomically and stamps it with the latest
  opstamp.

One planner pass is idempotent: rerunning converges to every published
split carrying `last_delete_opstamp`.

Carried over whole from the JAX package's `janitor/delete_planner.py`. The
COUNT probe is this module's device touchpoint: it runs the port's
`leaf_search_single_split` on the planner's `device` (default `cuda`;
pass `device="cpu"` for the plain torch path). A probe that fails is read
as a match, as in the JAX package, except for a fault of the device
(`parallel.fanout.is_device_fault`): that propagates, as the search
service's does, rather than turning into a rewrite on the host.
"""

from __future__ import annotations

import logging

from .. import resolve_device
from ..indexing.merge import MergeExecutor, MergeOperation
from ..metastore.base import ListSplitsQuery, Metastore
from ..models.doc_mapper import DocMapper
from ..models.split_metadata import SplitState
from ..storage.base import Storage

logger = logging.getLogger(__name__)

# bound per pass (reference plans a small batch per activation so one huge
# backlog cannot starve regular merges)
MAX_REWRITES_PER_PASS = 16


class DeleteTaskPlanner:
    def __init__(self, index_uid: str, doc_mapper: DocMapper,
                 metastore: Metastore, split_storage: Storage,
                 node_id: str = "node-0", device=None):
        self.index_uid = index_uid
        self.device = resolve_device(device)
        self.doc_mapper = doc_mapper
        self.metastore = metastore
        self.split_storage = split_storage
        self.executor = MergeExecutor(index_uid, doc_mapper, metastore,
                                      split_storage, node_id=node_id)

    def run_pass(self, max_rewrites: int = MAX_REWRITES_PER_PASS
                 ) -> dict[str, int]:
        """One planning pass; returns counters for observability/tests."""
        last_opstamp = self.metastore.last_delete_opstamp(self.index_uid)
        stale = [
            s for s in self.metastore.list_splits(ListSplitsQuery(
                index_uids=[self.index_uid],
                states=[SplitState.PUBLISHED]))
            if s.metadata.delete_opstamp < last_opstamp
        ]
        # oldest opstamp first: the most-behind splits carry the most
        # pending deletes and bound the sweep's convergence
        stale.sort(key=lambda s: s.metadata.delete_opstamp)
        # ONE task fetch per pass (backends return tasks with opstamp
        # strictly greater than opstamp_start); filtered per split in
        # memory instead of a metastore query per split
        all_tasks = self.metastore.list_delete_tasks(
            self.index_uid,
            opstamp_start=stale[0].metadata.delete_opstamp) if stale else []
        fast_forwarded: list[str] = []
        rewritten = 0
        for split in stale:
            if rewritten >= max_rewrites:
                break
            tasks = [t for t in all_tasks
                     if t["opstamp"] > split.metadata.delete_opstamp]
            if not tasks:
                fast_forwarded.append(split.metadata.split_id)
                continue
            if not self._split_matches_any(split, tasks):
                fast_forwarded.append(split.metadata.split_id)
                continue
            try:
                self.executor.execute(MergeOperation(splits=(split,)),
                                      delete_tasks=tasks)
                rewritten += 1
            except Exception as exc:  # noqa: BLE001 - next pass retries
                logger.warning("delete merge of %s failed: %s",
                               split.metadata.split_id, exc)
        if fast_forwarded:
            self.metastore.update_splits_delete_opstamp(
                self.index_uid, fast_forwarded, last_opstamp)
        return {"delete_splits_rewritten": rewritten,
                "delete_splits_fast_forwarded": len(fast_forwarded),
                "delete_splits_pending": max(
                    0, len(stale) - rewritten - len(fast_forwarded))}

    def _split_matches_any(self, split, tasks: list[dict]) -> bool:
        """COUNT probe: does any pending delete query hit this split?
        (reference probes with a search before scheduling the rewrite)"""
        from ..index.reader import SplitReader
        from ..indexing.pipeline import split_file_path
        from ..parallel.fanout import is_device_fault
        from ..query.ast import ast_from_dict
        from ..search.leaf import leaf_search_single_split
        from ..search.models import SearchRequest
        try:
            reader = SplitReader(self.split_storage,
                                 split_file_path(split.metadata.split_id))
        except Exception as exc:  # noqa: BLE001 - treat as matching
            logger.debug("delete probe open failed for %s: %s",
                         split.metadata.split_id, exc)
            return True  # rewrite path will surface the real error
        for task in tasks:
            try:
                response = leaf_search_single_split(
                    SearchRequest(index_ids=[self.index_uid],
                                  query_ast=ast_from_dict(task["query_ast"]),
                                  max_hits=0),
                    self.doc_mapper, reader, split.metadata.split_id,
                    device=self.device)
            except Exception as exc:  # noqa: BLE001 - treat as matching
                if is_device_fault(exc):
                    raise  # a fault of the card is not a match
                logger.debug("delete probe failed for %s: %s",
                             split.metadata.split_id, exc)
                return True
            if response.num_hits > 0:
                return True
        return False


def run_delete_planner(metastore: Metastore, storage_resolver,
                       node_id: str = "node-0",
                       device=None) -> dict[str, int]:
    """Planner pass over every index (the janitor entry point); the probes
    run on `device` (default `cuda`)."""
    totals = {"delete_splits_rewritten": 0,
              "delete_splits_fast_forwarded": 0,
              "delete_splits_pending": 0}
    for index_metadata in metastore.list_indexes():
        if metastore.last_delete_opstamp(index_metadata.index_uid) == 0:
            continue  # no delete tasks ever created for this index
        doc_mapper = index_metadata.index_config.doc_mapper
        storage = storage_resolver.resolve(
            index_metadata.index_config.index_uri)
        planner = DeleteTaskPlanner(
            index_metadata.index_uid, doc_mapper, metastore, storage,
            node_id=node_id, device=device)
        stats = planner.run_pass()
        for key, value in stats.items():
            totals[key] += value
    return totals
