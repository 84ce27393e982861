"""Garbage collection of dead splits.

Role of the reference's `GarbageCollector` actor
(`quickwit-janitor/src/actors/garbage_collector.rs:104`) and
`quickwit-index-management/src/garbage_collection.rs`:
- staged splits older than a grace period (upload presumed crashed) are
  deleted from the metastore and storage,
- marked-for-deletion splits past a grace period have their files deleted
  then their metastore entries removed,
- orphan split files with no metastore entry are removed.

Carried over whole from the JAX package's `janitor/gc.py`.
"""

from __future__ import annotations

import logging
import time

from ..metastore.base import ListSplitsQuery, Metastore
from ..models.split_metadata import SplitState
from ..storage.base import StorageResolver

logger = logging.getLogger(__name__)

STAGED_GRACE_SECS = 2 * 3600       # reference: staged grace period
DELETION_GRACE_SECS = 120           # reference: 2 min


def run_garbage_collection(metastore: Metastore, storage_resolver: StorageResolver,
                           staged_grace_secs: int = STAGED_GRACE_SECS,
                           deletion_grace_secs: int = DELETION_GRACE_SECS,
                           now: float | None = None) -> dict[str, int]:
    now_ts = now if now is not None else time.time()
    removed_files = 0
    removed_entries = 0
    removed_orphans = 0
    for index_metadata in metastore.list_indexes():
        index_uid = index_metadata.index_uid
        storage = storage_resolver.resolve(index_metadata.index_config.index_uri)
        removed_orphans += _delete_orphan_files(metastore, storage, index_uid)
        stale_staged = [
            s for s in metastore.list_splits(ListSplitsQuery(
                index_uids=[index_uid], states=[SplitState.STAGED]))
            if now_ts - s.update_timestamp > staged_grace_secs
        ]
        if stale_staged:
            metastore.mark_splits_for_deletion(
                index_uid, [s.metadata.split_id for s in stale_staged])
        to_delete = [
            s for s in metastore.list_splits(ListSplitsQuery(
                index_uids=[index_uid], states=[SplitState.MARKED_FOR_DELETION]))
            if now_ts - s.update_timestamp > deletion_grace_secs
        ]
        if not to_delete:
            continue
        split_ids = [s.metadata.split_id for s in to_delete]
        for split_id in split_ids:
            try:
                storage.delete(f"{split_id}.split")
                removed_files += 1
            except Exception:  # noqa: BLE001 - already gone is success
                pass
        metastore.delete_splits(index_uid, split_ids)
        removed_entries += len(split_ids)
        logger.info("gc removed %d splits of %s", len(split_ids), index_uid)
    return {"gc_deleted_files": removed_files,
            "gc_deleted_splits": removed_entries,
            "gc_deleted_orphans": removed_orphans}


def _delete_orphan_files(metastore: Metastore, storage,
                         index_uid: str) -> int:
    """Remove `.split` files with NO metastore entry in ANY state
    (reference `garbage_collection.rs:1` orphan cleanup). Safe without a
    grace period because of two orderings:
    - every upload path stages its metastore entry BEFORE the storage put
      (uploader/merge protocol), and
    - the file listing is taken BEFORE a forced metastore refresh, so any
      file in the listing had its stage committed before the state we
      compare against was read (a cached, minutes-old metastore view
      could otherwise miss another node's fresh stage and delete a live
      upload).
    A file with no entry can then only be the debris of a crashed upload
    whose staged entry was already GC'd, or of a delete_splits whose file
    removal failed."""
    try:
        files = storage.list_files()
    except Exception as exc:  # noqa: BLE001 - listing is best-effort
        logger.debug("orphan scan listing failed for %s: %s",
                     index_uid, exc)
        return 0
    metastore.refresh()
    known = {
        s.metadata.split_id
        for s in metastore.list_splits(ListSplitsQuery(
            index_uids=[index_uid]))
    }
    removed = 0
    for name in files:
        if not name.endswith(".split"):
            continue
        split_id = name[: -len(".split")]
        if split_id in known:
            continue
        try:
            storage.delete(name)
            removed += 1
        except Exception:  # noqa: BLE001 - already gone is success
            pass
    if removed:
        logger.info("gc removed %d orphan files of %s", removed, index_uid)
    return removed
