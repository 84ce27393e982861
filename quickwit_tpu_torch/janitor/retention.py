"""Retention policy enforcement.

Role of the reference's `RetentionPolicyExecutor`
(`quickwit-janitor/src/actors/retention_policy_executor.rs:60`): splits whose
entire time range is older than the index's retention period are marked for
deletion (GC then removes them).

Carried over whole from the JAX package's `janitor/retention.py`.
"""

from __future__ import annotations

import logging
import time

from ..metastore.base import ListSplitsQuery, Metastore
from ..models.split_metadata import SplitState

logger = logging.getLogger(__name__)


def apply_retention(metastore: Metastore, now: float | None = None) -> dict[str, int]:
    now_ts = now if now is not None else time.time()
    marked = 0
    for index_metadata in metastore.list_indexes():
        retention = index_metadata.index_config.retention
        if retention is None:
            continue
        cutoff_micros = int((now_ts - retention.period_seconds) * 1_000_000)
        expired = [
            s for s in metastore.list_splits(ListSplitsQuery(
                index_uids=[index_metadata.index_uid],
                states=[SplitState.PUBLISHED]))
            if s.metadata.time_range_end is not None
            and s.metadata.time_range_end < cutoff_micros
        ]
        if expired:
            metastore.mark_splits_for_deletion(
                index_metadata.index_uid,
                [s.metadata.split_id for s in expired])
            marked += len(expired)
            logger.info("retention marked %d splits of %s",
                        len(expired), index_metadata.index_uid)
    return {"retention_marked_splits": marked}
