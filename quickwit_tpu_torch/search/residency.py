"""Device-resident column store: warm splits' packed columns stay on the card.

Role of the reference's fast-field cache stack, lifted to the device. The
leaf's default staging cache lives on the `SplitReader`, so residency dies
whenever the reader LRU closes the split and every reopen re-pays the full
host→device staging. The `ResidentColumnStore` keys residency by **split
id** instead: a `SplitColumns` owner object with a stable identity survives
reader churn, so a warm repeat query stages ZERO column bytes (the
`qw_resident_staging_cache_hits_total` counter is the test-asserted proof).

One store per device: a `SearcherContext` binds its store and its
`HbmBudget` to the one device it runs on, so a `SplitColumns` never hands a
tensor of one device to a program on another.

Byte accounting is NOT duplicated: `SplitColumns` quacks like a reader
(it carries `_device_array_cache`), so `HbmBudget`'s pinned → resident
flow, LRU eviction, and tenant-DRR admission all see resident column bytes
through the same owner seam. `device_bytes` counts the bytes the warmups
actually staged for the split: each distinct array key once (the leaf packs
a warmup's arrays into one buffer and stages a key that repeats across
slots once), plus the predicate mask the mask tier seeds. Alignment padding
inside a staging buffer is not counted. Eviction arrives via
`HbmBudget._evict_locked()` calling `cache.clear()` — the notifying dict
reports it here (metrics + `residency.evict` fault point) before dropping
the references.

Eviction cannot corrupt an in-flight query: `warmup_device_arrays` hands
the executor a plain list of tensor references, so a concurrent `clear()`
frees device memory only once the query's own references die. The
per-split path stages and runs its program on the caller's current
stream, and the caching allocator reuses a freed block in that stream's
order, so memory a queued kernel still reads is never handed to later work
on another stream. The `residency.evict` chaos point injects failures INTO
the eviction notification; injected errors are absorbed (an eviction-side
fault must never fail an innocent query that merely triggered LRU
pressure).
"""

from __future__ import annotations

import logging
import weakref
from typing import Any, Optional

from ..common import sync
from ..common.faults import InjectedFault
from ..observability import flight
from ..observability.metrics import (
    QBATCH_SHARED_BYTES_AVOIDED_TOTAL, RESIDENT_BYTES, RESIDENT_COLUMN_HITS,
    RESIDENT_COLUMN_MISSES, RESIDENT_EVICTIONS, RESIDENT_READBACKS_SHED,
    RESIDENT_STAGING_CACHE_HITS,
)

logger = logging.getLogger(__name__)

__all__ = ["RESIDENT_BYTES", "RESIDENT_COLUMN_HITS", "RESIDENT_COLUMN_MISSES",
           "RESIDENT_EVICTIONS", "RESIDENT_READBACKS_SHED",
           "RESIDENT_STAGING_CACHE_HITS", "ResidentColumnStore",
           "SplitColumns", "mesh_stack_id", "note_group_shared_staging"]


def note_group_shared_staging(plans, live_lanes: int) -> int:
    """Residency accounting for a stacked multi-query dispatch
    (search/batcher.py): operand slots whose cache key agrees across the
    group serve every lane from one staged tensor, so each such slot is a
    (live_lanes - 1)-fold staging the resident store did not have to
    absorb. Records the avoided bytes under the qbatch family and the
    per-column hit counters (the shared slots ARE resident-store serves:
    identical keys alias the same staged tensor), returns the byte
    count."""
    if live_lanes <= 1 or not plans:
        return 0
    from .executor import stacked_slot_split
    shared_slots, _stacked = stacked_slot_split(plans)
    if not shared_slots:
        return 0
    nbytes = sum(plans[0].arrays[s].nbytes for s in shared_slots) \
        * (live_lanes - 1)
    QBATCH_SHARED_BYTES_AVOIDED_TOTAL.inc(nbytes)
    RESIDENT_COLUMN_HITS.inc(len(shared_slots) * (live_lanes - 1))
    return nbytes


def mesh_stack_id(split_ids, num_docs_padded: int, mesh) -> str:
    """Stable residency key for one mesh's column set (the JAX package's
    identity, with the same digest): the ordered split set, the padded doc
    count, the mesh's axis names and grid shape. The mesh route keys the
    resident copies it keeps on a device other than the context's under
    it, so copies laid out for one grid never serve another."""
    import hashlib
    ident = repr((tuple(split_ids), num_docs_padded,
                  tuple(mesh.axis_names), tuple(mesh.devices.shape)))
    digest = hashlib.blake2b(ident.encode(), digest_size=12).hexdigest()
    return f"meshstack:{digest}"


class _NotifyingCache(dict):
    """`_device_array_cache`-shaped dict whose `clear()` tells the store.

    `HbmBudget._evict_locked` evicts residency by calling `cache.clear()`
    on the owner's `_device_array_cache` — subclassing dict turns that
    call into the store's eviction notification with zero changes to the
    admission layer."""

    __slots__ = ("_store_ref", "_split_id")

    def __init__(self, store: "ResidentColumnStore", split_id: str):
        super().__init__()
        self._store_ref = weakref.ref(store)
        self._split_id = split_id

    def clear(self) -> None:  # noqa: A003 - dict interface
        store = self._store_ref()
        if store is not None and self:
            store._on_evict(self._split_id)
        super().clear()


class SplitColumns:
    """HbmBudget owner for one split's device-resident columns.

    Identity (not the reader's) is what admission pins and residency keys
    on, so reopening a split's reader neither loses the resident bytes nor
    re-admits them."""

    __slots__ = ("split_id", "_device_array_cache", "device_bytes",
                 "staging_lock", "__weakref__")

    def __init__(self, store: "ResidentColumnStore", split_id: str):
        self.split_id = split_id
        self._device_array_cache = _NotifyingCache(store, split_id)
        self.device_bytes = 0
        # serializes the warmups of this split (leaf.warmup_device_arrays)
        self.staging_lock = sync.lock("SplitColumns.staging_lock")


class ResidentColumnStore:
    """Map split_id → `SplitColumns` for one device, metrics, chaos hook.

    The store holds the STRONG reference to each `SplitColumns`;
    `HbmBudget._resident` holds only a weakref. On eviction the store
    drops its entry, the owner dies, and the budget's weakref callback
    cleans up the residency row — the same lifecycle readers have.
    """

    def __init__(self, fault_injector=None):
        self._lock = sync.lock("ResidentColumnStore._lock")
        sync.register_shared(self, "ResidentColumnStore")
        self._by_split: dict[str, SplitColumns] = {}
        self._bytes = 0
        self.fault_injector = fault_injector
        self.enabled = True

    # ------------------------------------------------------------------
    def columns_for(self, split_id: str) -> SplitColumns:
        with self._lock:
            cols = self._by_split.get(split_id)
            if cols is None:
                cols = self._by_split[split_id] = SplitColumns(self, split_id)
            return cols

    def peek(self, split_id: str) -> Optional[SplitColumns]:
        with self._lock:
            return self._by_split.get(split_id)

    def note_upload(self, split_id: str, nbytes: int, columns: int) -> None:
        """Record a cold staging: `columns` columns, `nbytes` landed."""
        RESIDENT_COLUMN_MISSES.inc(columns)
        if flight.recording():
            flight.emit("staging.upload",
                        attrs={"split": split_id, "bytes": nbytes,
                               "columns": columns})
        with self._lock:
            cols = self._by_split.get(split_id)
            if cols is not None:
                cols.device_bytes += nbytes
            self._bytes += nbytes
            RESIDENT_BYTES.set(self._bytes)

    def note_hits(self, columns: int, full: bool) -> None:
        """Record `columns` columns served resident; `full` means the whole
        warmup copied nothing (the warm-repeat-query proof)."""
        if columns:
            RESIDENT_COLUMN_HITS.inc(columns)
            if flight.recording():
                flight.emit("staging.resident_hit",
                            attrs={"columns": columns, "full": int(full)})
        if full:
            RESIDENT_STAGING_CACHE_HITS.inc()

    # ------------------------------------------------------------------
    def _on_evict(self, split_id: str) -> None:
        """Called from `_NotifyingCache.clear()` — i.e. from inside
        `HbmBudget._evict_locked` under the budget lock. Must not call back
        into the budget, and must absorb injected faults: an eviction-side
        failure may lose residency (re-staged next query) but must never
        propagate into whichever query's admission triggered the LRU."""
        try:
            if self.fault_injector is not None:
                self.fault_injector.perturb("residency.evict")
        except InjectedFault as exc:
            logger.warning("residency.evict fault absorbed for split %s: %s",
                           split_id, exc)
        finally:
            with self._lock:
                cols = self._by_split.pop(split_id, None)
                freed = cols.device_bytes if cols is not None else 0
                if cols is not None:
                    cols.device_bytes = 0
                self._bytes -= freed
                RESIDENT_BYTES.set(self._bytes)
            RESIDENT_EVICTIONS.inc()
            if flight.recording():
                flight.emit("staging.evict",
                            attrs={"split": split_id, "bytes": freed})
            logger.info("resident columns evicted: split=%s bytes=%d",
                        split_id, freed)

    # --- observability ------------------------------------------------
    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "splits": len(self._by_split),
                "bytes": self._bytes,
                "by_split": {sid: cols.device_bytes
                             for sid, cols in self._by_split.items()},
            }
