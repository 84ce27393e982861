"""Tier A — predicate-mask cache.

Memoizes the evaluated filter bitmask of one split, keyed
`(split_id, canonical_filter_digest)` (search/cache.py): two dashboard
panels sharing one filter but differing in top-K / sort / agg shape reuse
the SAME mask, so the warm panel stages zero predicate columns and skips
kernel filter evaluation entirely — the lowering swaps the whole query
root for a `PMaskRef` node over the packed mask (search/plan.py), and the
executor unpacks bits instead of walking postings (search/executor.py).

The mask is stored np.packbits-packed (1 bit/doc, big-endian — the device
pack/unpack in executor.py uses the same bit order). Host residency lives
here, byte-bounded and tenant-partitioned (Tier C); DEVICE residency needs
no code of its own: the packed mask rides `plan.array_keys` under
`mask.<digest>`, so `warmup_device_arrays` + `ResidentColumnStore` keep it
in HBM for warm splits with `HbmBudget` accounting, exactly like any
column.

Soundness: splits are immutable, and the digest covers everything that
decides WHICH docs match (query AST + rebased time bounds). Fills are
gated on `plan.count_override is None` — an impact-prefix-truncated plan
(format v3) never saw the posting tail, so its mask is incomplete.

Chaos points (common/faults.py):
- `cache.mask_corrupt` fires on a hit: the entry is treated as corrupt,
  dropped, and the query degrades to recompute (a miss), never fails.
- `cache.evict` fires on a put: the calling tenant's partition is
  force-cleared first (eviction-storm simulation); the put still lands.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common.faults import InjectedFault
from ..observability.metrics import (
    MASK_CACHE_EVICTED_BYTES_TOTAL, MASK_CACHE_HITS_TOTAL,
    MASK_CACHE_MISSES_TOTAL,
)
from .tenant_cache import TenantPartitionedCache


def packed_mask_nbytes(num_docs_padded: int) -> int:
    return (num_docs_padded + 7) // 8


class PredicateMaskCache:
    def __init__(self, capacity_bytes: int = 32 << 20, fault_injector=None):
        self._cache = TenantPartitionedCache(
            capacity_bytes,
            on_evict=MASK_CACHE_EVICTED_BYTES_TOTAL.inc,
            tier="predicate_mask")
        self.fault_injector = fault_injector

    @staticmethod
    def _key(split_id: str, digest: str) -> str:
        return f"{split_id}:{digest}"

    def get(self, split_id: str, digest: str,
            expected_nbytes: int) -> Optional[np.ndarray]:
        """The packed uint8 mask, or None. `expected_nbytes` pins the entry
        to the split's padded doc space — a mismatch (impossible for an
        immutable split, conceivable after a corruption fault) degrades to
        a miss instead of feeding the kernel a wrong-shaped array."""
        key = self._key(split_id, digest)
        raw = self._cache.get(key)
        if raw is not None and self.fault_injector is not None:
            try:
                self.fault_injector.perturb("cache.mask_corrupt")
            except InjectedFault:
                # injected corruption: drop the entry and recompute — the
                # triggering query must never fail or return wrong results
                self._cache.delete(key)
                raw = None
        if raw is None or len(raw) != expected_nbytes:
            MASK_CACHE_MISSES_TOTAL.inc()
            return None
        MASK_CACHE_HITS_TOTAL.inc()
        return np.frombuffer(raw, dtype=np.uint8)

    def put(self, split_id: str, digest: str, packed: np.ndarray) -> None:
        if self.fault_injector is not None:
            try:
                self.fault_injector.perturb("cache.evict")
            except InjectedFault:
                # injected eviction storm: this tenant's partition is
                # force-cleared (counted as evicted bytes); absorbing the
                # fault here keeps the triggering query unharmed
                self._cache.clear_current_partition()
        self._cache.put(self._key(split_id, digest),
                        np.ascontiguousarray(packed, dtype=np.uint8)
                        .tobytes())

    @property
    def stats(self) -> dict:
        return self._cache.stats
