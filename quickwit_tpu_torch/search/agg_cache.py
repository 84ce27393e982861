"""Tier B — partial-aggregation cache.

Memoizes one split's COUNT and per-aggregation intermediate states keyed
`(split_id, canonical_filter_digest, agg_shape_digest)`. A dashboard of N
panels sharing one filter but fanning out over N distinct agg shapes
warms this cache on the first pass; subsequent passes collapse to
root-side merges of the cached partials — zero column staging, zero
kernel launches for the cached (split, agg) pairs.

Why this is sound: splits are immutable, and the executor computes
`count` and agg states from the FULL filter mask — search_after and
sort-value threshold pushdown restrict top-K *eligibility* only, never
counts/aggs (search/executor.py, the `fn` kernel). So a state filled
during a thresholded or paginated query is bit-identical to one filled
cold. The stored value IS the mergeable `intermediate_aggs`
representation the root collector consumes (search/collector.py), so a
hit plugs straight into the merge. States are stored pickled and
unpickled per hit — the collector merge MUTATES states, so every hit
must hand it a fresh copy.

`agg_shape_digest` hashes the aggregation SPEC (not its name): two panels
naming the same `{"terms": {"field": "severity"}}` differently still
share one entry.

Chaos points mirror search/mask_cache.py: `cache.mask_corrupt` on a hit
degrades to recompute; `cache.evict` on a put force-clears the calling
tenant's partition first. Both are absorbed — the triggering query never
fails.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from typing import Any, Optional

from ..common.faults import InjectedFault
from ..observability.metrics import (
    AGG_CACHE_EVICTED_BYTES_TOTAL, AGG_CACHE_HITS_TOTAL,
    AGG_CACHE_MISSES_TOTAL,
)
from .tenant_cache import TenantPartitionedCache


def agg_shape_digest(spec: dict) -> str:
    """Digest of one aggregation's spec dict (name-independent)."""
    return hashlib.blake2b(
        json.dumps(spec, sort_keys=True).encode(), digest_size=16).hexdigest()


class PartialAggCache:
    def __init__(self, capacity_bytes: int = 32 << 20, fault_injector=None):
        self._cache = TenantPartitionedCache(
            capacity_bytes,
            on_evict=AGG_CACHE_EVICTED_BYTES_TOTAL.inc,
            tier="partial_agg")
        self.fault_injector = fault_injector

    def _get(self, key: str) -> Optional[bytes]:
        raw = self._cache.get(key)
        if raw is not None and self.fault_injector is not None:
            try:
                self.fault_injector.perturb("cache.mask_corrupt")
            except InjectedFault:
                # injected corruption: drop the entry, degrade to recompute
                self._cache.delete(key)
                raw = None
        if raw is None:
            AGG_CACHE_MISSES_TOTAL.inc()
            return None
        AGG_CACHE_HITS_TOTAL.inc()
        return raw

    def _put(self, key: str, raw: bytes) -> None:
        if self.fault_injector is not None:
            try:
                self.fault_injector.perturb("cache.evict")
            except InjectedFault:
                # injected eviction storm: clear this tenant's partition,
                # then land the put — the triggering query is unharmed
                self._cache.clear_current_partition()
        self._cache.put(key, raw)

    def get_count(self, split_id: str, digest: str) -> Optional[int]:
        raw = self._get(f"{split_id}:{digest}:count")
        # qwlint: disable-next-line=QW001 - int() parses cached host BYTES
        # (the b"%d" put_count wrote), never a device value
        return None if raw is None else int(raw)

    def put_count(self, split_id: str, digest: str, count: int) -> None:
        self._put(f"{split_id}:{digest}:count", b"%d" % count)

    def get_agg(self, split_id: str, digest: str,
                shape_digest: str) -> Optional[Any]:
        raw = self._get(f"{split_id}:{digest}:agg:{shape_digest}")
        return None if raw is None else pickle.loads(raw)

    def put_agg(self, split_id: str, digest: str, shape_digest: str,
                state: Any) -> None:
        self._put(f"{split_id}:{digest}:agg:{shape_digest}",
                  pickle.dumps(state))

    @property
    def stats(self) -> dict:
        return self._cache.stats
