"""Tenant-partitioned byte quotas for the hierarchical leaf caches.

Tier C of the layered leaf cache (docs/hierarchical-cache.md): the
leaf-response, predicate-mask, and partial-aggregation caches all store
through this facade, which segments entries by the ambient `TenantContext`
(`tenancy/context.py`) so one tenant's dashboard storm can only evict its
OWN working set.

Each tenant gets its own `MemorySizedCache` partition whose quota is the
facade capacity split by the tenants' DRR weights — the same
`PRIORITY_CLASSES` weights the HBM admission scheduler uses, so cache
share and admission share follow one fairness policy:

    quota(t) = capacity * weight(t) / sum(weight(u) for known u)

The known-tenant set grows lazily from traffic; every new partition
re-quotas the existing ones (LRU entries over the shrunk quota are
evicted). With tenancy disabled nothing is ever bound, `effective_tenant`
returns the single implicit DEFAULT_TENANT, and the one partition's quota
is the full capacity — bit-identical behavior to an unpartitioned
`MemorySizedCache`, not a separate code path.
"""

from __future__ import annotations

from typing import Optional

from ..common import sync
from ..observability import flight
from ..storage.cache import MemorySizedCache
from ..tenancy.context import effective_tenant


class TenantPartitionedCache:
    """Byte-bounded LRU keyed (ambient tenant, key) with per-tenant quotas.

    `tier` names this cache in flight-recorder events (`cache.hit` /
    `cache.fill` / `cache.evict` carry it as the `tier` attribute) — the
    single instrumentation point for every tier that stores through the
    facade (leaf response, predicate mask, partial agg)."""

    def __init__(self, capacity_bytes: int, on_evict=None, tier: str = ""):
        self.capacity_bytes = capacity_bytes
        self.tier = tier
        self._parts: dict[str, MemorySizedCache] = {}
        self._weights: dict[str, float] = {}
        self._lock = sync.lock("TenantPartitionedCache._lock")
        sync.register_shared(self, "TenantPartitionedCache")
        self._on_evict = self._wrap_evict(on_evict) if tier else on_evict

    def _wrap_evict(self, inner):
        def _evict(nbytes: int) -> None:
            if flight.recording():
                flight.emit("cache.evict",
                            attrs={"tier": self.tier, "bytes": nbytes})
            if inner is not None:
                inner(nbytes)
        return _evict

    def _partition(self) -> MemorySizedCache:
        tenant = effective_tenant()
        with self._lock:
            sync.note_write(self, "parts")
            part = self._parts.get(tenant.tenant_id)
            if part is None:
                part = MemorySizedCache(self.capacity_bytes,
                                        on_evict=self._on_evict)
                self._parts[tenant.tenant_id] = part
                # qwlint: disable-next-line=QW001 - DRR weight is a host
                # python number off the ambient TenantContext, never device
                self._weights[tenant.tenant_id] = float(tenant.weight)
                self._requota_locked()
            return part

    def _requota_locked(self) -> None:
        total = sum(self._weights.values()) or 1.0
        for tenant_id, part in self._parts.items():
            # qwlint: disable-next-line=QW001 - quota math on host python
            # floats (capacity × weight share), no device values involved
            part.resize(int(self.capacity_bytes
                            * self._weights[tenant_id] / total))

    def get(self, key: str) -> Optional[bytes]:
        data = self._partition().get(key)
        if self.tier and data is not None and flight.recording():
            flight.emit("cache.hit",
                        attrs={"tier": self.tier, "bytes": len(data)})
        return data

    def put(self, key: str, data: bytes) -> None:
        if self.tier and flight.recording():
            flight.emit("cache.fill",
                        attrs={"tier": self.tier, "bytes": len(data)})
        self._partition().put(key, data)

    def delete(self, key: str) -> None:
        self._partition().delete(key)

    def clear_current_partition(self) -> int:
        """Forced eviction of the calling tenant's partition (the
        `cache.evict` chaos point degrades THIS tenant, never another's)."""
        return self._partition().clear()

    @property
    def stats(self) -> dict:
        with self._lock:
            sync.note_read(self, "parts")
            parts = dict(self._parts)
        # per-partition counters read under EACH partition's own lock
        # (stats_snapshot): the bare attribute reads this replaced raced
        # the hit/miss increments on the partitions (found by qwrace)
        snaps = {tenant_id: p.stats_snapshot()
                 for tenant_id, p in parts.items()}
        return {
            "hits": sum(s["hits"] for s in snaps.values()),
            "misses": sum(s["misses"] for s in snaps.values()),
            "size_bytes": sum(s["size_bytes"] for s in snaps.values()),
            "evicted_bytes": sum(s["evicted_bytes"] for s in snaps.values()),
            "partitions": {
                tenant_id: {"quota_bytes": s["capacity_bytes"],
                            "size_bytes": s["size_bytes"]}
                for tenant_id, s in snaps.items()},
        }
