"""Storage caches.

Role of the reference's cache hierarchy (`quickwit-storage/src/cache/`):
- `MemorySizedCache`: LRU bounded by total byte size (footer / fast-field
  caches).
- `ByteRangeCache`: caches object byte ranges with range-merge lookups, the
  short-lived per-leaf-search cache that deduplicates warmup reads.
- `CachingStorage`: a Storage wrapper consulting a cache before the backend
  (role of `CachingDirectory` one level up).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional

from ..common import sync
from .base import Storage


class MemorySizedCache:
    """Byte-size-bounded LRU: key -> bytes.

    `on_evict(nbytes)` fires (outside the lock) whenever capacity pressure
    drops entries — the hierarchical leaf caches route it into their
    `qw_*_cache_evicted_bytes_total` counters. `resize` re-bounds a live
    cache (tenant-quota rebalancing, search/tenant_cache.py), evicting
    LRU-first down to the new capacity."""

    def __init__(self, capacity_bytes: int, on_evict=None):
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict[str, bytes] = OrderedDict()
        self._size = 0
        self._lock = sync.lock("MemorySizedCache._lock")
        self.hits = 0
        self.misses = 0
        self.evicted_bytes = 0
        self._on_evict = on_evict

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            sync.note_write(self, "entries")
            data = self._entries.get(key)
            if data is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return data

    def _evict_to_capacity_locked(self) -> int:
        dropped = 0
        while self._size > self.capacity_bytes and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self._size -= len(evicted)
            dropped += len(evicted)
        if dropped:
            self.evicted_bytes += dropped
        return dropped

    def _notify_evicted(self, dropped: int) -> None:
        if dropped and self._on_evict is not None:
            self._on_evict(dropped)

    def put(self, key: str, data: bytes) -> None:
        if len(data) > self.capacity_bytes:
            return  # reference behavior: items larger than the cache are not cached
        with self._lock:
            sync.note_write(self, "entries")
            old = self._entries.pop(key, None)
            if old is not None:
                self._size -= len(old)
            self._entries[key] = data
            self._size += len(data)
            dropped = self._evict_to_capacity_locked()
        self._notify_evicted(dropped)

    def delete(self, key: str) -> None:
        """Drop one entry (not counted as capacity eviction — used by the
        corruption chaos path, where the caller already accounts the miss)."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._size -= len(old)

    def resize(self, capacity_bytes: int) -> None:
        with self._lock:
            sync.note_write(self, "entries")
            self.capacity_bytes = capacity_bytes
            dropped = self._evict_to_capacity_locked()
        self._notify_evicted(dropped)

    def clear(self) -> int:
        """Forced full eviction (cache.evict chaos point); returns and
        counts the dropped bytes."""
        with self._lock:
            dropped = self._size
            self._entries.clear()
            self._size = 0
            if dropped:
                self.evicted_bytes += dropped
        self._notify_evicted(dropped)
        return dropped

    @property
    def size_bytes(self) -> int:
        # under the lock: `_size` is written by concurrent put/evict and a
        # torn read would leak into quota math (found by qwrace)
        with self._lock:
            sync.note_read(self, "entries")
            return self._size

    def stats_snapshot(self) -> dict:
        """Counters + size read atomically under the cache lock — the
        aggregation path must not race the hit/miss increments."""
        with self._lock:
            sync.note_read(self, "entries")
            return {"hits": self.hits, "misses": self.misses,
                    "size_bytes": self._size,
                    "evicted_bytes": self.evicted_bytes,
                    "capacity_bytes": self.capacity_bytes}


class ByteRangeCache:
    """Caches (path, [start,end)) ranges; a get is served if any cached range
    fully covers it. Ranges are stored per path sorted by start, adjacent/
    overlapping inserts are merged (reference: `byte_range_cache.rs`)."""

    def __init__(self) -> None:
        self._ranges: dict[str, list[tuple[int, int, bytes]]] = {}
        self._lock = sync.lock("ByteRangeCache._lock")
        self.hits = 0
        self.misses = 0

    def get(self, path: str, start: int, end: int) -> Optional[bytes]:
        with self._lock:
            sync.note_write(self, "ranges")
            for r_start, r_end, data in self._ranges.get(path, ()):
                if r_start <= start and end <= r_end:
                    self.hits += 1
                    return data[start - r_start:end - r_start]
            self.misses += 1
            return None

    def put(self, path: str, start: int, data: bytes) -> None:
        end = start + len(data)
        with self._lock:
            sync.note_write(self, "ranges")
            ranges = self._ranges.setdefault(path, [])
            merged_start, merged_end, merged = start, end, data
            keep: list[tuple[int, int, bytes]] = []
            for r_start, r_end, r_data in ranges:
                if r_end < merged_start or r_start > merged_end:
                    keep.append((r_start, r_end, r_data))
                    continue
                # overlap/adjacency: merge
                if r_start < merged_start:
                    merged = r_data[: merged_start - r_start] + merged
                    merged_start = r_start
                if r_end > merged_end:
                    merged = merged + r_data[len(r_data) - (r_end - merged_end):]
                    merged_end = r_end
            keep.append((merged_start, merged_end, merged))
            keep.sort(key=lambda r: r[0])
            self._ranges[path] = keep

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._ranges.pop(path, None)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return sum(len(d) for ranges in self._ranges.values() for _, _, d in ranges)


class CachingStorage(Storage):
    """Read-through Storage wrapper over a ByteRangeCache."""

    def __init__(self, inner: Storage, cache: Optional[ByteRangeCache] = None):
        super().__init__(inner.uri)
        self.inner = inner
        self.cache = cache or ByteRangeCache()

    def put(self, path: str, payload: bytes) -> None:
        self.inner.put(path, payload)
        self.cache.invalidate(path)

    def delete(self, path: str) -> None:
        self.inner.delete(path)
        self.cache.invalidate(path)

    def bulk_delete(self, paths: Iterable[str]) -> None:
        self.inner.bulk_delete(paths)

    def get_slice(self, path: str, start: int, end: int) -> bytes:
        cached = self.cache.get(path, start, end)
        if cached is not None:
            return cached
        data = self.inner.get_slice(path, start, end)
        self.cache.put(path, start, data)
        return data

    def get_all(self, path: str) -> bytes:
        data = self.inner.get_all(path)
        self.cache.put(path, 0, data)
        return data

    def file_num_bytes(self, path: str) -> int:
        return self.inner.file_num_bytes(path)

    def list_files(self) -> list[str]:
        return self.inner.list_files()
