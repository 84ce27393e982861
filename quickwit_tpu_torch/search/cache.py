"""Leaf-search result cache.

Role of the reference's `LeafSearchCache` (`leaf_cache.rs:26`): memoizes one
split's LeafSearchResponse keyed by (split id, canonicalized request). The
request's time range is clamped to the split's own time range before keying
(the reference's `remove_redundant_timestamp_range`, `leaf.rs:1048`), so
rolling time windows that fully cover an immutable split hit the same entry.

`canonical_filter_digest` is the sibling key for the mask/partial-agg tiers
(search/mask_cache.py, search/agg_cache.py): it hashes only the
result-FILTERING fields (query AST + rebased time bounds) so every query
variant sharing a filter — different top-K, sort, aggs, pagination — lands
on one entry per split.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from typing import Any, Optional

from ..observability.metrics import (
    LEAF_CACHE_EVICTED_BYTES_TOTAL, LEAF_CACHE_HITS_TOTAL,
    LEAF_CACHE_MISSES_TOTAL,
)
from .models import LeafSearchResponse, SearchRequest
from .tenant_cache import TenantPartitionedCache


def _rebase_time_bounds(request: SearchRequest,
                        split_time_range: Optional[tuple[int, int]]
                        ) -> tuple[Optional[int], Optional[int]]:
    """The reference's `remove_redundant_timestamp_range`: a bound the
    split's own time range can't exceed hashes as absent, so differently-
    bounded requests share entries when the split can't tell them apart."""
    start, end = request.start_timestamp, request.end_timestamp
    if split_time_range is not None:
        lo, hi = split_time_range
        # end is exclusive; a bound outside the split's range is redundant
        if start is not None and start <= lo:
            start = None
        if end is not None and end > hi:
            end = None
    return start, end


def canonical_filter_digest(
    request: SearchRequest,
    split_time_range: Optional[tuple[int, int]] = None,
) -> str:
    """Digest of the request's result-FILTERING fields only: the query AST
    plus the split-rebased time bounds. Deliberately excludes top-K/offset,
    sort, aggs, and search_after — none of them change WHICH docs match, so
    a predicate mask or partial-agg state keyed by this digest is reusable
    across all those variants (the classic query-reuse win). Soundness
    leans on splits being immutable: a (split, digest) pair can never go
    stale."""
    start, end = _rebase_time_bounds(request, split_time_range)
    payload = {
        "query": request.query_ast.to_dict(),
        "start": start,
        "end": end,
    }
    return hashlib.blake2b(
        json.dumps(payload, sort_keys=True).encode(),
        digest_size=16).hexdigest()


def canonical_request_key(
    split_id: str,
    request: SearchRequest,
    split_time_range: Optional[tuple[int, int]] = None,
) -> str:
    """Split-local cache key: the request's result-affecting fields plus the
    time filter REBASED against the split's own time range (a bound the
    split can't exceed hashes as absent, so differently-bounded requests
    share entries when the split can't tell them apart).

    Threshold-pruning downgrade audit (search/pruning.downgrade_to_count):
    a count-only downgrade of a top-K request MUST NOT alias the full
    request's entry — and cannot, because the downgrade changes at least
    `max_hits + start_offset` (→ 0) and the normalized `sort` (→ _doc asc),
    both hashed below. Threshold-pushdown responses themselves are never
    cached (their hit lists are truncated); see _execute_per_split."""
    start, end = _rebase_time_bounds(request, split_time_range)
    payload = {
        "query": request.query_ast.to_dict(),
        "max_hits": request.max_hits + request.start_offset,
        "sort": [s.to_dict() for s in request.sort_fields],
        "aggs": request.aggs,
        "start": start,
        "end": end,
        "search_after": request.search_after,
    }
    digest = hashlib.blake2b(
        json.dumps(payload, sort_keys=True).encode(), digest_size=16).hexdigest()
    return f"{split_id}:{digest}"


class LeafSearchCache:
    """Tier: whole-response memoization, tenant-partitioned (Tier C —
    search/tenant_cache.py). Stored pickled, so every hit hands the
    collector a FRESH response object (the merge mutates agg states)."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        self._cache = TenantPartitionedCache(
            capacity_bytes,
            on_evict=LEAF_CACHE_EVICTED_BYTES_TOTAL.inc,
            tier="leaf_response")

    def get(self, key: str) -> Optional[LeafSearchResponse]:
        raw = self._cache.get(key)
        if raw is None:
            LEAF_CACHE_MISSES_TOTAL.inc()
            return None
        LEAF_CACHE_HITS_TOTAL.inc()
        return pickle.loads(raw)

    def put(self, key: str, response: LeafSearchResponse) -> None:
        self._cache.put(key, pickle.dumps(response))

    @property
    def stats(self) -> dict[str, Any]:
        return self._cache.stats
