"""Scroll contexts: stateful pagination.

Role of the reference's `ScrollContext` + cluster KV
(`scroll_context.rs:51,146`, `docs/internals/scroll.md`): the first scroll
request caches a window of partial hits under a scroll id; subsequent
requests page through the cache and refill it with search_after when
exhausted. The KV store here is in-process with TTL (the reference
replicates it to affinity nodes via put_kv — the replication hook is the
store itself, swappable for a replicated one).
"""

from __future__ import annotations

import base64
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from .models import PartialHit, SearchRequest
from ..common import sync

DEFAULT_TTL_SECS = 300
CACHE_WINDOW = 1000


@dataclass
class ScrollContext:
    request: SearchRequest
    cached_hits: list[Any]  # fetched Hits (docs included), global rank order
    cursor: int = 0
    total_hits: int = 0
    created_at: float = field(default_factory=time.monotonic)
    ttl_secs: float = DEFAULT_TTL_SECS

    @property
    def expired(self) -> bool:
        return time.monotonic() - self.created_at > self.ttl_secs


class ScrollStore:
    def __init__(self) -> None:
        self._contexts: dict[str, ScrollContext] = {}
        self._lock = sync.lock("ScrollStore._lock")

    def put(self, context: ScrollContext) -> str:
        scroll_id = base64.urlsafe_b64encode(uuid.uuid4().bytes).decode().rstrip("=")
        with self._lock:
            self._gc()
            self._contexts[scroll_id] = context
        return scroll_id

    def put_with_id(self, scroll_id: str, context: ScrollContext) -> None:
        """Install a replicated context under its existing id (the
        affinity-replica side of put_kv)."""
        with self._lock:
            self._gc()
            self._contexts[scroll_id] = context

    def get(self, scroll_id: str) -> Optional[ScrollContext]:
        with self._lock:
            context = self._contexts.get(scroll_id)
            if context is not None and context.expired:
                del self._contexts[scroll_id]
                return None
            return context

    def delete(self, scroll_id: str) -> bool:
        with self._lock:
            return self._contexts.pop(scroll_id, None) is not None

    def _gc(self) -> None:
        dead = [k for k, c in self._contexts.items() if c.expired]
        for k in dead:
            del self._contexts[k]


# --------------------------------------------------------------------------
# serialization (cluster-KV replication of scroll contexts — reference:
# put_kv to best-affinity nodes, scroll_context.rs:146)

def context_to_dict(context: ScrollContext) -> dict:
    return {
        "request": context.request.to_dict(),
        "cached_hits": [
            {"doc": h.doc, "score": h.score, "sort_values": h.sort_values,
             "split_id": h.split_id, "doc_id": h.doc_id,
             "snippets": h.snippets}
            for h in context.cached_hits],
        "cursor": context.cursor,
        "total_hits": context.total_hits,
        "ttl_secs": context.ttl_secs,
        "age_secs": time.monotonic() - context.created_at,
    }


def context_from_dict(d: dict) -> ScrollContext:
    from .models import Hit, SearchRequest
    return ScrollContext(
        request=SearchRequest.from_dict(d["request"]),
        cached_hits=[Hit(doc=h["doc"], score=h.get("score"),
                         sort_values=h.get("sort_values") or [],
                         split_id=h.get("split_id", ""),
                         doc_id=h.get("doc_id", 0),
                         snippets=h.get("snippets"))
                     for h in d["cached_hits"]],
        cursor=d.get("cursor", 0),
        total_hits=d.get("total_hits", 0),
        created_at=time.monotonic() - d.get("age_secs", 0.0),
        ttl_secs=d.get("ttl_secs", DEFAULT_TTL_SECS),
    )
