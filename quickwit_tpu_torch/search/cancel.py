"""Live-query registry for mid-flight cancellation.

Counterpart of the JAX package's `search/cancel.py`. A search that carries
a `query_id` registers its CancellationToken here for its whole lifetime,
and a cancel request (the REST layer's `DELETE /api/v1/search/<query_id>`)
flips the token. The chunked leaf scan (search/chunkexec.py) observes the
token at its next chunk boundary, so a cancel lands within one chunk of
device work rather than after the full split.

Registration is last-writer-wins per query_id: a retried query under the
same handle replaces the stale token (the old attempt is already dead or
about to observe its own token). Entries are unregistered in a `finally`
on the search path, so the registry only ever holds in-flight queries.
"""

from __future__ import annotations

from typing import Optional

from ..common import sync
from ..common.deadline import CancellationToken
from ..observability import flight


class QueryCancelRegistry:
    """query_id -> CancellationToken for every in-flight search that opted
    into cancellation. All methods are safe from any thread (the cancel
    request races the searching thread by design)."""

    def __init__(self) -> None:
        self._lock = sync.lock("QueryCancelRegistry._lock")
        self._tokens: dict[str, CancellationToken] = {}

    def register(self, query_id: str, token: CancellationToken) -> None:
        with self._lock:
            self._tokens[query_id] = token

    def unregister(self, query_id: str, token: CancellationToken) -> None:
        """Remove `query_id` only if it still maps to `token` — a retry that
        re-registered under the same handle must not be evicted by the
        first attempt's cleanup."""
        with self._lock:
            if self._tokens.get(query_id) is token:
                del self._tokens[query_id]

    def cancel(self, query_id: str, reason: str = "cancelled by request") -> bool:
        """Flip the token for `query_id`. Returns False when no such query
        is in flight (already finished, never registered, or unknown id).
        Counts nothing: the cancel request's handler counts each request
        in qw_search_cancel_total, live or unknown."""
        with self._lock:
            token = self._tokens.get(query_id)
        if token is None:
            return False
        token.cancel(reason)
        flight.emit("query.cancel", query_id=query_id,
                    attrs={"reason": reason})
        return True

    def get(self, query_id: str) -> Optional[CancellationToken]:
        with self._lock:
            return self._tokens.get(query_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tokens)


# Process-wide registry: one process serves many indexes, and a query_id
# names a query, not an index, so one registry is the right scope.
CANCEL_REGISTRY = QueryCancelRegistry()
