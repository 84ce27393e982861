"""Simulated network: the seam between the root and each node's services.

Layered over the in-process clients (`LocalSearchClient`) the way the
reference's DST wraps its RPC layer: every cross-node call goes through
`SimNetwork.call`, which models

- **partitions** — a partitioned node is unreachable (`ConnectionError`,
  which the root's retry machinery treats like any dead leaf);
- **latency and typed errors** — driven by the run's shared seeded
  `FaultInjector` under per-node op names (``net.leaf_search@sim-1``), so
  the fault schedule lives in the same replay-artifact plan as every
  other perturbation, and latency sleeps land on the virtual clock;
- **duplicate delivery** — a seeded per-(node, method) decision stream
  re-issues the call (read RPCs are idempotent by design; duplication
  exercises exactly that, plus the cache tiers);
- **deadline observation** — each leaf request's `deadline_millis` is
  recorded for the deadline-monotonicity invariant.

Reordering across calls is owned by the scheduler's op-list permutation,
not modeled per-packet: ops execute synchronously one at a time, so the
op order IS the delivery order.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional

from ..common.faults import FaultInjector


class SimNetwork:
    def __init__(self, injector: FaultInjector, seed: int,
                 duplicate_probability: float = 0.0):
        self.injector = injector
        self.seed = seed
        self.duplicate_probability = float(duplicate_probability)
        self._partitioned: set[str] = set()
        self._dup_occurrences: dict[str, int] = {}
        # (node_id, deadline_millis) per observed leaf_search dispatch,
        # in call order — consumed by the deadline-monotonicity invariant
        self.deadline_observations: list[tuple[str, Optional[int]]] = []

    # --- partitions --------------------------------------------------------
    def partition(self, node_id: str) -> None:
        self._partitioned.add(node_id)

    def heal(self, node_id: str) -> None:
        self._partitioned.discard(node_id)

    def is_partitioned(self, node_id: str) -> bool:
        return node_id in self._partitioned

    # --- delivery ----------------------------------------------------------
    def _should_duplicate(self, op: str) -> bool:
        if self.duplicate_probability <= 0.0:
            return False
        occurrence = self._dup_occurrences.get(op, 0) + 1
        self._dup_occurrences[op] = occurrence
        digest = hashlib.blake2b(
            f"dup:{self.seed}:{op}:{occurrence}".encode(),
            digest_size=8).digest()
        roll = int.from_bytes(digest, "big") / float(1 << 64)
        return roll < self.duplicate_probability

    def call(self, node_id: str, method: str,
             fn: Callable[[Any], Any], request: Any) -> Any:
        if node_id in self._partitioned:
            raise ConnectionError(f"simnet: {node_id} unreachable")
        if method == "leaf_search":
            self.deadline_observations.append(
                (node_id, getattr(request, "deadline_millis", None)))
        op = f"net.{method}@{node_id}"
        self.injector.perturb(op)
        result = fn(request)
        if self._should_duplicate(op):
            # deliver twice: the second response wins, as with an at-least-
            # once transport; a non-idempotent handler would diverge here
            result = fn(request)
        return result


class SimSearchClient:
    """Leaf-search client routed through the simulated network — the same
    surface as `LocalSearchClient`, so it plugs into `RootSearcher`."""

    def __init__(self, network: SimNetwork, node_id: str, inner: Any):
        self.network = network
        self.node_id = node_id
        self.inner = inner

    def leaf_search(self, request: Any) -> Any:
        return self.network.call(self.node_id, "leaf_search",
                                 self.inner.leaf_search, request)

    def fetch_docs(self, request: Any) -> Any:
        return self.network.call(self.node_id, "fetch_docs",
                                 self.inner.fetch_docs, request)
