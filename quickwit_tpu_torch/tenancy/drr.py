"""Weighted deficit-round-robin scheduler for admission tickets.

Replaces the single FIFO ticket deque of `search/admission.py` with
per-tenant FIFO sub-queues served deficit-round-robin (Shreedhar &
Varghese): each visit tops a tenant's deficit up by `quantum * weight`,
and the tenant at the front of the round-robin ring is granted the head
of its queue once its deficit covers the ticket's byte cost. Over a
contended interval each tenant's admitted bytes converge to its weight
share, yet within one tenant order stays strictly FIFO.

Two properties the old FIFO queue guaranteed are preserved by
construction:

- **no starvation**: a waiting tenant's deficit grows by at least
  `quantum * weight` per ring revolution, so any finite-cost ticket is
  eventually granted — large requests cannot be starved by a stream of
  small ones (same argument as the old ticket queue, now per tenant);
- **single-tenant neutrality**: with one tenant the ring has one entry
  and grants degrade to exact FIFO — the scheduler with tenancy disabled
  is behaviorally the pre-tenancy scheduler.

NOT thread-safe: the caller (`HbmBudget`) already serializes on its
condition-variable lock, and a second lock here would only invite
lock-order bugs.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Optional

# Deficit top-up per visit for weight 1.0. Sized so a typical single-split
# staging footprint (tens of MB compact columns) is granted within a few
# ring revolutions.
DEFAULT_QUANTUM_BYTES = 64 << 20


class DrrTicket:
    __slots__ = ("seq", "tenant_id", "weight", "cost")

    def __init__(self, seq: int, tenant_id: str, weight: float, cost: int):
        self.seq = seq
        self.tenant_id = tenant_id
        self.weight = weight
        self.cost = cost

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DrrTicket(seq={self.seq}, tenant={self.tenant_id!r}, "
                f"cost={self.cost})")


class DrrScheduler:
    def __init__(self, quantum_bytes: int = DEFAULT_QUANTUM_BYTES):
        self.quantum = quantum_bytes
        # Per-ticket scheduling cost floor. Deficit interleaving happens at
        # quantum granularity, so without a floor a stream of tiny tickets
        # rides one top-up for quantum/cost consecutive grants — tens of
        # thousands for KB-sized tickets — and every other tenant's latency
        # convoys behind the burst. Charging at least a quarter quantum per
        # grant (a per-query scheduling overhead, like a slot cost) bounds
        # any tenant's burst per ring visit to ~4x its weight; tickets at or
        # above typical staging footprints are unaffected.
        self._min_cost = max(1, quantum_bytes // 4)
        self._seq = itertools.count()
        self._queues: dict[str, deque[DrrTicket]] = {}
        self._deficit: dict[str, float] = {}
        self._weights: dict[str, float] = {}
        self._ring: deque[str] = deque()
        # the ticket currently scheduled next; sticky until removed so a
        # grantee waiting for budget space keeps its turn (head-of-line
        # semantics identical to the old FIFO head)
        self._grant: Optional[DrrTicket] = None

    def enqueue(self, tenant_id: str, weight: float, cost: int) -> DrrTicket:
        ticket = DrrTicket(next(self._seq), tenant_id,
                           max(float(weight), 1e-3),
                           max(int(cost), self._min_cost))
        queue = self._queues.get(tenant_id)
        if queue is None:
            self._queues[tenant_id] = deque((ticket,))
            self._deficit[tenant_id] = 0.0
            self._ring.append(tenant_id)
        else:
            queue.append(ticket)
        # latest weight wins: a tenant's class can be reconfigured between
        # queries without draining its queue
        self._weights[tenant_id] = ticket.weight
        return ticket

    def head(self) -> Optional[DrrTicket]:
        """The ticket whose turn it is. Runs DRR visits until some tenant's
        deficit covers its queue head; each visit adds `quantum * weight`,
        so the loop terminates in at most `ceil(max_cost / quantum)`
        revolutions of the ring."""
        if self._grant is None and self._ring:
            while True:
                tenant_id = self._ring[0]
                candidate = self._queues[tenant_id][0]
                if self._deficit[tenant_id] >= candidate.cost:
                    self._grant = candidate
                    break
                self._deficit[tenant_id] += \
                    self.quantum * self._weights[tenant_id]
                self._ring.rotate(-1)
        return self._grant

    def remove(self, ticket: DrrTicket, served: bool) -> None:
        """Drop a ticket — `served=True` after a grant (charges the
        tenant's deficit), `served=False` on timeout/shed (no charge: the
        tenant got nothing). A tenant whose queue empties leaves the ring
        and forfeits accumulated deficit — idle tenants must not bank
        credit (standard DRR reset)."""
        queue = self._queues.get(ticket.tenant_id)
        if queue is None:
            return
        try:
            queue.remove(ticket)
        except ValueError:
            return
        if served:
            self._deficit[ticket.tenant_id] = max(
                0.0, self._deficit[ticket.tenant_id] - ticket.cost)
        if self._grant is ticket:
            self._grant = None
        if not queue:
            del self._queues[ticket.tenant_id]
            self._deficit.pop(ticket.tenant_id, None)
            self._weights.pop(ticket.tenant_id, None)
            try:
                self._ring.remove(ticket.tenant_id)
            except ValueError:  # pragma: no cover - ring mirrors _queues
                pass

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def waiting_by_tenant(self) -> dict[str, int]:
        return {tenant: len(queue)
                for tenant, queue in self._queues.items()}
