"""Invariant library: the properties every simulated run must uphold.

Two classes, mirroring the reference's DST checks and TLA+ safety
properties:

- **per-op invariants** — checked right after the op that can violate them
  (cache≡cold on every search, conservation on every merge, bounds on
  every autoscaler tick, completeness on every plan);
- **ledger invariants** — checked at quiescence against the ground-truth
  oracle (`SimCluster.searchable_ns`): exactly-once publish (no doc
  appears in two published splits), zero-loss WAL failover (every acked
  doc is searchable), and tenant isolation over the full corpus.

A failed check appends a `Violation` — a JSON-safe record naming the
invariant, the step, and enough detail to read the shrunk artifact
without re-running it. Checks must themselves be deterministic: details
are built from sorted/aggregated values only (never thread-ordered
observations — e.g. leaf deadline checks aggregate to a boolean, because
fan-out dispatch order is not part of the simulation's determinism
contract, only its outcomes are).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# name -> one-line description; the CLI and docs render this catalog
INVARIANTS: dict[str, str] = {
    "exactly_once_publish":
        "no doc is published into more than one live split "
        "(checkpoint CAS ⇒ at-most-once drain per WAL position)",
    "zero_loss_wal_failover":
        "every acked doc is searchable after quiescence, across any "
        "sequence of kills, promotions, and restarts",
    "cache_cold_equivalence":
        "a repeated query served warm returns exactly the cold result",
    "tenant_isolation":
        "a query against one index never returns another tenant's docs",
    "merge_input_conservation":
        "a merge preserves the published doc count (inputs' docs == "
        "output's docs)",
    "deadline_monotonicity":
        "every leaf request carries a deadline no larger than the root's "
        "remaining budget (budgets shrink down the tree, never grow)",
    "autoscaler_bounds":
        "the offload pool size stays within [min_workers, max_workers] "
        "after every tick",
    "plan_completeness":
        "the physical indexing plan assigns every task exactly once, "
        "only to alive nodes",
    "cancel_responsiveness":
        "a query cancelled before it started returns a typed cancelled "
        "response with zero hits and leaves no registry entry behind",
}

# slack for deadline comparisons: serialization rounds to whole millis
_DEADLINE_SLACK_MS = 5


@dataclass
class Violation:
    invariant: str
    step: int
    details: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {"invariant": self.invariant, "step": self.step,
                "details": self.details}

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Violation":
        return cls(invariant=str(data["invariant"]), step=int(data["step"]),
                   details=dict(data.get("details", {})))


class InvariantChecker:
    def __init__(self, enabled: tuple[str, ...],
                 expected_index_of_n: dict[int, str]):
        unknown = sorted(set(enabled) - set(INVARIANTS))
        if unknown:
            raise ValueError(f"unknown invariants: {unknown}")
        self.enabled = set(enabled)
        self.expected_index_of_n = expected_index_of_n
        self.violations: list[Violation] = []
        self._deadline_cursor = 0

    def _on(self, name: str) -> bool:
        return name in self.enabled

    def _fail(self, name: str, step: int, **details: Any) -> None:
        self.violations.append(Violation(name, step, details))

    # --- per-op ------------------------------------------------------------
    def after_op(self, cluster, op: dict[str, Any], result: Any,
                 step: int) -> None:
        kind = op["kind"]
        if kind == "search":
            self._check_search(op, result, step, cluster)
        elif kind == "merge":
            self._check_merge(result, step)
        elif kind == "autoscale":
            self._check_autoscale(result, step)
        elif kind == "plan":
            self._check_plan(result, step)
        elif kind == "cancel":
            self._check_cancel(result, step)
        elif kind == "dashboard":
            # every concurrent panel is audited exactly like a standalone
            # search (cold≡warm, tenant isolation, deadlines); the shed
            # panel is audited like a standalone pre-cancelled query
            for outs in (result.get("panels") or ()):
                if outs is not None:
                    self._check_search(op, outs, step, cluster)
            if result.get("cancelled_panel") is not None:
                self._check_cancel(result["cancelled_panel"], step)

    def _check_search(self, op: dict[str, Any], outs: list[dict[str, Any]],
                      step: int, cluster) -> None:
        complete = [o for o in outs if o.get("complete")]
        if self._on("cache_cold_equivalence") and len(complete) >= 2:
            cold, warm = complete[0], complete[1]
            if (cold["ns"] != warm["ns"]
                    or cold["num_hits"] != warm["num_hits"]):
                self._fail("cache_cold_equivalence", step,
                           index=op["index"],
                           cold={"ns": cold["ns"],
                                 "num_hits": cold["num_hits"]},
                           warm={"ns": warm["ns"],
                                 "num_hits": warm["num_hits"]})
        if self._on("tenant_isolation"):
            for out in outs:
                leaked = sorted(
                    n for n in out.get("ns", ())
                    if self.expected_index_of_n.get(n) != op["index"])
                if leaked:
                    self._fail("tenant_isolation", step, index=op["index"],
                               leaked_ns=leaked)
                    break
        if self._on("deadline_monotonicity"):
            budget_ms = int(cluster.scenario.search_timeout_secs * 1000)
            observations = cluster.network.deadline_observations
            window = observations[self._deadline_cursor:]
            self._deadline_cursor = len(observations)
            bad = sorted({
                node_id for node_id, deadline in window
                if deadline is None
                or deadline > budget_ms + _DEADLINE_SLACK_MS})
            if bad:
                self._fail("deadline_monotonicity", step, index=op["index"],
                           budget_ms=budget_ms, nodes=bad)

    def _check_merge(self, result: dict[str, Any], step: int) -> None:
        if not self._on("merge_input_conservation"):
            return
        if result.get("merged") and result["docs_before"] != result["docs_after"]:
            self._fail("merge_input_conservation", step,
                       docs_before=result["docs_before"],
                       docs_after=result["docs_after"])

    def _check_autoscale(self, result: dict[str, Any], step: int) -> None:
        if not self._on("autoscaler_bounds"):
            return
        size = result["pool_size"]
        if not result["min"] <= size <= result["max"]:
            self._fail("autoscaler_bounds", step, pool_size=size,
                       min=result["min"], max=result["max"])

    def _check_cancel(self, result: dict[str, Any], step: int) -> None:
        """A pre-cancelled query handle must never produce hits (the
        per-split cancel check runs before any device work), and the
        registry entry must be gone once the search returns — a leaked
        token would pin the next query under the same handle. With no
        published splits yet the response is trivially complete (zero
        splits to cancel), so `cancelled` is only required once the
        query had work to cut short."""
        if not self._on("cancel_responsiveness"):
            return
        if "error" in result:
            return  # typed failure (e.g. no alive nodes): nothing to audit
        problems = {}
        if result.get("num_hits"):
            problems["num_hits"] = result["num_hits"]
        if result.get("had_splits") and not result.get("cancelled"):
            problems["uncancelled_with_splits"] = True
        if not result.get("registry_drained"):
            problems["registry_leak"] = True
        if problems:
            self._fail("cancel_responsiveness", step, **problems)

    def _check_plan(self, result: dict[str, Any], step: int) -> None:
        if not self._on("plan_completeness"):
            return
        counts = result["assignments"]
        problems = {}
        missing = result["num_tasks"] - sum(counts.values())
        duplicated = sorted(k for k, c in counts.items() if c > 1)
        if missing:
            problems["unassigned_tasks"] = missing
        if duplicated:
            problems["duplicated_tasks"] = duplicated
        if result["assigned_to_dead"]:
            problems["assigned_to_dead"] = result["assigned_to_dead"]
        if problems:
            self._fail("plan_completeness", step, **problems)

    # --- ledger (quiescence) -----------------------------------------------
    def at_quiescence(self, cluster, step: int) -> None:
        for index_id in cluster.scenario.indexes:
            searchable = cluster.searchable_ns(index_id)
            if self._on("exactly_once_publish"):
                dups = sorted({n for n in searchable
                               if searchable.count(n) > 1})
                if dups:
                    self._fail("exactly_once_publish", step, index=index_id,
                               duplicated_ns=dups[:50],
                               num_duplicated=len(dups))
            if self._on("zero_loss_wal_failover"):
                lost = sorted(set(cluster.acked[index_id]) - set(searchable))
                if lost:
                    self._fail("zero_loss_wal_failover", step,
                               index=index_id, lost_ns=lost[:50],
                               num_lost=len(lost),
                               num_acked=len(cluster.acked[index_id]),
                               num_searchable=len(searchable))
            if self._on("tenant_isolation"):
                leaked = sorted(
                    {n for n in searchable
                     if self.expected_index_of_n.get(n) != index_id})
                if leaked:
                    self._fail("tenant_isolation", step, index=index_id,
                               leaked_ns=leaked[:50])
