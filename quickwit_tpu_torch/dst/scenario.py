"""Scenario DSL: declarative workload + invariant selection for one run.

A `Scenario` declares the cluster shape (nodes, indexes), the workload mix
(ingest / drain / search / merge / membership churn / autoscaler and
control-plane ticks as weighted op kinds), the fault plan, and which
invariants to check. `materialize(seed)` expands it into the explicit,
JSON-safe op list one run executes — the op list IS the interleaving: the
scheduler executes it in order, so storing it in a replay artifact (and
deleting entries from it during shrinking) fully pins a run.

Materialization tracks its own alive-set so churn ops are always
executable (never kill the last node, never restart a live one); the
executor mirrors the same bookkeeping, keeping op semantics identical
between generation and replay.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

from ..common.faults import FaultRule

DEFAULT_WEIGHTS: dict[str, int] = {
    "ingest": 6,
    "drain": 4,
    "search": 5,
    "merge": 1,
    "kill": 2,
    "restart": 2,
    "autoscale": 1,
    "plan": 1,
    # a search whose handle was cancelled before the query started (the
    # REST DELETE racing ahead of the query): weight 0 by default so
    # pre-existing scenarios' op streams (and replay artifacts) stay
    # byte-identical — materialize() only draws kinds with weight > 0
    "cancel": 0,
    # N concurrent shape-compatible panel searches through ONE node — the
    # workload the query batcher stacks into a single device dispatch
    # (search/batcher.py QueryGroupPlanner). Weight 0 by default for the
    # same replay-stability reason as "cancel".
    "dashboard": 0,
}

ALL_INVARIANTS = (
    "exactly_once_publish",
    "zero_loss_wal_failover",
    "cache_cold_equivalence",
    "tenant_isolation",
    "merge_input_conservation",
    "deadline_monotonicity",
    "autoscaler_bounds",
    "plan_completeness",
    "cancel_responsiveness",
)


@dataclass(frozen=True)
class Scenario:
    name: str
    nodes: int = 2
    indexes: tuple[str, ...] = ("tenant-a", "tenant-b")
    steps: int = 40
    docs_min: int = 1
    docs_max: int = 6
    # virtual seconds advanced before each op: > the metastore polling TTL
    # the cluster uses, so cross-node publishes become visible step-over-step
    step_secs: float = 7.5
    search_timeout_secs: float = 5.0
    replication: bool = True
    # elastic leaf-search offload at production fan-out: each node gets an
    # in-process worker fleet and `max_local_splits=1`, so every multi-split
    # leaf request exercises the dispatcher's thread spawn / steal / hedge
    # machinery concurrently with the cache tiers — the interleaving
    # surface the qwrace `--pct` schedule exploration randomizes
    offload: bool = False
    # mix in fast-field-sorted searches (sort by "ts"/"n" desc): they arm
    # threshold pruning, whose shared ThresholdBox the local execute loop
    # and the offload dispatch thread then touch concurrently. Opt-in so
    # pre-existing scenarios' op streams (and their replay artifacts)
    # stay byte-identical.
    sorted_searches: bool = False
    weights: dict[str, int] = field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS))
    invariants: tuple[str, ...] = ALL_INVARIANTS
    fault_rules: tuple[FaultRule, ...] = ()

    # --- materialization ---------------------------------------------------
    def _rng(self, seed: int) -> random.Random:
        digest = hashlib.blake2b(f"{self.name}:{seed}".encode(),
                                 digest_size=8).digest()
        return random.Random(int.from_bytes(digest, "big"))

    def materialize(self, seed: int) -> list[dict[str, Any]]:
        """Expand into the explicit op list for `seed`. Ops are JSON-safe
        dicts; doc payloads carry globally unique sequence numbers `n`
        (disjoint across indexes by construction — the tenant-isolation
        oracle keys on them)."""
        rng = self._rng(seed)
        node_ids = [f"sim-{i}" for i in range(self.nodes)]
        alive = set(node_ids)
        kinds = [k for k, w in sorted(self.weights.items()) if w > 0]
        weights = [self.weights[k] for k in kinds]
        ops: list[dict[str, Any]] = []
        next_n = 0
        for _ in range(self.steps):
            kind = rng.choices(kinds, weights=weights, k=1)[0]
            if kind == "kill" and len(alive) <= 1:
                kind = "search"  # never kill the last node
            if kind == "restart" and len(alive) == len(node_ids):
                kind = "drain"  # nothing to restart
            if kind == "ingest":
                node = rng.choice(sorted(alive))
                index_id = rng.choice(self.indexes)
                count = rng.randint(self.docs_min, self.docs_max)
                docs = [{"n": next_n + i,
                         "ts": 1_600_000_000 + next_n + i,
                         "body": f"doc {index_id} {next_n + i}"}
                        for i in range(count)]
                next_n += count
                ops.append({"kind": "ingest", "node": node,
                            "index": index_id, "docs": docs})
            elif kind == "drain":
                ops.append({"kind": "drain",
                            "node": rng.choice(sorted(alive))})
            elif kind == "search":
                op = {"kind": "search",
                      "index": rng.choice(self.indexes),
                      "max_hits": rng.choice((10, 100, 1000))}
                if self.sorted_searches:
                    sort = rng.choice((None, "ts", "n"))
                    if sort is not None:
                        op["sort"] = sort
                ops.append(op)
            elif kind == "merge":
                ops.append({"kind": "merge", "node": rng.choice(sorted(alive)),
                            "index": rng.choice(self.indexes)})
            elif kind == "kill":
                node = rng.choice(sorted(alive))
                alive.discard(node)
                ops.append({"kind": "kill", "node": node})
            elif kind == "restart":
                node = rng.choice(sorted(set(node_ids) - alive))
                alive.add(node)
                ops.append({"kind": "restart", "node": node})
            elif kind == "autoscale":
                ops.append({"kind": "autoscale",
                            "queue_depth": rng.randint(0, 64)})
            elif kind == "plan":
                ops.append({"kind": "plan"})
            elif kind == "cancel":
                # same shape knobs as a search; the executor cancels the
                # query handle before the query starts, so the run is
                # deterministic: the cancel always lands first
                ops.append({"kind": "cancel",
                            "index": rng.choice(self.indexes),
                            "max_hits": rng.choice((10, 100, 1000))})
            elif kind == "dashboard":
                # panels share structure (same sort/max_hits, Range on the
                # timestamp fast field) but carry distinct window bounds:
                # distinct queries, one group key. cancel_panel sheds one
                # rider's handle up front — the post-formation masking path
                ops.append({"kind": "dashboard",
                            "index": rng.choice(self.indexes),
                            "max_hits": rng.choice((10, 100)),
                            "panels": rng.randint(2, 4),
                            "cancel_panel": rng.random() < 0.3})
        return ops

    # --- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        out = asdict(self)
        out["indexes"] = list(self.indexes)
        out["invariants"] = list(self.invariants)
        out["fault_rules"] = [asdict(r) for r in self.fault_rules]
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Scenario":
        return cls(
            name=data["name"],
            nodes=int(data.get("nodes", 2)),
            indexes=tuple(data.get("indexes", ("tenant-a", "tenant-b"))),
            steps=int(data.get("steps", 40)),
            docs_min=int(data.get("docs_min", 1)),
            docs_max=int(data.get("docs_max", 6)),
            step_secs=float(data.get("step_secs", 7.5)),
            search_timeout_secs=float(data.get("search_timeout_secs", 5.0)),
            replication=bool(data.get("replication", True)),
            offload=bool(data.get("offload", False)),
            sorted_searches=bool(data.get("sorted_searches", False)),
            weights={str(k): int(v)
                     for k, v in data.get("weights", DEFAULT_WEIGHTS).items()},
            invariants=tuple(data.get("invariants", ALL_INVARIANTS)),
            fault_rules=tuple(FaultRule(**r)
                              for r in data.get("fault_rules", ())),
        )


def _default_fault_rules() -> tuple[FaultRule, ...]:
    """The mixed scenario's chaos plan: occasional storage latency, rare
    retryable leaf/storage errors, rare replication failures — all survivable
    by design (retries, rollback, failover), so a 100+-seed sweep passes."""
    return (
        FaultRule(operation="storage.get_slice", kind="latency",
                  probability=0.05, latency_secs=0.2),
        FaultRule(operation="net.leaf_search@*", kind="error",
                  probability=0.04),
        FaultRule(operation="ingest.replicate", kind="error",
                  probability=0.05),
        FaultRule(operation="wal.fsync", kind="latency",
                  probability=0.05, latency_secs=0.05),
    )


SCENARIOS: dict[str, Scenario] = {
    # tier-1 smoke: small, fast, three core invariants, light faults
    "smoke": Scenario(
        name="smoke", nodes=2, steps=18, step_secs=7.5,
        indexes=("tenant-a", "tenant-b"),
        invariants=("exactly_once_publish", "zero_loss_wal_failover",
                    "tenant_isolation"),
        fault_rules=(FaultRule(operation="ingest.replicate", kind="error",
                               probability=0.05),),
    ),
    # the acceptance scenario: mixed ingest/search/failover, full invariant
    # set, the default chaos plan
    "mixed": Scenario(
        name="mixed", nodes=3, steps=40,
        indexes=("tenant-a", "tenant-b"),
        invariants=ALL_INVARIANTS,
        fault_rules=_default_fault_rules(),
    ),
    # offload dispatch + cache-tier interleavings at production fan-out
    # (ROADMAP item 5's named headroom): every node runs an in-process
    # worker fleet with max_local_splits=1, so multi-split searches drive
    # the dispatcher's spawn/steal/hedge threads against the shared cache
    # tiers. Under `dst sweep --pct` the qwrace scheduler randomizes the
    # thread interleavings; without it the run stays a concurrency smoke.
    # single node: the whole published split set lands in ONE leaf request,
    # so the offload cut (max_local_splits=1) reliably fans the cold tail
    # out over the in-process worker fleet
    # the cancel weight mixes pre-cancelled query handles into the same
    # stream: the typed-cancelled path (registry adopt, per-split cancel
    # checks, batcher bail-out) runs against the offload dispatcher and
    # cache tiers, and cancel_responsiveness audits every one of them
    "fanout": Scenario(
        name="fanout", nodes=1, steps=30,
        indexes=("tenant-a", "tenant-b"),
        offload=True, replication=False, sorted_searches=True,
        weights={"ingest": 8, "drain": 6, "search": 8, "merge": 1,
                 "kill": 0, "restart": 0, "autoscale": 2, "plan": 0,
                 "cancel": 2, "dashboard": 2},
        invariants=("exactly_once_publish", "tenant_isolation",
                    "cache_cold_equivalence", "autoscaler_bounds",
                    "cancel_responsiveness"),
    ),
}
