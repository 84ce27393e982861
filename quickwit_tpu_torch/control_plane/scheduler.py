"""Control-plane indexing scheduler.

Role of the reference's `IndexingScheduler`
(`quickwit-control-plane/src/indexing_scheduler/mod.rs:111,360`): turn
the set of (index, source[, shard]) logical indexing tasks into a
`PhysicalIndexingPlan` assigning tasks to indexer nodes, then watch for
drift between the plan and what nodes report running.

The placement decision itself is delegated to the multi-phase solver
(`solver.py`, the analogue of `scheduling_logic.rs`): tasks are grouped
into uniform-load "sources" (index, source, weight), solved as a
`counts[indexer][source]` matrix starting FROM the previous solution
(stability), and the matrix is expanded back into concrete tasks with
shard-level stickiness — a task stays on its previous node whenever that
node still holds a slot for its group.

Carried over whole from the JAX package's `control_plane/scheduler.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .solver import NotEnoughCapacity, SchedulingProblem, solve

# millicpu ascribed to one unit of task weight (reference:
# `PIPELINE_FULL_CAPACITY` — one pipeline saturates 4 cpus; our weights
# are relative so the scale only matters for capacity accounting)
MILLICPU_PER_WEIGHT = 250
DEFAULT_INDEXER_MILLICPU = 4000


@dataclass(frozen=True)
class IndexingTask:
    index_uid: str
    source_id: str
    shard_id: Optional[str] = None
    weight: int = 1  # relative CPU weight (reference: load per pipeline)

    @property
    def key(self) -> tuple:
        return (self.index_uid, self.source_id, self.shard_id)

    @property
    def group(self) -> tuple:
        # solver "source": tasks of one source with one load level
        return (self.index_uid, self.source_id, self.weight)


@dataclass
class PhysicalIndexingPlan:
    assignments: dict[str, list[IndexingTask]] = field(default_factory=dict)

    def node_of(self, task: IndexingTask) -> Optional[str]:
        for node_id, tasks in self.assignments.items():
            if task in tasks:
                return node_id
        return None

    def tasks_for(self, node_id: str) -> list[IndexingTask]:
        return self.assignments.get(node_id, [])

    @property
    def num_tasks(self) -> int:
        return sum(len(t) for t in self.assignments.values())


class IndexingScheduler:
    def __init__(self, max_load_factor: float = 1.2,
                 indexer_millicpu: int = DEFAULT_INDEXER_MILLICPU):
        # headroom over the average load a node may carry before the
        # solver balances away from it (the solver's virtual capacity)
        self.max_load_factor = max_load_factor
        self.indexer_millicpu = indexer_millicpu
        self.last_plan = PhysicalIndexingPlan()

    def schedule(self, tasks: list[IndexingTask],
                 indexer_nodes: list[str],
                 affinities: Optional[dict[tuple, dict[str, int]]] = None,
                 ) -> PhysicalIndexingPlan:
        """Build the next physical plan; deterministic given inputs + the
        previous plan. `affinities` optionally maps a task group
        (index_uid, source_id, weight) to {node_id: score} — the
        reference's ingester-colocation pull for ingest-API sources."""
        if not indexer_nodes:
            self.last_plan = PhysicalIndexingPlan()
            return self.last_plan
        nodes = sorted(indexer_nodes)
        node_ord = {n: i for i, n in enumerate(nodes)}

        groups = sorted({t.group for t in tasks})
        group_ord = {g: s for s, g in enumerate(groups)}
        by_group: dict[tuple, list[IndexingTask]] = {g: [] for g in groups}
        for t in sorted(tasks, key=lambda t: t.key):
            by_group[t.group].append(t)

        problem = SchedulingProblem(
            num_shards=np.array([len(by_group[g]) for g in groups],
                                dtype=np.int64),
            load_per_shard=np.array(
                [g[2] * MILLICPU_PER_WEIGHT for g in groups],
                dtype=np.int64),
            capacities=np.full(len(nodes), self.indexer_millicpu,
                               dtype=np.int64),
        )
        # affinity: explicit colocation scores, else the previous plan's
        # footprint (keeps a source on the nodes it already touches)
        for g, s in group_ord.items():
            scores: dict[int, int] = {}
            for node_id, score in (affinities or {}).get(g, {}).items():
                if node_id in node_ord:
                    scores[node_ord[node_id]] = score
            if not scores:
                for node_id, prev_tasks in self.last_plan.assignments.items():
                    if node_id in node_ord:
                        n = sum(1 for t in prev_tasks if t.group == g)
                        if n:
                            scores[node_ord[node_id]] = n
            if scores:
                problem.affinities[s] = scores

        previous = np.zeros((len(nodes), len(groups)), dtype=np.int64)
        prev_node_of: dict[tuple, str] = {}
        for node_id, prev_tasks in self.last_plan.assignments.items():
            if node_id not in node_ord:
                continue
            for t in prev_tasks:
                prev_node_of[t.key] = node_id
                if t.group in group_ord:
                    previous[node_ord[node_id], group_ord[t.group]] += 1

        try:
            counts = solve(problem, previous,
                           headroom=self.max_load_factor)
        except NotEnoughCapacity:
            # degenerate fallback: spread evenly; the solver only gives
            # up past 1.2^12 inflation (pathological weights)
            counts = np.zeros((len(nodes), len(groups)), dtype=np.int64)
            for s, g in enumerate(groups):
                for k in range(len(by_group[g])):
                    counts[k % len(nodes), s] += 1

        # expand the matrix into concrete tasks: previous node first
        # (stickiness), then fill remaining slots in node order
        plan = PhysicalIndexingPlan(assignments={n: [] for n in nodes})
        for g, s in group_ord.items():
            slots = {i: int(counts[i, s]) for i in range(len(nodes))}
            pending: list[IndexingTask] = []
            for t in by_group[g]:
                prev = prev_node_of.get(t.key)
                i = node_ord.get(prev) if prev is not None else None
                if i is not None and slots.get(i, 0) > 0:
                    plan.assignments[nodes[i]].append(t)
                    slots[i] -= 1
                else:
                    pending.append(t)
            for t in pending:
                i = min((i for i, c in slots.items() if c > 0), default=None)
                if i is None:  # fallback counts may under-allocate: spread
                    i = min(range(len(nodes)),
                            key=lambda n: len(plan.assignments[nodes[n]]))
                else:
                    slots[i] -= 1
                plan.assignments[nodes[i]].append(t)

        plan.assignments = {n: t for n, t in plan.assignments.items() if t}
        self.last_plan = plan
        return plan

    def plan_drift(self, running: dict[str, list[IndexingTask]]) -> bool:
        """True if what nodes report running differs from the last plan
        (the reference's periodic drift re-check, §3.4)."""
        want = {n: sorted(t.key for t in ts)
                for n, ts in self.last_plan.assignments.items()}
        have = {n: sorted(t.key for t in ts) for n, ts in running.items() if ts}
        return want != have
