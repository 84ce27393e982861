"""Search job placement.

Role of the reference's `SearchJobPlacer` (`search_job_placer.rs:40,306`):
assign per-split search jobs to searcher nodes by rendezvous hashing (cache
affinity: the same split lands on the same node across queries) with cost
balancing — a node already loaded past the mean cost spills its next splits
to the next-best node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

from ..common.rendezvous import sort_by_rendezvous_hash


@dataclass(frozen=True)
class SearchJob:
    split_id: str
    cost: int = 1  # reference: derived from split doc count


def place_jobs(jobs: Sequence[SearchJob], nodes: Sequence[str],
               max_load_factor: float = 1.2) -> dict[str, list[SearchJob]]:
    """split jobs → node assignments; deterministic given (jobs, nodes)."""
    if not nodes:
        raise ValueError("no searcher nodes available")
    total_cost = sum(job.cost for job in jobs) or 1
    capacity = (total_cost / len(nodes)) * max_load_factor
    load: dict[str, int] = {node: 0 for node in nodes}
    assignment: dict[str, list[SearchJob]] = {node: [] for node in nodes}
    # place big jobs first so spill decisions happen while there is room
    for job in sorted(jobs, key=lambda j: (-j.cost, j.split_id)):
        preference = sort_by_rendezvous_hash(job.split_id, nodes)
        chosen = None
        for node in preference:
            if load[node] + job.cost <= capacity:
                chosen = node
                break
        if chosen is None:  # everyone is "full": least-loaded wins
            chosen = min(preference, key=lambda n: load[n])
        load[chosen] += job.cost
        assignment[chosen].append(job)
    return {node: jobs_ for node, jobs_ in assignment.items() if jobs_}


def nodes_for_split(split_id: str, nodes: Sequence[str]) -> list[str]:
    """Preference-ordered nodes for one split (retry order,
    reference `ClusterClient` retry policy)."""
    return sort_by_rendezvous_hash(split_id, nodes)
