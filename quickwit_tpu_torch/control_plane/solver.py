"""Multi-phase indexing-placement solver.

Role of the reference's scheduling optimizer
(`quickwit-control-plane/src/indexing_scheduler/scheduling/
scheduling_logic.rs:41` and the README in that directory): given sources
(each a number of equal-load shards) and indexers (each a millicpu
capacity), produce a placement matrix `counts[indexer][source]` that

  - places every shard (growing capacity by 1.2x steps when bin-packing
    fails, then descending to the minimal feasible level so repeated
    calls are idempotent — the reference's inflation ascent/descent),
  - never exceeds the (inflated) per-indexer capacity,
  - stays close to the previous solution (phase ordering starts FROM the
    previous matrix and only shaves what must move),
  - prefers placing shards on indexers with declared affinity
    (the reference's ingester-colocation scores).

The mechanics are our own: the matrix lives in numpy, phases are pure
functions over it, and tie-breaks are deterministic (ordinal order, no
RNG) so the control loop converges instead of oscillating.

Carried over whole from the JAX package's `control_plane/solver.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# capacity head-room factor: indexers are virtually inflated so the
# cluster always offers >= 120% of the total load (reference README:
# "We calculate 120% of the total load ... divide it up proportionally")
HEADROOM = 1.2
MAX_INFLATION_ATTEMPTS = 12


class NotEnoughCapacity(Exception):
    """Placement failed at the current inflation level."""


@dataclass
class SchedulingProblem:
    """`num_shards[s]` shards of `load_per_shard[s]` millicpu each, to be
    placed on indexers with `capacities[i]` millicpu."""
    num_shards: np.ndarray          # (S,) int
    load_per_shard: np.ndarray      # (S,) int millicpu
    capacities: np.ndarray          # (I,) int millicpu
    # affinity[s] -> {indexer_ord: score}; higher score = stronger pull
    affinities: dict[int, dict[int, int]] = field(default_factory=dict)

    @property
    def num_sources(self) -> int:
        return int(self.num_shards.size)

    @property
    def num_indexers(self) -> int:
        return int(self.capacities.size)

    def total_load(self) -> int:
        return int(np.dot(self.num_shards, self.load_per_shard))


def _inflate_capacities(problem: SchedulingProblem, factor: float,
                        headroom: float = HEADROOM) -> np.ndarray:
    """VIRTUAL capacities, the balancing mechanism (reference README):
    each indexer gets its proportional share of HEADROOM * total load, so
    respecting the virtual bound keeps every node near the average load.
    Shards place freely up to 30% of the REAL capacity (tiny cluster
    loads need not be balanced). The attempt factor grows the bound by
    HEADROOM steps when bin-packing fails."""
    caps = problem.capacities.astype(np.float64)
    total_cap = caps.sum()
    if total_cap <= 0:
        return np.zeros_like(problem.capacities)
    share = caps / total_cap * (headroom * problem.total_load())
    virtual = np.maximum(share, 0.3 * caps)
    return np.ceil(virtual * factor).astype(np.int64)


def _node_loads(problem: SchedulingProblem, counts: np.ndarray) -> np.ndarray:
    return counts @ problem.load_per_shard.astype(np.int64)


def _remove_extraneous(problem: SchedulingProblem,
                       counts: np.ndarray) -> None:
    """Phase 1: a source may have shrunk (or vanished) since the previous
    solution; shave surplus shards, taking first from indexers holding
    the FEWEST shards of that source (minimizes the number of nodes the
    source touches — reference phase 1)."""
    assigned = counts.sum(axis=0)
    for s in range(problem.num_sources):
        surplus = int(assigned[s]) - int(problem.num_shards[s])
        while surplus > 0:
            holders = np.nonzero(counts[:, s])[0]
            # fewest-first, ordinal tie-break
            i = min(holders, key=lambda n: (counts[n, s], n))
            take = min(surplus, int(counts[i, s]))
            counts[i, s] -= take
            surplus -= take
    # sources no longer in the problem were already trimmed to num_shards=0


def _enforce_capacity(problem: SchedulingProblem, counts: np.ndarray,
                      caps: np.ndarray) -> None:
    """Phase 2: shard loads may have grown; evict whole sources from
    overloaded indexers, smallest on-node load first (reference: "we
    remove in priority sources that have an overall small load")."""
    loads = _node_loads(problem, counts)
    for i in range(problem.num_indexers):
        while loads[i] > caps[i]:
            present = np.nonzero(counts[i])[0]
            if present.size == 0:
                break
            on_node = counts[i, present] * problem.load_per_shard[present]
            s = int(present[np.lexsort((present, on_node))[0]])
            loads[i] -= int(counts[i, s]) * int(problem.load_per_shard[s])
            counts[i, s] = 0


def _place_with_affinity(problem: SchedulingProblem, counts: np.ndarray,
                         caps: np.ndarray) -> None:
    """Phase 3a: route missing shards to indexers that declared affinity
    for the source (strongest score first), capacity permitting."""
    loads = _node_loads(problem, counts)
    missing = problem.num_shards - counts.sum(axis=0)
    for s, scores in sorted(problem.affinities.items()):
        if s >= problem.num_sources or missing[s] <= 0:
            continue
        lps = int(problem.load_per_shard[s])
        for i, _score in sorted(scores.items(),
                                key=lambda kv: (-kv[1], kv[0])):
            while missing[s] > 0 and loads[i] + lps <= caps[i]:
                counts[i, s] += 1
                loads[i] += lps
                missing[s] -= 1


def _place_remaining(problem: SchedulingProblem, counts: np.ndarray,
                     caps: np.ndarray) -> None:
    """Phase 3b: greedy best-fit for whatever is still unassigned, source
    by source in decreasing total-load order, preferring the indexer with
    the most remaining capacity (keeps sources on few nodes: each shard
    of a source keeps landing on the same node until it fills)."""
    loads = _node_loads(problem, counts)
    avail = caps - loads
    source_order = np.lexsort(
        (np.arange(problem.num_sources),
         -(problem.num_shards * problem.load_per_shard)))
    for s in source_order:
        lps = int(problem.load_per_shard[s])
        missing = int(problem.num_shards[s]) - int(counts[:, s].sum())
        while missing > 0:
            i = int(np.lexsort((np.arange(avail.size), -avail))[0])
            if avail[i] < lps:
                raise NotEnoughCapacity()
            fit = min(missing, int(avail[i] // lps)) if lps > 0 else missing
            counts[i, s] += fit
            avail[i] -= fit * lps
            missing -= fit


def _attempt(problem: SchedulingProblem, previous: np.ndarray,
             caps: np.ndarray) -> np.ndarray:
    counts = previous.copy()
    _remove_extraneous(problem, counts)
    _enforce_capacity(problem, counts, caps)
    _place_with_affinity(problem, counts, caps)
    _place_remaining(problem, counts, caps)
    return counts


def solve(problem: SchedulingProblem,
          previous: np.ndarray | None = None,
          headroom: float = HEADROOM) -> np.ndarray:
    """Returns `counts[indexer][source]` placing every shard.

    Ascends inflation levels (1.2^k) until bin-packing succeeds, then
    descends re-feeding the candidate to find the minimal feasible level
    — the reference's stability trick: re-solving from the returned
    solution is a no-op, so the control loop does not thrash."""
    shape = (problem.num_indexers, problem.num_sources)
    if previous is None:
        previous = np.zeros(shape, dtype=np.int64)
    else:
        fixed = np.zeros(shape, dtype=np.int64)
        src = previous[: shape[0], : shape[1]]
        fixed[: src.shape[0], : src.shape[1]] = src
        previous = fixed
    if problem.num_indexers == 0:
        if int(problem.num_shards.sum()) > 0:
            raise NotEnoughCapacity()
        return previous

    best: np.ndarray | None = None
    best_level = 0
    for level in range(MAX_INFLATION_ATTEMPTS):
        caps = _inflate_capacities(problem, HEADROOM ** level, headroom)
        try:
            best = _attempt(problem, previous, caps)
            best_level = level
            break
        except NotEnoughCapacity:
            continue
    if best is None:
        raise NotEnoughCapacity(
            f"cannot place {int(problem.num_shards.sum())} shards / "
            f"{problem.total_load()} millicpu on capacity "
            f"{int(problem.capacities.sum())}")
    while best_level > 0:
        caps = _inflate_capacities(problem, HEADROOM ** (best_level - 1),
                                   headroom)
        try:
            best = _attempt(problem, best, caps)
            best_level -= 1
        except NotEnoughCapacity:
            break
    return best
