"""Cooperative indexing: phase-spread, concurrency-bounded pipeline turns.

Role of the reference's `cooperative_indexing.rs` (CooperativeIndexingCycle
/ CooperativeIndexingPeriod): with many (index, source) pipelines on one
node, letting them all build splits at once maximizes peak memory and
makes every resource spike coincide. Instead:

- a semaphore caps how many pipelines may index concurrently, and
- each pipeline is steered toward a private target PHASE of the shared
  `commit_timeout` cycle (derived from a hash of its pipeline id), so
  work spreads uniformly over the window instead of thundering together.

The sleep after a work period is `commit_timeout - (work duration)`,
nudged by at most NUDGE_TOLERANCE_SECS toward the target phase per cycle
(reference `compute_sleep_duration`). Work periods also yield
PipelineMetrics (throughput + cpu-load fraction of one full pipeline),
which the control-plane scheduler consumes as observed pipeline cost.

The clock is injectable so tests steer phases without real sleeping
(the actor Universe's accelerated clock plugs in directly).

Carried over whole from the JAX package's `indexing/cooperative.py`.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from ..common.clock import monotonic

NUDGE_TOLERANCE_SECS = 5.0

# one pipeline saturating its whole commit window ≙ this many cpu millis
# (reference PIPELINE_FULL_CAPACITY = 4000mcpu)
PIPELINE_FULL_CAPACITY_MCPU = 4000


@dataclass(frozen=True)
class PipelineMetrics:
    """Observed per-cycle pipeline cost (reference PipelineMetrics)."""
    cpu_load_mcpu: int
    throughput_mb_per_sec: int


class CooperativeIndexingCycle:
    """Per-pipeline scheduling state; share one `permits` semaphore across
    every pipeline of the node."""

    def __init__(self, pipeline_id: str, commit_timeout_secs: float,
                 permits: threading.Semaphore,
                 clock: Callable[[], float] = monotonic,
                 origin: Optional[float] = None):
        if commit_timeout_secs <= 0:
            raise ValueError("commit_timeout must be positive")
        self.commit_timeout = float(commit_timeout_secs)
        self.permits = permits
        self.clock = clock
        # shared origin of time: phases of different pipelines must be
        # measured against the same epoch to spread out
        self.origin = 0.0 if origin is None else origin
        digest = hashlib.blake2b(pipeline_id.encode(),
                                 digest_size=8).digest()
        # max(…, 1): sub-millisecond windows must not modulo by zero
        window_millis = max(int(self.commit_timeout * 1000), 1)
        self.target_phase = (int.from_bytes(digest, "little")
                             % window_millis) / 1000.0

    def initial_sleep_duration(self) -> float:
        """Sleep that puts the FIRST period near the target phase."""
        current = (self.clock() - self.origin) % self.commit_timeout
        sleep = (self.commit_timeout + self.target_phase
                 - current) % self.commit_timeout
        if sleep + 2 * NUDGE_TOLERANCE_SECS > self.commit_timeout:
            # close enough — the per-cycle nudge finishes the job
            return 0.0
        return sleep

    def begin_period(self, timeout: Optional[float] = None
                     ) -> Optional["CooperativeIndexingPeriod"]:
        """Acquire an indexing turn (blocks on the shared semaphore, the
        reference's 'waking' phase). None when `timeout` elapses first."""
        t_wake = self.clock()
        acquired = self.permits.acquire(
            timeout=timeout) if timeout is not None \
            else self.permits.acquire()
        if not acquired:
            return None
        return CooperativeIndexingPeriod(self, t_wake, self.clock())


class CooperativeIndexingPeriod:
    def __init__(self, cycle: CooperativeIndexingCycle, t_wake: float,
                 t_work_start: float):
        self.cycle = cycle
        self.t_wake = t_wake
        self.t_work_start = t_work_start
        self._done = False

    def _compute_sleep_duration(self, t_work_end: float) -> float:
        ct = self.cycle.commit_timeout
        phase = (t_work_end - self.cycle.origin) % ct
        delta = phase - self.cycle.target_phase
        # fold into [-ct/2, ct/2): nudge toward the NEAREST occurrence
        if delta >= ct / 2:
            delta -= ct
        elif delta < -ct / 2:
            delta += ct
        nudge = max(-NUDGE_TOLERANCE_SECS,
                    min(NUDGE_TOLERANCE_SECS, delta))
        return max(0.0, ct - (t_work_end - self.t_wake) - nudge)

    def _compute_metrics(self, t_work_end: float,
                         uncompressed_num_bytes: int) -> PipelineMetrics:
        elapsed = max(t_work_end - self.t_work_start, 0.0)
        # bytes per microsecond == MB/s (reference formula)
        throughput = int(uncompressed_num_bytes / (1.0 + elapsed * 1e6))
        fraction = min(elapsed / self.cycle.commit_timeout, 1.0)
        return PipelineMetrics(
            cpu_load_mcpu=int(PIPELINE_FULL_CAPACITY_MCPU * fraction),
            throughput_mb_per_sec=throughput)

    def end_of_work(self, uncompressed_num_bytes: int
                    ) -> tuple[float, PipelineMetrics]:
        """Release the permit; → (sleep_secs until next period, metrics)."""
        if self._done:
            raise RuntimeError("end_of_work called twice")
        self._done = True
        t_work_end = self.cycle.clock()
        self.cycle.permits.release()
        return (self._compute_sleep_duration(t_work_end),
                self._compute_metrics(t_work_end, uncompressed_num_bytes))
