"""Shard autoscaling arbiter.

Role of the reference's `ScalingArbiter` + the shard table's scaling
permits (`quickwit-control-plane/src/ingest/scaling_arbiter.rs:19`,
`model/shard_table.rs:33`): decide, per source, whether to open or close
ingest shards from the observed per-shard ingestion rates.

Semantics preserved from the reference:
  - scale-up triggers on the SHORT-term average rate (reactive, ~5s
    window) at 80% of the per-shard throughput limit, but the target
    shard count is capped so the LONG-term average never drops below 30%
    of the limit (avoids up/down flapping on spikes);
  - the target grows by `scale_up_factor` per decision (geometric ramp);
  - scale-down triggers only on the LONG-term average at 20% of the
    limit, one shard at a time;
  - both directions are permit-rate-limited per source (up: bursts of 5
    per minute; down: 1 per minute) so a noisy metric cannot thrash the
    shard table;
  - the scale-down victim is a shard on the ingester holding the MOST
    open shards of the source (`find_scale_down_candidate`,
    `ingest_controller.rs:1300`) — deterministic here (oldest shard id)
    instead of RNG tie-breaks.

Carried over whole from the JAX package's `control_plane/arbiter.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..common.clock import monotonic
from ..common.tower import TokenBucket


@dataclass(frozen=True)
class ShardStats:
    num_open_shards: int
    avg_short_term_rate_mib: float  # per open shard, MiB/s
    avg_long_term_rate_mib: float


@dataclass(frozen=True)
class ScaleUp:
    num_shards: int


@dataclass(frozen=True)
class ScaleDown:
    pass


class ScalingArbiter:
    def __init__(self, max_shard_throughput_mib: float = 5.0,
                 scale_up_factor: float = 1.5):
        self.short_term_up_threshold = max_shard_throughput_mib * 0.8
        self.long_term_up_floor = max_shard_throughput_mib * 0.3
        self.down_threshold = max_shard_throughput_mib * 0.2
        self.scale_up_factor = scale_up_factor

    def should_scale(self, stats: ShardStats,
                     min_shards: int = 1) -> Optional[ScaleUp | ScaleDown]:
        if stats.num_open_shards == 0 or stats.avg_long_term_rate_mib == 0.0:
            # idle sources are closed by the ingesters themselves; a
            # source with no open shard scales on first ingest instead
            return None
        if stats.num_open_shards < min_shards:
            return ScaleUp(min_shards - stats.num_open_shards)
        if stats.avg_short_term_rate_mib >= self.short_term_up_threshold:
            # total long-term volume spread over the new count must stay
            # above the long-term floor
            max_by_volume = int(
                stats.avg_long_term_rate_mib * stats.num_open_shards
                / self.long_term_up_floor)
            by_factor = int(-(-stats.num_open_shards
                              * self.scale_up_factor // 1))  # ceil
            target = max(min_shards, min(max_by_volume, by_factor))
            if target > stats.num_open_shards:
                return ScaleUp(target - stats.num_open_shards)
        if (stats.avg_long_term_rate_mib <= self.down_threshold
                and stats.num_open_shards > min_shards):
            return ScaleDown()
        return None


@dataclass
class _SourcePermits:
    up: "TokenBucket"
    down: "TokenBucket"


class ScalingPermits:
    """Per-source decision rate limiting (reference:
    `shard_table.rs:33` SCALING_{UP,DOWN}_RATE_LIMITER_SETTINGS)."""

    def __init__(self, clock=monotonic):
        self._clock = clock
        self._per_source: dict[str, _SourcePermits] = {}

    def _entry(self, source_key: str) -> _SourcePermits:
        entry = self._per_source.get(source_key)
        if entry is None:
            entry = _SourcePermits(
                up=TokenBucket(rate_per_sec=5 / 60.0, burst=5,
                               clock=self._clock),
                down=TokenBucket(rate_per_sec=1 / 60.0, burst=1,
                                 clock=self._clock))
            self._per_source[source_key] = entry
        return entry

    def acquire(self, source_key: str,
                decision: ScaleUp | ScaleDown) -> int:
        """Returns the number of shards the caller may act on now (0 =
        denied). A ScaleUp larger than the remaining burst budget is
        GRANTED PARTIALLY rather than stalling forever — the arbiter will
        re-request the rest next tick once permits refill."""
        entry = self._entry(source_key)
        if isinstance(decision, ScaleUp):
            for n in range(decision.num_shards, 0, -1):
                if entry.up.try_acquire(n):
                    return n
            return 0
        return 1 if entry.down.try_acquire(1) else 0

    def release(self, source_key: str, decision: ScaleUp | ScaleDown,
                granted: Optional[int] = None) -> None:
        """Give permits back when the metastore/ingester op failed — a
        failed attempt must not eat the budget for the retry. Pass the
        count `acquire` actually returned: refunding the full decision
        after a partial grant would mint permits never consumed."""
        entry = self._entry(source_key)
        if isinstance(decision, ScaleUp):
            entry.up.release(granted if granted is not None
                             else decision.num_shards)
        elif granted is None or granted > 0:
            # same partial-grant rule as ScaleUp: a denied acquire
            # (granted == 0) must not mint a down permit on release
            entry.down.release(1)


def find_scale_down_candidate(
        open_shards: dict[str, str]) -> Optional[tuple[str, str]]:
    """`{shard_id: leader_node_id}` -> (leader, shard) to close: a shard
    on the node with the most open shards of this source, oldest shard id
    (deterministic; the reference breaks ties randomly)."""
    if not open_shards:
        return None
    per_leader: dict[str, list[str]] = {}
    for shard_id, leader in open_shards.items():
        per_leader.setdefault(leader, []).append(shard_id)
    leader = max(per_leader, key=lambda n: (len(per_leader[n]), n))
    return leader, min(per_leader[leader])


class ShardRateTracker:
    """Turns cumulative per-shard byte counters into short/long-term
    ingestion-rate EMAs (MiB/s). The reference keeps two windows on the
    ingester side (~5s reactive, longer-term smoothing) and gossips them;
    here the control loop samples `Ingester.shard_throughput_state()`
    and owns the smoothing."""

    def __init__(self, short_tau_secs: float = 5.0,
                 long_tau_secs: float = 60.0, clock=monotonic):
        self.short_tau = short_tau_secs
        self.long_tau = long_tau_secs
        self.clock = clock
        # queue_id -> (last_bytes, last_t, short_ema, long_ema)
        self._state: dict[str, tuple[int, float, float, float]] = {}

    def observe(self, queue_id: str, total_bytes: int) -> None:
        import math
        now = self.clock()
        prev = self._state.get(queue_id)
        if prev is None:
            self._state[queue_id] = (total_bytes, now, 0.0, 0.0)
            return
        last_bytes, last_t, short, long_ = prev
        dt = max(now - last_t, 1e-6)
        rate = max(total_bytes - last_bytes, 0) / dt / (1 << 20)  # MiB/s
        a_s = 1.0 - math.exp(-dt / self.short_tau)
        a_l = 1.0 - math.exp(-dt / self.long_tau)
        self._state[queue_id] = (total_bytes, now,
                                 short + a_s * (rate - short),
                                 long_ + a_l * (rate - long_))

    def forget(self, queue_id: str) -> None:
        self._state.pop(queue_id, None)

    def retain(self, live_queue_ids) -> None:
        """Drop state for shards that no longer exist (closed/deleted by
        any path) — the tracker must not grow with shard churn."""
        live = set(live_queue_ids)
        for queue_id in [q for q in self._state if q not in live]:
            del self._state[queue_id]

    def rates(self, queue_id: str) -> tuple[float, float]:
        _, _, short, long_ = self._state.get(queue_id, (0, 0.0, 0.0, 0.0))
        return short, long_

    def source_stats(self, queue_ids: list[str]) -> ShardStats:
        if not queue_ids:
            return ShardStats(0, 0.0, 0.0)
        shorts, longs = zip(*(self.rates(q) for q in queue_ids))
        n = len(queue_ids)
        return ShardStats(n, sum(shorts) / n, sum(longs) / n)
