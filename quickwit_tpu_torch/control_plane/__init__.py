from .arbiter import (ScaleDown, ScaleUp, ScalingArbiter, ScalingPermits,
                      ShardRateTracker, ShardStats,
                      find_scale_down_candidate)
from .scheduler import IndexingScheduler, IndexingTask, PhysicalIndexingPlan
from .solver import NotEnoughCapacity, SchedulingProblem, solve

__all__ = [
    "IndexingScheduler", "IndexingTask", "PhysicalIndexingPlan",
    "SchedulingProblem", "solve", "NotEnoughCapacity",
    "ScalingArbiter", "ScalingPermits", "ShardRateTracker", "ShardStats",
    "ScaleUp", "ScaleDown", "find_scale_down_candidate",
]
