from .planner import CompactionPlanner, MergeTask
from .supervisor import CompactorState, CompactorSupervisor

__all__ = ["CompactionPlanner", "CompactorState", "CompactorSupervisor",
           "MergeTask"]
