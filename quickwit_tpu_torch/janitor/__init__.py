from .delete_planner import DeleteTaskPlanner, run_delete_planner
from .gc import run_garbage_collection
from .retention import apply_retention

__all__ = ["DeleteTaskPlanner", "run_delete_planner",
           "run_garbage_collection", "apply_retention"]
