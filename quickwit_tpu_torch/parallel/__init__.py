"""Multi-split execution: a leaf's splits in one dispatch (fanout.py)."""

from .fanout import SplitBatch, build_batch, execute_batch

__all__ = ["SplitBatch", "build_batch", "execute_batch"]
