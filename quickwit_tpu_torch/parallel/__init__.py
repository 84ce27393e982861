"""Multi-split execution: a leaf's splits in one dispatch (fanout.py)."""

from .fanout import SplitBatch, build_batch, execute_batch
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "SplitBatch", "build_batch", "execute_batch",
           "make_mesh"]
