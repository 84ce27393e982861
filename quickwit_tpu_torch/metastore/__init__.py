from .checkpoint import CheckpointDelta, IncompatibleCheckpointDelta, SourceCheckpoint
from .base import Metastore, MetastoreError, ListSplitsQuery
from .file_backed import FileBackedMetastore

__all__ = [
    "Metastore", "MetastoreError", "ListSplitsQuery", "FileBackedMetastore",
    "SourceCheckpoint", "CheckpointDelta", "IncompatibleCheckpointDelta",
]
