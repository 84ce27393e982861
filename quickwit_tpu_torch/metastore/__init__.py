from .checkpoint import CheckpointDelta, IncompatibleCheckpointDelta, SourceCheckpoint
from .base import Metastore, MetastoreError, ListSplitsQuery
from .file_backed import FileBackedMetastore
from .sql import SqlMetastore

__all__ = [
    "Metastore", "MetastoreError", "ListSplitsQuery", "FileBackedMetastore",
    "SqlMetastore",
    "SourceCheckpoint", "CheckpointDelta", "IncompatibleCheckpointDelta",
]
