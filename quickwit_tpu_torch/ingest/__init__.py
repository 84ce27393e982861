from .wal import RecordLog
from .ingester import Ingester, ShardState
from .router import IngestRouter

__all__ = ["RecordLog", "Ingester", "ShardState", "IngestRouter"]
