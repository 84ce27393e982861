from .sources import FileSource, Source, SourceBatch, VecSource, VoidSource, make_source
from .pipeline import IndexingPipeline, PipelineParams
from .merge import MergeExecutor, StableLogMergePolicy, NopMergePolicy, merge_policy_from_config

__all__ = [
    "Source", "SourceBatch", "VecSource", "FileSource", "VoidSource", "make_source",
    "IndexingPipeline", "PipelineParams",
    "MergeExecutor", "StableLogMergePolicy", "NopMergePolicy", "merge_policy_from_config",
]
