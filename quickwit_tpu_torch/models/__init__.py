from .doc_mapper import DocMapper, FieldMapping, FieldType, DocParsingError
from .split_metadata import SplitMetadata, SplitState
from .index_metadata import IndexMetadata

__all__ = [
    "DocMapper", "FieldMapping", "FieldType", "DocParsingError",
    "SplitMetadata", "SplitState", "IndexMetadata",
]
