"""Split format: writer, reader, synthetic generators and impact ordering."""
from .format import SplitFooter, ArrayMeta, MAGIC, read_footer, DOC_PAD, POSTING_PAD
from .writer import SplitWriter
from .reader import SplitReader

__all__ = [
    "SplitWriter", "SplitReader", "SplitFooter", "ArrayMeta", "MAGIC",
    "read_footer", "DOC_PAD", "POSTING_PAD",
]
