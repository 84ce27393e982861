from .ast import (
    Bool,
    Boost,
    FieldPresence,
    FullText,
    MatchAll,
    MatchNone,
    PhrasePrefix,
    QueryAst,
    Range,
    RangeBound,
    Regex,
    Term,
    TermSet,
    Wildcard,
    ast_from_dict,
)
from .parser import parse_query_string
from .tokenizers import get_tokenizer

__all__ = [
    "QueryAst", "Term", "TermSet", "FullText", "PhrasePrefix", "Wildcard",
    "Regex", "Range", "RangeBound", "Bool", "Boost", "MatchAll", "MatchNone",
    "FieldPresence", "ast_from_dict", "parse_query_string", "get_tokenizer",
]
