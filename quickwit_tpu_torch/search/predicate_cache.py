"""Query-side term canonicalization shared by plan lowering and pruning.

Subset of the JAX package's `search/predicate_cache.py`: only the two pure
helpers that `search/plan.py` and `search/pruning.py` call. The predicate
cache itself is not carried over yet.
"""

from __future__ import annotations

from ..models.doc_mapper import FieldMapping, FieldType


def term_is_tokenized_text(fm: FieldMapping) -> bool:
    """True when a Term node on this field lowers as a conjunctive
    full-text match (quickwit query-language semantics). Shared by
    `Lowering._lower_term` and `required_terms` so their dispatch cannot
    drift — divergence would make pruning unsound."""
    return fm.type is FieldType.TEXT and fm.tokenizer not in ("raw",
                                                              "lowercase")


def canonical_query_term(fm: FieldMapping, value: str) -> str:
    """Query-side canonical index-term string — THE transformation plan
    lowering applies before every term-dictionary lookup
    (`Lowering._canonical` delegates here), so predicate-cache keys and
    lookup keys coincide by construction."""
    from ..utils.datetime_utils import parse_datetime_to_micros
    if fm.type is FieldType.TEXT:
        return value
    if fm.type is FieldType.DATETIME:
        return str(parse_datetime_to_micros(value, fm.input_formats)
                   if not str(value).lstrip("-").isdigit()
                   else parse_datetime_to_micros(int(value),
                                                 ("unix_timestamp",)))
    if fm.type is FieldType.F64:
        return repr(float(value))
    if fm.type is FieldType.BOOL:
        return value.lower()
    return str(int(value))
