"""Serializable query AST.

Role of the reference's `quickwit-query/src/query_ast/mod.rs`: a typed,
JSON-serializable query tree that travels between root and leaf searchers and
is lowered — against a concrete doc mapping — into an executable plan.  In the
TPU build the lowering target is a tensor plan (`search/plan.py`) instead of a
tantivy `Query`.

Every node serializes as ``{"type": "<tag>", ...fields}`` so leaf requests are
wire-stable, mirroring the reference's internally-tagged serde representation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

JsonLiteral = Union[str, int, float, bool, None]


@dataclass(frozen=True)
class QueryAst:
    """Base class; use the concrete subclasses below."""

    def to_dict(self) -> dict[str, Any]:
        raise NotImplementedError

    # --- combinators -------------------------------------------------------
    def boost(self, factor: float) -> "QueryAst":
        return Boost(underlying=self, boost=factor)


@dataclass(frozen=True)
class MatchAll(QueryAst):
    def to_dict(self) -> dict[str, Any]:
        return {"type": "match_all"}


@dataclass(frozen=True)
class MatchNone(QueryAst):
    def to_dict(self) -> dict[str, Any]:
        return {"type": "match_none"}


@dataclass(frozen=True)
class Term(QueryAst):
    """Exact term on a field; `value` is the raw (pre-normalization) token.

    `verbatim` distinguishes ES `term` queries (no analysis: the value
    must equal the post-tokenization indexed form — reference:
    `elastic_query_dsl/term_query.rs`) from query-string terms, which
    tokenize on text fields like a conjunctive full-text match."""
    field: str
    value: str
    verbatim: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {"type": "term", "field": self.field, "value": self.value,
                "verbatim": self.verbatim}


@dataclass(frozen=True)
class TermSet(QueryAst):
    """Matches docs containing any of the terms (per field)."""
    terms_per_field: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": "term_set",
            "terms_per_field": {f: list(ts) for f, ts in self.terms_per_field.items()},
        }


@dataclass(frozen=True)
class FullText(QueryAst):
    """Tokenized match query. `mode` is 'or' | 'and' | 'phrase'.

    The reference's FullTextQuery (`full_text_query.rs`) with its
    operator/phrase modes; slop supported for phrase.
    """
    field: str
    text: str
    mode: str = "or"
    slop: int = 0
    # ES `zero_terms_query`: what a match whose text tokenizes to nothing
    # matches — "none" (default) or "all"
    zero_terms: str = "none"

    def to_dict(self) -> dict[str, Any]:
        return {"type": "full_text", "field": self.field, "text": self.text,
                "mode": self.mode, "slop": self.slop,
                "zero_terms": self.zero_terms}


@dataclass(frozen=True)
class PhrasePrefix(QueryAst):
    field: str
    phrase: str
    max_expansions: int = 50
    analyzer: Optional[str] = None  # ES per-query analyzer override

    def to_dict(self) -> dict[str, Any]:
        return {"type": "phrase_prefix", "field": self.field, "phrase": self.phrase,
                "max_expansions": self.max_expansions,
                "analyzer": self.analyzer}


@dataclass(frozen=True)
class Wildcard(QueryAst):
    field: str
    pattern: str  # `*` and `?` wildcards
    case_insensitive: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {"type": "wildcard", "field": self.field,
                "pattern": self.pattern,
                "case_insensitive": self.case_insensitive}


@dataclass(frozen=True)
class Regex(QueryAst):
    field: str
    pattern: str
    case_insensitive: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {"type": "regex", "field": self.field,
                "pattern": self.pattern,
                "case_insensitive": self.case_insensitive}


@dataclass(frozen=True)
class FieldPresence(QueryAst):
    field: str

    def to_dict(self) -> dict[str, Any]:
        return {"type": "field_presence", "field": self.field}


@dataclass(frozen=True)
class RangeBound:
    value: JsonLiteral
    inclusive: bool = True

    def to_dict(self) -> dict[str, Any]:
        return {"value": self.value, "inclusive": self.inclusive}

    @staticmethod
    def from_dict(d: Optional[dict[str, Any]]) -> "Optional[RangeBound]":
        if d is None:
            return None
        return RangeBound(d["value"], d.get("inclusive", True))


@dataclass(frozen=True)
class Range(QueryAst):
    field: str
    lower: Optional[RangeBound] = None
    upper: Optional[RangeBound] = None
    # ES range `format` param: a java-time pattern the bounds are parsed
    # with instead of the field's input_formats
    format: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": "range",
            "field": self.field,
            "lower": self.lower.to_dict() if self.lower else None,
            "upper": self.upper.to_dict() if self.upper else None,
            "format": self.format,
        }


@dataclass(frozen=True)
class Bool(QueryAst):
    """Boolean combination (reference: `bool_query.rs`).

    Semantics match ES/tantivy: `must`/`filter` are conjunctive, `should`
    disjunctive (scoring only if there are no `must` clauses, unless
    minimum_should_match forces it), `must_not` is an exclusion filter and
    never scores.
    """
    must: tuple[QueryAst, ...] = ()
    must_not: tuple[QueryAst, ...] = ()
    should: tuple[QueryAst, ...] = ()
    filter: tuple[QueryAst, ...] = ()
    minimum_should_match: Optional[int] = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": "bool",
            "must": [q.to_dict() for q in self.must],
            "must_not": [q.to_dict() for q in self.must_not],
            "should": [q.to_dict() for q in self.should],
            "filter": [q.to_dict() for q in self.filter],
            "minimum_should_match": self.minimum_should_match,
        }


@dataclass(frozen=True)
class Boost(QueryAst):
    underlying: QueryAst
    boost: float

    def to_dict(self) -> dict[str, Any]:
        return {"type": "boost", "underlying": self.underlying.to_dict(), "boost": self.boost}


def _seq(dicts: Sequence[dict[str, Any]]) -> tuple[QueryAst, ...]:
    return tuple(ast_from_dict(d) for d in dicts)


def ast_from_dict(d: dict[str, Any]) -> QueryAst:
    tag = d["type"]
    if tag == "match_all":
        return MatchAll()
    if tag == "match_none":
        return MatchNone()
    if tag == "term":
        return Term(d["field"], d["value"], d.get("verbatim", False))
    if tag == "term_set":
        return TermSet({f: tuple(ts) for f, ts in d["terms_per_field"].items()})
    if tag == "full_text":
        return FullText(d["field"], d["text"], d.get("mode", "or"),
                        d.get("slop", 0), d.get("zero_terms", "none"))
    if tag == "phrase_prefix":
        return PhrasePrefix(d["field"], d["phrase"], d.get("max_expansions", 50),
                            d.get("analyzer"))
    if tag == "wildcard":
        return Wildcard(d["field"], d["pattern"], d.get("case_insensitive", False))
    if tag == "regex":
        return Regex(d["field"], d["pattern"], d.get("case_insensitive", False))
    if tag == "field_presence":
        return FieldPresence(d["field"])
    if tag == "range":
        return Range(d["field"], RangeBound.from_dict(d.get("lower")),
                     RangeBound.from_dict(d.get("upper")), d.get("format"))
    if tag == "bool":
        return Bool(
            must=_seq(d.get("must", [])),
            must_not=_seq(d.get("must_not", [])),
            should=_seq(d.get("should", [])),
            filter=_seq(d.get("filter", [])),
            minimum_should_match=d.get("minimum_should_match"),
        )
    if tag == "boost":
        return Boost(ast_from_dict(d["underlying"]), d["boost"])
    raise ValueError(f"unknown query ast node type: {tag!r}")
