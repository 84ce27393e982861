"""Scoring-term extraction for the impact prefix cutoff.

Subset of the JAX package's `search/pruning.py`: `scoring_terms`, which
`search/plan.py::lower_request` calls when a sort-value threshold is pushed
down. Split-level pruning and the threshold box are not carried over yet.
"""

from __future__ import annotations

from typing import Optional

from ..models.doc_mapper import DocMapper, FieldType
from ..query import ast as Q
from ..query.tokenizers import get_tokenizer
from .predicate_cache import canonical_query_term, term_is_tokenized_text


class _Unboundable(Exception):
    """Query has a score contribution we cannot upper-bound."""


def scoring_terms(ast: Q.QueryAst,
                  doc_mapper: DocMapper) -> Optional[list[tuple[str, str,
                                                                float]]]:
    """(field, canonical_term, boost) triples of every node that can
    contribute to a document's BM25 score, mirroring the tokenization and
    canonicalization of `Lowering.lower` so the terms match term-dictionary
    lookup keys exactly. Returns None when any scoring contribution is
    unboundable (phrase, prefix, wildcard, regex, unknown nodes) — callers
    must then disable score pruning for the query. must_not/filter clauses
    never score and contribute nothing regardless of content."""
    out: list[tuple[str, str, float]] = []
    try:
        _collect_scoring(ast, doc_mapper, out, 1.0)
    except _Unboundable:
        return None
    return out


def _collect_scoring(ast: Q.QueryAst, doc_mapper: DocMapper,
                     out: list[tuple[str, str, float]], boost: float) -> None:
    if isinstance(ast, (Q.MatchAll, Q.MatchNone, Q.Range, Q.FieldPresence)):
        return  # never contribute score
    if isinstance(ast, Q.Boost):
        _collect_scoring(ast.underlying, doc_mapper, out, boost * ast.boost)
        return
    if isinstance(ast, Q.Bool):
        # must/should children score; filter/must_not lower with
        # scoring=False (plan.py Lowering.lower) and contribute nothing
        for clause in (*ast.must, *ast.should):
            _collect_scoring(clause, doc_mapper, out, boost)
        return
    if isinstance(ast, Q.TermSet):
        return  # TermSet postings lower with scoring=False
    if isinstance(ast, Q.Term):
        fm = doc_mapper.field(ast.field)
        if fm is None:
            raise _Unboundable
        if not ast.verbatim and term_is_tokenized_text(fm):
            _collect_scoring(Q.FullText(ast.field, ast.value, "and"),
                             doc_mapper, out, boost)
            return
        if not fm.indexed:
            return  # fast-only ordinal equality: non-scoring
        value = ast.value
        if (not ast.verbatim and fm.type is FieldType.TEXT
                and fm.tokenizer == "lowercase"):
            value = value.lower()
        try:
            out.append((ast.field, canonical_query_term(fm, value), boost))
        except (ValueError, TypeError):
            raise _Unboundable from None
        return
    if isinstance(ast, Q.FullText):
        fm = doc_mapper.field(ast.field)
        if fm is None:
            raise _Unboundable
        if fm.type is not FieldType.TEXT:
            try:
                out.append((ast.field, canonical_query_term(fm, ast.text),
                            boost))
            except (ValueError, TypeError):
                raise _Unboundable from None
            return
        if not fm.indexed:
            return  # fast-only equality: non-scoring
        if ast.mode not in ("and", "or"):
            # phrase / bool_prefix: positional or prefix scoring — the
            # precomputed node's tf distribution is not in the term stats
            raise _Unboundable
        tokens = get_tokenizer(fm.tokenizer)(ast.text)
        out.extend((ast.field, t.text, boost) for t in tokens)
        return
    # PhrasePrefix / Wildcard / Regex / unknown: scoring we cannot bound
    raise _Unboundable
