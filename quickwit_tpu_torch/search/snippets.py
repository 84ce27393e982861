"""Snippet (highlight) generation for fetched docs.

Role of tantivy's SnippetGenerator used by the reference's fetch-docs phase:
extract a fragment of each requested field around query-term matches and
wrap matches in <em> tags (ES highlight convention).
"""

from __future__ import annotations

import re
from typing import Any

from ..query import ast as Q
from ..query.tokenizers import get_tokenizer

MAX_FRAGMENT_CHARS = 150


def _terms_for_field(ast: Q.QueryAst, field: str, out: set[str]) -> None:
    if isinstance(ast, Q.Term) and ast.field == field:
        out.add(ast.value.lower())
    elif isinstance(ast, Q.FullText) and ast.field == field:
        for token in get_tokenizer("default")(ast.text):
            out.add(token.text)
    elif isinstance(ast, Q.TermSet):
        for term in ast.terms_per_field.get(field, ()):
            out.add(term.lower())
    elif isinstance(ast, Q.Bool):
        for child in ast.must + ast.should + ast.filter:
            _terms_for_field(child, field, out)
    elif isinstance(ast, Q.Boost):
        _terms_for_field(ast.underlying, field, out)


def generate_snippets(doc: dict[str, Any], fields: tuple[str, ...],
                      ast: Q.QueryAst) -> dict[str, list[str]]:
    snippets: dict[str, list[str]] = {}
    for field in fields:
        value = doc
        for key in field.split("."):
            if not isinstance(value, dict) or key not in value:
                value = None
                break
            value = value[key]
        if not isinstance(value, str):
            continue
        terms: set[str] = set()
        _terms_for_field(ast, field, terms)
        if not terms:
            continue
        pattern = re.compile(
            r"\b(" + "|".join(re.escape(t) for t in sorted(terms)) + r")\b",
            re.IGNORECASE)
        match = pattern.search(value)
        if match is None:
            continue
        start = max(0, match.start() - MAX_FRAGMENT_CHARS // 2)
        end = min(len(value), start + MAX_FRAGMENT_CHARS)
        fragment = value[start:end]
        highlighted = pattern.sub(lambda m: f"<em>{m.group(0)}</em>", fragment)
        snippets[field] = [highlighted]
    return snippets
