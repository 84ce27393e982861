"""Query-string language parser.

Role of the reference's query-language parser (quickwit-query's
`query_string_query` path, itself a mini-Lucene grammar): turns strings like

    severity_text:ERROR AND resource.service:web
    (foo OR bar) -baz tenant_id:[10 TO 20} timestamp:>=2021-01-01T00:00:00Z
    body:"connection refused" field:IN [a b c] *

into a `QueryAst`. Subset implemented: field:term, quoted phrases, AND/OR/NOT,
+/- prefixes, parentheses, range syntax `[a TO b]` / `{a TO b}` and
comparison shorthands (>=, >, <=, <), `IN [..]` term sets, `*` match-all,
`field:*` presence. Bare terms search `default_search_fields`.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

from .ast import (
    Bool, FieldPresence, FullText, MatchAll, PhrasePrefix, QueryAst, Range,
    RangeBound, Term, TermSet, Wildcard,
)

_TOKEN_RE = re.compile(
    r"""
    \s*(
        \(|\)|                                # parens
        \[|\]|\{|\}|                          # range brackets
        "(?:[^"\\]|\\.)*"|                    # quoted phrase
        AND\b|OR\b|NOT\b|TO\b|IN\b|           # keywords
        [+\-]|                                # occur prefixes
        [^\s()\[\]{}"]+                       # bare word (may contain field:)
    )""",
    re.VERBOSE,
)


class QueryParseError(ValueError):
    pass


def _tokenize(text: str) -> list[str]:
    tokens: list[str] = []
    idx = 0
    while idx < len(text):
        m = _TOKEN_RE.match(text, idx)
        if not m:
            if text[idx:].strip():
                raise QueryParseError(f"cannot tokenize query at: {text[idx:]!r}")
            break
        tokens.append(m.group(1))
        idx = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: list[str], default_fields: Sequence[str]):
        self.tokens = tokens
        self.pos = 0
        self.default_fields = list(default_fields)

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise QueryParseError("unexpected end of query")
        self.pos += 1
        return tok

    # Grammar: or_expr := and_expr (OR and_expr)*
    #          and_expr := unary (AND? unary)*   (implicit AND on adjacency... like
    #          quickwit, adjacent clauses without operator are `should` clauses)
    def parse(self) -> QueryAst:
        ast = self.parse_or()
        if self.peek() is not None:
            raise QueryParseError(f"trailing tokens: {self.tokens[self.pos:]}")
        return ast

    def parse_or(self) -> QueryAst:
        clauses = [self.parse_and()]
        while self.peek() == "OR":
            self.next()
            clauses.append(self.parse_and())
        if len(clauses) == 1:
            return clauses[0]
        return Bool(should=tuple(clauses))

    def parse_and(self) -> QueryAst:
        # AND promotes only the clauses immediately adjacent to it (Lucene
        # classic semantics): `a:1 b:2 AND c:3` keeps a:1 optional.
        items: list[tuple[str, QueryAst]] = []  # (occur, clause)
        pending_and = False
        while True:
            tok = self.peek()
            if tok is None or tok in (")", "OR"):
                break
            if tok == "AND":
                self.next()
                if items and items[-1][0] == "should":
                    items[-1] = ("must", items[-1][1])
                pending_and = True
                continue
            occur = None
            if tok in ("+", "-"):
                occur = self.next()
                tok = self.peek()
            if tok == "NOT":
                self.next()
                items.append(("must_not", self.parse_unary()))
                pending_and = False
                continue
            clause = self.parse_unary()
            if occur == "+":
                items.append(("must", clause))
            elif occur == "-":
                items.append(("must_not", clause))
            elif pending_and:
                items.append(("must", clause))
            else:
                items.append(("should", clause))
            pending_and = False
        if not items:
            raise QueryParseError("empty clause")
        if len(items) == 1 and items[0][0] in ("must", "should"):
            return items[0][1]
        return Bool(
            must=tuple(c for o, c in items if o == "must"),
            must_not=tuple(c for o, c in items if o == "must_not"),
            should=tuple(c for o, c in items if o == "should"),
        )

    def parse_unary(self) -> QueryAst:
        tok = self.next()
        if tok == "(":
            inner = self.parse_or()
            if self.next() != ")":
                raise QueryParseError("expected ')'")
            return inner
        if tok == "*":
            return MatchAll()
        if tok.startswith('"'):
            return self._phrase(None, tok)
        # field:value?
        field, value = self._split_field(tok)
        if value == "" and field is not None:
            # `field:` followed by complex value token (range, quoted, IN)
            nxt = self.peek()
            if nxt in ("[", "{"):
                return self._range(field)
            if nxt is not None and nxt.startswith('"'):
                return self._phrase(field, self.next())
            if nxt == "IN":
                self.next()
                return self._term_set(field)
            raise QueryParseError(f"missing value for field {field!r}")
        if field is not None:
            if value == "*":
                return FieldPresence(field)
            if value == "IN" and self.peek() == "[":
                return self._term_set(field)
            for op, incl in ((">=", True), ("<=", True), (">", False), ("<", False)):
                if value.startswith(op):
                    bound = RangeBound(value[len(op):], incl)
                    if op.startswith(">"):
                        return Range(field, lower=bound)
                    return Range(field, upper=bound)
            if value.startswith('"'):
                return self._phrase(field, value)
            if value.startswith("'"):
                # single-quoted phrase: `field:'AB CD'` — quotes ride
                # inside bare tokens, so join tokens to the closing quote
                parts = [value]
                while not (parts[-1].endswith("'")
                           and (len(parts) > 1 or len(parts[0]) > 1)):
                    nxt = self.peek()
                    if nxt is None:
                        raise QueryParseError("unclosed ' phrase")
                    parts.append(self.next())
                return self._phrase(field, '"' + " ".join(parts)[1:-1] + '"')
            unescaped = value.replace("\\*", "\x00").replace("\\?", "\x01")
            if "*" in unescaped or "?" in unescaped:
                # escaped wildcards match literally (fnmatch classes)
                return Wildcard(field, unescaped.replace("\x00", "[*]")
                                .replace("\x01", "[?]"))
            return Term(field, unescaped.replace("\x00", "*")
                        .replace("\x01", "?"))
        # bare term → full-text over default fields
        return self._default_field_query(tok)

    def _default_field_query(self, text: str) -> QueryAst:
        if not self.default_fields:
            raise QueryParseError(
                f"bare term {text!r} requires default_search_fields")
        # bare comparison shorthand applies as a range on the default
        # field(s): `default_field: x, query: ">=10"` (ES query_string)
        for op, incl in ((">=", True), ("<=", True), (">", False),
                         ("<", False)):
            if text.startswith(op):
                bound = RangeBound(text[len(op):], incl)
                ranges = [Range(f, lower=bound) if op.startswith(">")
                          else Range(f, upper=bound)
                          for f in self.default_fields]
                return ranges[0] if len(ranges) == 1 else \
                    Bool(should=tuple(ranges))
        unescaped = text.replace("\\*", "\x00").replace("\\?", "\x01")
        if ("*" in unescaped or "?" in unescaped) and text != "*":
            # bare wildcard over the default fields (ES query_string);
            # ESCAPED wildcards become fnmatch character classes so they
            # match literally
            pattern = (unescaped.replace("\x00", "[*]")
                       .replace("\x01", "[?]"))
            wilds = [Wildcard(f, pattern) for f in self.default_fields]
            return wilds[0] if len(wilds) == 1 else Bool(should=tuple(wilds))
        # escaped wildcards are literal characters, not operators
        text = unescaped.replace("\x00", "*").replace("\x01", "?")
        clauses = [FullText(f, text, "or") for f in self.default_fields]
        if len(clauses) == 1:
            return clauses[0]
        return Bool(should=tuple(clauses))

    @staticmethod
    def _split_field(tok: str) -> tuple[Optional[str], str]:
        # field names may contain dots; split at the first colon not in the value
        if ":" in tok:
            field, value = tok.split(":", 1)
            if field:
                return field, value
        return None, tok

    def _phrase(self, field: Optional[str], tok: str) -> QueryAst:
        text = re.sub(r"\\(.)", r"\1", tok[1:-1])
        prefix = False
        if self.peek() == "*":
            self.next()
            prefix = True
        if field is None:
            if not self.default_fields:
                raise QueryParseError("phrase requires a field or default_search_fields")
            fields = self.default_fields
        else:
            fields = [field]
        if prefix:
            clauses: list[QueryAst] = [PhrasePrefix(f, text) for f in fields]
        else:
            clauses = [FullText(f, text, "phrase") for f in fields]
        return clauses[0] if len(clauses) == 1 else Bool(should=tuple(clauses))

    def _range_value(self) -> str:
        # numbers may tokenize as a sign token followed by digits
        tok = self.next()
        if tok in ("+", "-"):
            tok = tok + self.next()
        if tok.startswith('"'):
            # reference parity: the query language has no quoted (or
            # whitespace-escaped) range bounds — use the ES API instead
            raise QueryParseError("range bounds do not support quoted values")
        return tok

    def _range(self, field: str) -> QueryAst:
        open_tok = self.next()
        lower_incl = open_tok == "["
        lo = self._range_value()
        if self.next() != "TO":
            raise QueryParseError("expected TO in range")
        hi = self._range_value()
        close_tok = self.next()
        if close_tok not in ("]", "}"):
            raise QueryParseError("expected ] or } closing range")
        upper_incl = close_tok == "]"
        lower = None if lo == "*" else RangeBound(lo, lower_incl)
        upper = None if hi == "*" else RangeBound(hi, upper_incl)
        return Range(field, lower=lower, upper=upper)

    def _term_set(self, field: str) -> QueryAst:
        if self.next() != "[":
            raise QueryParseError("expected [ after IN")
        terms: list[str] = []
        while True:
            tok = self.next()
            if tok == "]":
                break
            terms.append(tok)
        return TermSet({field: tuple(terms)})


def parse_query_string(query: str, default_search_fields: Sequence[str] = ()) -> QueryAst:
    query = query.strip()
    if not query or query == "*":
        return MatchAll()
    return _Parser(_tokenize(query), default_search_fields).parse()
