"""Elasticsearch query DSL → QueryAst.

Role of the reference's `quickwit-query/src/elastic_query_dsl/`
(`mod.rs:169` et al.): translate the ES `query` body subset into the
engine's QueryAst. Supported: term, terms, match, match_phrase,
match_phrase_prefix, multi_match, match_all/match_none, bool, range,
exists, wildcard, regexp, prefix, query_string, simple_query_string.
"""

from __future__ import annotations

from typing import Any, Sequence

from .ast import (
    Bool, Boost, FieldPresence, FullText, MatchAll, MatchNone, PhrasePrefix,
    QueryAst, Range, RangeBound, Regex, Term, TermSet, Wildcard,
)
from .parser import parse_query_string


class EsDslParseError(ValueError):
    pass


def _single_kv(body: dict[str, Any], kind: str) -> tuple[str, Any]:
    if len(body) != 1:
        raise EsDslParseError(f"{kind} expects exactly one field, got {list(body)}")
    return next(iter(body.items()))


def _as_clause_list(value) -> list:
    if value is None:
        return []
    return value if isinstance(value, list) else [value]


def es_query_to_ast(query: dict[str, Any],
                    default_search_fields: Sequence[str] = (),
                    lenient_validator=None) -> QueryAst:
    if not isinstance(query, dict) or len(query) != 1:
        raise EsDslParseError(f"query must have exactly one root clause, got {query!r}")
    kind, body = next(iter(query.items()))

    if kind == "match_all":
        return MatchAll()
    if kind == "match_none":
        return MatchNone()
    if kind == "term":
        # ES term queries are NOT analyzed: the value must equal the
        # post-tokenization indexed form (verbatim=True)
        field, spec = _single_kv(body, "term")
        if isinstance(spec, dict):
            # _scalar_str, not str(): JSON true must canonicalize to
            # "true" exactly like the scalar shorthand form
            value = _scalar_str(spec["value"])
            if spec.get("case_insensitive"):
                value = value.lower()
            ast: QueryAst = Term(field, value, verbatim=True)
            if "boost" in spec:
                ast = Boost(ast, float(spec["boost"]))
            return ast
        return Term(field, _scalar_str(spec), verbatim=True)
    if kind == "terms":
        entries = {f: v for f, v in body.items() if f != "boost"}
        field, values = _single_kv(entries, "terms")
        return TermSet({field: tuple(_scalar_str(v) for v in values)})
    if kind == "match":
        field, spec = _single_kv(body, "match")
        if isinstance(spec, dict):
            text = str(spec["query"])
            operator = spec.get("operator", "or").lower()
            zero_terms = str(spec.get("zero_terms_query", "none")).lower()
            ast = FullText(field, text, operator, zero_terms=zero_terms)
            if "boost" in spec:
                ast = Boost(ast, float(spec["boost"]))
            return ast
        return FullText(field, _scalar_str(spec), "or")
    if kind == "match_phrase":
        field, spec = _single_kv(body, "match_phrase")
        if isinstance(spec, dict):
            return FullText(field, str(spec["query"]), "phrase",
                            slop=spec.get("slop", 0))
        return FullText(field, _scalar_str(spec), "phrase")
    if kind == "match_phrase_prefix":
        field, spec = _single_kv(body, "match_phrase_prefix")
        if isinstance(spec, dict):
            analyzer = spec.get("analyzer")
            if analyzer is not None:
                from .tokenizers import known_tokenizer
                if not known_tokenizer(analyzer):
                    raise EsDslParseError(
                        f"unknown analyzer {analyzer!r}")
            return PhrasePrefix(field, str(spec["query"]),
                                max_expansions=spec.get("max_expansions", 50),
                                analyzer=analyzer)
        return PhrasePrefix(field, _scalar_str(spec))
    if kind == "multi_match":
        if body.get("fields") == []:
            raise EsDslParseError("multi_match `fields` must not be empty")
        fields = body.get("fields") or list(default_search_fields)
        if isinstance(fields, str):
            fields = [fields]  # multi_match accepts a single string
        if not fields:
            raise EsDslParseError("multi_match requires fields")
        # ES `field^boost` syntax
        boosts = {}
        parsed_fields = []
        for f in fields:
            name, _, boost = str(f).partition("^")
            parsed_fields.append(name)
            if boost:
                boosts[name] = float(boost)
        fields = parsed_fields
        if lenient_validator is not None:
            # ES drops unknown fields from multi_match regardless of the
            # `lenient` flag (field leniency vs value leniency)
            known = [f for f in fields if lenient_validator(f, None)]
            if not known:
                return MatchNone()
            fields = known
        text = str(body["query"])
        mm_type = body.get("type")
        def boosted(node, f):
            return Boost(node, boosts[f]) if f in boosts else node

        if mm_type == "phrase_prefix":
            max_exp = int(body.get("max_expansions", 50))
            clauses: tuple = tuple(
                boosted(PhrasePrefix(f, text, max_expansions=max_exp), f)
                for f in fields)
        else:
            mode = "phrase" if mm_type == "phrase" else \
                body.get("operator", "or").lower()
            clauses = tuple(
                boosted(FullText(f, text, mode,
                                 slop=int(body.get("slop", 0))), f)
                for f in fields)
        ast = clauses[0] if len(clauses) == 1 else Bool(should=clauses)
        if body.get("lenient") and lenient_validator is not None:
            ast = rewrite_lenient(ast, lenient_validator)
        return ast
    if kind == "match_bool_prefix":
        # every token matches as a term except the last, which matches as
        # a prefix (ES match_bool_prefix)
        field, spec = _single_kv(body, "match_bool_prefix")
        text = str(spec["query"]) if isinstance(spec, dict) else \
            _scalar_str(spec)
        operator = (str(spec.get("operator", "or")).lower()
                    if isinstance(spec, dict) else "or")
        # analysis happens at lowering with the FIELD's tokenizer (the
        # last TOKEN becomes a prefix, not the last space-separated word)
        mode = "bool_prefix_and" if operator == "and" else "bool_prefix_or"
        return FullText(field, text, mode)
    if kind == "bool":
        msm = body.get("minimum_should_match")
        num_should = len(_as_clause_list(body.get("should")))
        return Bool(
            must=tuple(es_query_to_ast(c, default_search_fields, lenient_validator)
                       for c in _as_clause_list(body.get("must"))),
            must_not=tuple(es_query_to_ast(c, default_search_fields, lenient_validator)
                           for c in _as_clause_list(body.get("must_not"))),
            should=tuple(es_query_to_ast(c, default_search_fields, lenient_validator)
                         for c in _as_clause_list(body.get("should"))),
            filter=tuple(es_query_to_ast(c, default_search_fields, lenient_validator)
                         for c in _as_clause_list(body.get("filter"))),
            minimum_should_match=(None if msm is None
                                  else _parse_msm(msm, num_should)),
        )
    if kind == "range":
        field, spec = _single_kv(body, "range")
        lower = upper = None
        if "gte" in spec:
            lower = RangeBound(spec["gte"], True)
        elif "gt" in spec:
            lower = RangeBound(spec["gt"], False)
        if "lte" in spec:
            upper = RangeBound(spec["lte"], True)
        elif "lt" in spec:
            upper = RangeBound(spec["lt"], False)
        return Range(field, lower=lower, upper=upper,
                     format=spec.get("format"))
    if kind == "exists":
        if not isinstance(body, dict) or not isinstance(body.get("field"),
                                                        str):
            raise EsDslParseError("exists expects {\"field\": \"<name>\"}")
        return FieldPresence(body["field"])
    if kind == "wildcard":
        field, spec = _single_kv(body, "wildcard")
        pattern = spec["value"] if isinstance(spec, dict) else spec
        ci = isinstance(spec, dict) and bool(spec.get("case_insensitive"))
        return Wildcard(field, str(pattern), case_insensitive=ci)
    if kind == "regexp":
        field, spec = _single_kv(body, "regexp")
        pattern = spec["value"] if isinstance(spec, dict) else spec
        ci = isinstance(spec, dict) and bool(spec.get("case_insensitive"))
        return Regex(field, str(pattern), case_insensitive=ci)
    if kind == "prefix":
        field, spec = _single_kv(body, "prefix")
        value = spec["value"] if isinstance(spec, dict) else spec
        ci = isinstance(spec, dict) and bool(spec.get("case_insensitive"))
        return Wildcard(field, f"{value}*", case_insensitive=ci)
    if kind in ("query_string", "simple_query_string"):
        if "fields" in body and not isinstance(body["fields"], list):
            # ES rejects a bare-string `fields` (400); only `default_field`
            # takes a single string
            raise EsDslParseError("query_string `fields` must be an array")
        if body.get("fields") and body.get("default_field"):
            raise EsDslParseError(
                "query_string cannot set both `fields` and `default_field`")
        fields = body.get("fields") or body.get("default_field") or \
            list(default_search_fields)
        if isinstance(fields, str):
            fields = [fields]
        ast = parse_query_string(body["query"], fields)
        if body.get("lenient") and lenient_validator is not None:
            ast = rewrite_lenient(ast, lenient_validator)
        return ast
    raise EsDslParseError(f"unsupported query kind {kind!r}")


def rewrite_lenient(ast: QueryAst, valid) -> QueryAst:
    """ES `lenient: true`: clauses referencing unknown fields or carrying
    values the field type cannot parse become match-none instead of
    erroring. `valid(field, value_or_None) -> bool` is supplied by the
    serve layer, which owns the doc mapper."""
    if isinstance(ast, Bool):
        return Bool(
            must=tuple(rewrite_lenient(c, valid) for c in ast.must),
            must_not=tuple(rewrite_lenient(c, valid) for c in ast.must_not),
            should=tuple(rewrite_lenient(c, valid) for c in ast.should),
            filter=tuple(rewrite_lenient(c, valid) for c in ast.filter),
            minimum_should_match=ast.minimum_should_match)
    if isinstance(ast, Boost):
        return Boost(rewrite_lenient(ast.underlying, valid), ast.boost)
    if isinstance(ast, Term):
        return ast if valid(ast.field, ast.value) else MatchNone()
    if isinstance(ast, FullText):
        return ast if valid(ast.field, ast.text) else MatchNone()
    if isinstance(ast, Range):
        ok = all(valid(ast.field, b.value)
                 for b in (ast.lower, ast.upper) if b is not None)
        return ast if ok and valid(ast.field, None) else MatchNone()
    if isinstance(ast, (Wildcard, Regex, PhrasePrefix, FieldPresence)):
        field = ast.field
        return ast if valid(field, None) else MatchNone()
    if isinstance(ast, TermSet):
        ok = all(valid(f, t) for f, ts in ast.terms_per_field.items()
                 for t in ts)
        return ast if ok else MatchNone()
    return ast


def _parse_msm(msm: Any, num_should: int) -> int:
    """ES minimum_should_match: integer, negative integer (n - |value|),
    or percentage ("50%" / "-25%") of the number of should clauses."""
    if isinstance(msm, str) and msm.strip().endswith("%"):
        pct = float(msm.strip()[:-1])
        if pct < 0:
            return num_should - int(num_should * (-pct) / 100.0)
        return int(num_should * pct / 100.0)
    value = int(msm)
    if value < 0:
        return max(num_should + value, 0)
    return value


def _scalar_str(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)
