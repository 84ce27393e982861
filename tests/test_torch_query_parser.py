"""The port's query-string and ES-DSL parsers against the JAX package's.

Every string of `tests/test_query.py`, every ES-DSL body kind of
`query/es_dsl.py` (with its options and its errors) and a sample that
hypothesis draws from the query-string grammar go through both packages'
`parse_query_string` / `es_query_to_ast`: the ASTs must have the same
`to_dict()`, and an input one package rejects the other must reject with
the same error class name and message.
"""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from quickwit_tpu import query as j_query
from quickwit_tpu.query import es_dsl as j_es
from quickwit_tpu_torch import query as t_query
from quickwit_tpu_torch.query import es_dsl as t_es

QUERY_STRINGS = [
    # tests/test_query.py
    "severity_text:ERROR", "severity_text:ERROR AND tenant_id:22",
    "a:1 OR b:2", "+a:1 -b:2", "tenant_id:[10 TO 20}",
    "timestamp:>=2021-01-01T00:00:00Z", '"connection refused"', "refused",
    "*", "f:*", "f:ab*", "f: IN [a b c]", "(a:1 OR b:2) AND c:3",
    "a:1 b:2 AND c:3", "tenant_id:[-5 TO 20]", "f:IN [a b c]", "f:*ab",
    "f:a?b", "-a:1",
    # the root's requests and the other grammar corners
    "severity_text:ERROR AND NOT tenant_id:3", "tenant:1 AND severity:ERROR",
    "status:[300 TO 400} AND latency:>10.5", "(tenant:1)^2",
    "body:error^3 OR body:warn", "a:1 AND (b:2 OR (c:3 AND -d:4))",
    "latency:<=99.5", "latency:<10", "x:[* TO 5]", "x:{1 TO *}",
    'body:"disk full"~2', 'title:"quick brown"', "NOT a:1", "a:1 && b:2",
    "a:1 || b:2", "!a:1", "f:/ab.*c/", "ts:[2021-01-01 TO 2021-02-01]",
    "a:b\\:c", "a:1 AND", "field:", "(a:1", "a:1)", "a:[1 TO", "",
    "   ", "AND", "a:1 OR OR b:2", ":x", "f: IN []",
]

ES_BODIES = [
    {"match_all": {}}, {"match_none": {}},
    {"term": {"severity": "ERROR"}}, {"term": {"flag": True}},
    {"term": {"n": 42}},
    {"term": {"severity": {"value": "Error", "case_insensitive": True}}},
    {"term": {"severity": {"value": "ERROR", "boost": 2.5}}},
    {"terms": {"severity": ["INFO", "WARN"], "boost": 1.0}},
    {"terms": {"n": [1, 2, 3]}},
    {"match": {"body": "disk full"}},
    {"match": {"body": {"query": "disk full", "operator": "AND",
                        "zero_terms_query": "all", "boost": 2}}},
    {"match_phrase": {"body": "disk full"}},
    {"match_phrase": {"body": {"query": "disk full", "slop": 2}}},
    {"match_phrase_prefix": {"body": "disk fu"}},
    {"match_phrase_prefix": {"body": {"query": "disk fu",
                                      "max_expansions": 10,
                                      "analyzer": "default"}}},
    {"match_phrase_prefix": {"body": {"query": "x", "analyzer": "nope"}}},
    {"multi_match": {"query": "disk", "fields": ["body", "title^2"]}},
    {"multi_match": {"query": "disk", "fields": "body"}},
    {"multi_match": {"query": "disk full", "type": "phrase",
                     "fields": ["body"], "slop": 1}},
    {"multi_match": {"query": "disk fu", "type": "phrase_prefix",
                     "fields": ["body", "title"], "max_expansions": 5}},
    {"multi_match": {"query": "disk"}},
    {"multi_match": {"query": "disk", "fields": []}},
    {"match_bool_prefix": {"body": "quick brown f"}},
    {"match_bool_prefix": {"body": {"query": "quick brown f",
                                    "operator": "and"}}},
    {"bool": {"must": [{"match": {"body": "common"}}],
              "filter": [{"range": {"status": {"gte": 300, "lt": 500}}}]}},
    {"bool": {"must": {"term": {"a": "1"}},
              "should": [{"term": {"b": "2"}}, {"term": {"c": "3"}}],
              "must_not": [{"exists": {"field": "d"}}],
              "minimum_should_match": 1}},
    {"bool": {"should": [{"term": {"b": "2"}}, {"term": {"c": "3"}},
                         {"term": {"e": "5"}}],
              "minimum_should_match": "66%"}},
    {"bool": {"should": [{"term": {"b": "2"}}, {"term": {"c": "3"}}],
              "minimum_should_match": -1}},
    {"range": {"ts": {"gt": "2021-01-01", "lte": "2021-02-01",
                      "format": "yyyy-MM-dd"}}},
    {"range": {"latency": {"gte": 1.5}}}, {"range": {"latency": {"lt": 0}}},
    {"exists": {"field": "latency"}}, {"exists": {"field": 3}},
    {"exists": "latency"},
    {"wildcard": {"host": "web-*"}},
    {"wildcard": {"host": {"value": "WEB-*", "case_insensitive": True}}},
    {"regexp": {"host": "web-[0-9]+"}},
    {"regexp": {"host": {"value": "web.*", "case_insensitive": True}}},
    {"prefix": {"host": "web"}},
    {"prefix": {"host": {"value": "Web", "case_insensitive": True}}},
    {"query_string": {"query": "severity:ERROR AND disk"}},
    {"query_string": {"query": "disk", "fields": ["body", "title"]}},
    {"query_string": {"query": "disk", "default_field": "title"}},
    {"query_string": {"query": "disk", "fields": "body"}},
    {"query_string": {"query": "disk", "fields": ["body"],
                      "default_field": "title"}},
    {"simple_query_string": {"query": "disk full"}},
    {"geo_shape": {"location": {}}}, {}, {"term": {}, "match": {}},
    {"term": {"a": "1", "b": "2"}},
    "not a dict",
]


def outcome(fn, *args):
    """An AST's dict, or the error an input raises (class name and
    message: the two packages' exception classes are distinct types)."""
    try:
        return ("ok", fn(*args).to_dict())
    except Exception as exc:  # noqa: BLE001 - the error IS the outcome
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("text", QUERY_STRINGS)
@pytest.mark.parametrize("fields", [(), ("body",), ("body", "title")])
def test_query_string_matches_jax(text, fields):
    want = outcome(j_query.parse_query_string, text, list(fields))
    got = outcome(t_query.parse_query_string, text, list(fields))
    assert got == want


@pytest.mark.parametrize("body", ES_BODIES, ids=lambda b: str(b)[:48])
def test_es_dsl_matches_jax(body):
    want = outcome(j_es.es_query_to_ast, body, ["body"])
    got = outcome(t_es.es_query_to_ast, body, ["body"])
    assert got == want


def test_es_dsl_lenient_rewrite_matches_jax():
    """`lenient` drops clauses on fields the validator rejects."""
    def valid(field, value):
        return field in ("body", "severity")

    for body in ({"multi_match": {"query": "disk", "lenient": True,
                                  "fields": ["body", "nope", "title"]}},
                 {"multi_match": {"query": "disk", "fields": ["nope"]}},
                 {"query_string": {"query": "severity:ERROR OR nope:x",
                                   "lenient": True}}):
        want = outcome(j_es.es_query_to_ast, body, ["body"], valid)
        got = outcome(t_es.es_query_to_ast, body, ["body"], valid)
        assert got == want


def test_ast_from_dict_round_trips_across_packages():
    """An AST serialized by one package rebuilds in the other."""
    for text in QUERY_STRINGS:
        want = outcome(j_query.parse_query_string, text, ["body"])
        if want[0] != "ok":
            continue
        assert t_query.ast_from_dict(want[1]).to_dict() == want[1]
        assert j_query.ast_from_dict(want[1]).to_dict() == want[1]


def test_query_package_exports_match():
    assert sorted(t_query.__all__) == sorted(j_query.__all__)
    for tokenizer in ("default", "raw", "en_stem", "source_code_default"):
        text = "Running getHTTPResponse_fooBar42, Hello World-42"
        assert ([t.text for t in t_query.get_tokenizer(tokenizer)(text)]
                == [t.text for t in j_query.get_tokenizer(tokenizer)(text)])


# --------------------------------------------------------------------------
# a hypothesis sample of the query-string grammar

FIELDS = st.sampled_from(["a", "body", "severity_text", "tenant_id", "f"])
WORDS = st.sampled_from(["x", "ERROR", "42", "-5", "1.5", "ab*", "a?b",
                         "2021-01-01T00:00:00Z", "disk", "*", "", "IN"])


@st.composite
def clauses(draw, depth=0):
    kind = draw(st.sampled_from(
        ["term", "bare", "phrase", "range", "cmp", "set", "group"]
        if depth < 2 else ["term", "bare", "phrase", "range", "cmp"]))
    field = draw(FIELDS)
    if kind == "term":
        text = f"{field}:{draw(WORDS)}"
    elif kind == "bare":
        text = draw(WORDS)
    elif kind == "phrase":
        text = f'{field}:"{draw(WORDS)} {draw(WORDS)}"'
    elif kind == "range":
        lo, hi = draw(st.sampled_from("[{")), draw(st.sampled_from("]}"))
        text = f"{field}:{lo}{draw(WORDS)} TO {draw(WORDS)}{hi}"
    elif kind == "cmp":
        op = draw(st.sampled_from([">", ">=", "<", "<="]))
        text = f"{field}:{op}{draw(WORDS)}"
    elif kind == "set":
        text = f"{field}: IN [{draw(WORDS)} {draw(WORDS)}]"
    else:
        inner = draw(st.lists(clauses(depth + 1), min_size=1, max_size=3))
        joiner = draw(st.sampled_from([" AND ", " OR ", " "]))
        text = "(" + joiner.join(inner) + ")"
    prefix = draw(st.sampled_from(["", "", "+", "-", "NOT "]))
    boost = draw(st.sampled_from(["", "", "^2"]))
    return prefix + text + boost


@st.composite
def query_strings(draw):
    parts = draw(st.lists(clauses(), min_size=1, max_size=4))
    out = parts[0]
    for part in parts[1:]:
        out += draw(st.sampled_from([" AND ", " OR ", " ", " && "])) + part
    return out


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(query_strings())
def test_generated_query_strings_match_jax(text):
    want = outcome(j_query.parse_query_string, text, ["body"])
    got = outcome(t_query.parse_query_string, text, ["body"])
    assert got == want
