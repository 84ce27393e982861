"""The port's doc transforms against the JAX package's.

Every script and document of `tests/test_transform.py` (assignments and
paths, arithmetic, strings, conditionals and `drop()`, null semantics,
JSON, precedence, the lexer's minus, the structured parsers, timestamps,
numbers, arrays and hashes) is compiled and applied by both packages'
`indexing/transform.py`. The outcomes must be equal: the output document
(or `None` for a dropped one), or the typed error's class name and
message. The JAX test's expected values are checked as well.
"""

import importlib

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")
MODULES = {root: importlib.import_module(f"{root}.indexing.transform")
           for root in PACKAGES}

# (script, doc, expected): `expected` is a dict of fields the output must
# hold, None for a dropped doc, or the name of the typed error.
CASES = [
    ('.level = uppercase(string(.severity))\n.meta.source = "syslog"',
     {"severity": "warn", "body": "x"},
     {"level": "WARN", "meta": {"source": "syslog"}, "body": "x"}),
    (".b = 2", {"a": 1}, {"a": 1, "b": 2}),
    (".duration_ms = .duration_us / 1000\ndel(.duration_us)",
     {"duration_us": 42_000}, {"duration_ms": 42.0}),
    ('.msg = .service + ": " + trim(.message)\n'
     '.tags = split("a,b,c", ",")\n.joined = join(.tags, "-")\n'
     '.n = length(.tags)', {"service": "api", "message": "  boom  "},
     {"msg": "api: boom", "tags": ["a", "b", "c"], "joined": "a-b-c",
      "n": 3}),
    ('if .status >= 500 { .severity = "ERROR" } else { .severity = "INFO" }'
     '\nif .internal == true { drop() }', {"status": 503},
     {"severity": "ERROR"}),
    ('if .status >= 500 { .severity = "ERROR" } else { .severity = "INFO" }'
     '\nif .internal == true { drop() }', {"status": 200},
     {"severity": "INFO"}),
    ('if .status >= 500 { .severity = "ERROR" } else { .severity = "INFO" }'
     '\nif .internal == true { drop() }', {"status": 200, "internal": True},
     None),
    ('if exists(.user) { .has_user = true } else { .has_user = false }',
     {"user": "a"}, {"has_user": True}),
    ('if exists(.user) { .has_user = true } else { .has_user = false }',
     {}, {"has_user": False}),
    (".s = string(.nope)", {}, {"s": ""}),
    ('# extract nested payload\n.payload = parse_json(.raw)\n'
     '.code = .payload.code', {"raw": '{"code": 7}'}, {"code": 7}),
    (".x = .a / 0", {"a": 1}, "TransformRuntimeError"),
    (".x = lowercase(.n)", {"n": 5}, "TransformRuntimeError"),
    (".x = ", {}, "TransformParseError"),
    ("unknownfn(.a)", {}, "TransformParseError"),
    ("import os", {}, "TransformParseError"),
    ('.x = __import__("os")', {}, "TransformParseError"),
    ('.x = "\\q"', {}, "TransformParseError"),
    (".x = 1 + 2 * 3\n.y = (1 + 2) * 3\n.z = 10 - 2 - 3\n"
     ".b = 1 + 1 == 2 && !false", {},
     {"x": 7, "y": 9, "z": 5, "b": True}),
    (".x = .a - 1\n.y = .a -1\n.z = -1\n.w = 2--1", {"a": 10},
     {"x": 9, "y": 9, "z": -1, "w": 3}),
    (".a = 1", "just a string", "TransformRuntimeError"),
    (".x = int(.a)", {"a": "1e999"}, "TransformRuntimeError"),
    ('.x = split(.a, "")', {"a": "abc"}, "TransformRuntimeError"),
    (".kv = parse_key_value(.line)",
     {"line": 'level=info msg="hello world" code=7'},
     {"kv": {"level": "info", "msg": "hello world", "code": "7"}}),
    (".req = parse_common_log(.line)",
     {"line": '127.0.0.1 - frank [10/Oct/2000:13:55:36 -0700] '
              '"GET /apache_pb.gif HTTP/1.0" 200 2326'}, {}),
    (".log = parse_syslog(.line)",
     {"line": "<34>Oct 11 22:14:15 mymachine su[230]: 'su root' failed"},
     {}),
    (".u = parse_url(.link)",
     {"link": "https://example.com:8443/a/b?x=1&y=2#frag"},
     {"u": {"scheme": "https", "host": "example.com", "port": 8443,
            "path": "/a/b", "query": {"x": "1", "y": "2"},
            "fragment": "frag"}}),
    ('.m = parse_regex(.s, "(?P<user>\\\\w+)@(?P<dom>\\\\w+)")',
     {"s": "bob@example"}, {"m": {"user": "bob", "dom": "example"}}),
    (".ts = to_unix_timestamp(.when)", {"when": "2001-09-09T01:46:40Z"},
     {"ts": 1_000_000_000}),
    (".ts = to_unix_timestamp(.when)", {"when": 123.9}, {"ts": 123}),
    ('.ts = parse_timestamp(.when, "%d/%b/%Y %H:%M:%S")',
     {"when": "09/Sep/2001 01:46:40"}, {"ts": 1_000_000_000}),
    ('.day = format_timestamp(.ts, "%Y-%m-%d")', {"ts": 1_000_000_000},
     {"day": "2001-09-09"}),
    ("\n.r = round(.x)\n.f = floor(.x)\n.c = ceil(.x)\n.a = abs(0 - .x)\n"
     ".first = slice(.tags, 0, 2)\n.short = truncate(.name, 3)\n"
     '.more = push(.tags, "z")\n.all = merge(.obj, .obj2)\n'
     ".h = sha256(.name)\n.enc = encode_json(.obj)\n"
     ".lower = downcase(.name)\n",
     {"x": 2.5, "tags": ["a", "b", "c"], "name": "HELLO",
      "obj": {"k": 1}, "obj2": {"j": 2}},
     {"r": 3, "f": 2, "c": 3, "a": 2.5, "first": ["a", "b"],
      "short": "HEL", "more": ["a", "b", "c", "z"],
      "all": {"k": 1, "j": 2},
      "h": "3733cd977ff8eb18b987357e22ced99f46097f31ecb239e878ae63760e83e4d5",
      "enc": '{"k": 1}', "lower": "hello"}),
    ('.m = parse_regex(.s, "(?P<d>\\\\d+)")', {"s": "no digits here"},
     "TransformRuntimeError"),
    (".x = parse_common_log(.line)", {"line": "not a log line"},
     "TransformRuntimeError"),
    (".x = round(.s)", {"s": "str"}, "TransformRuntimeError"),
    (".u = parse_url(.link)", {"link": "http://host:bad/"},
     "TransformRuntimeError"),
    (".r = round(.x)", {"x": float("inf")}, "TransformRuntimeError"),
    (".r = round(0 - 2.5)", {}, {"r": -3}),
]


def outcome(root, script, doc):
    mod = MODULES[root]
    try:
        transform = mod.Transform(script)
    except mod.TransformParseError as exc:
        return ("TransformParseError", str(exc))
    try:
        return ("ok", transform.apply(doc))
    except mod.TransformRuntimeError as exc:
        return ("TransformRuntimeError", str(exc))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_transform_matches_jax(case):
    script, doc, expected = CASES[case]
    want = outcome("quickwit_tpu", script, doc)
    got = outcome("quickwit_tpu_torch", script, doc)
    assert got == want
    if isinstance(expected, str):
        assert got[0] == expected
    elif expected is None:
        assert got == ("ok", None)
    else:
        assert got[0] == "ok"
        for key, value in expected.items():
            assert got[1][key] == value and \
                type(got[1][key]) is type(value), key


def test_parsed_records_match_jax():
    """The structured parsers' whole records, field by field."""
    for script, doc, _ in CASES[24:26]:
        got = outcome("quickwit_tpu_torch", script, doc)
        assert got == outcome("quickwit_tpu", script, doc)
    req = outcome("quickwit_tpu_torch", *CASES[24][:2])[1]["req"]
    assert (req["host"], req["method"], req["status"], req["size"]) == \
        ("127.0.0.1", "GET", 200, 2326)
    log = outcome("quickwit_tpu_torch", *CASES[25][:2])[1]["log"]
    assert (log["facility"], log["severity"], log["hostname"],
            log["appname"], log["procid"]) == (4, 2, "mymachine", "su", 230)


def test_input_copy_and_in_place():
    for root in PACKAGES:
        mod = MODULES[root]
        doc = {"a": 1}
        assert mod.Transform(".b = 2").apply(doc) == {"a": 1, "b": 2}
        assert doc == {"a": 1}
        out = mod.Transform(".b = 2").apply(doc, copy=False)
        assert out is doc and doc == {"a": 1, "b": 2}


@pytest.mark.parametrize("params", [
    {}, {"transform": None}, {"transform": {"script": ".a = 1"}},
    {"transform": {"script": ""}}, [1]])
def test_from_source_params_matches_jax(params):
    results = []
    for root in PACKAGES:
        mod = MODULES[root]
        try:
            t = mod.transform_from_source_params(params)
            results.append(("ok", None if t is None else t.apply({})))
        except mod.TransformParseError as exc:
            results.append(("TransformParseError", str(exc)))
    assert results[0] == results[1]
