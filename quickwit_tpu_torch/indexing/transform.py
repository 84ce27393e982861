"""Doc transforms: a small, parsed VRL-analogue applied before mapping.

Role of the reference's VRL source transforms
(`quickwit-indexing/src/actors/doc_processor.rs:94` — a per-source
`transform: script` compiled once and run on every ingested doc before the
doc mapper). VRL itself is a Rust DSL; this is a deliberately small,
side-effect-free expression language with the same shape: field paths,
assignments, `del`/`drop`, conditionals, and a fixed function library.
Scripts are parsed once into closures — no Python `eval`, no attribute
access, no IO — so untrusted index configs cannot escape the doc.

Grammar (statements separated by newlines or `;`):

    .path.to.field = <expr>          # assignment (creates nested objects)
    del(.field)                      # remove a field
    drop()                           # discard the whole doc (filtering)
    if <expr> { stmts } [else { stmts }]

Expressions: literals (numbers, "strings", true/false/null), field refs
(`.a.b`), `( )`, unary `-`/`!`, binary `+ - * / %`, comparisons
`== != < <= > >=`, boolean `&& ||`, and function calls. `+` concatenates
when either side is a string.

Functions: string, int, float, bool, lowercase/downcase,
uppercase/upcase, trim, replace(s, from, to), contains(s, sub),
starts_with(s, p), ends_with(s, p), split(s, sep), join(arr, sep),
length(x), exists(.f), now() (epoch seconds), parse_json(s),
encode_json(x), round/floor/ceil/abs, slice(x, lo, hi),
truncate(s, n), push(arr, v), merge(obj, obj), md5/sha1/sha256,
to_unix_timestamp(x), parse_timestamp(s, fmt),
format_timestamp(secs, fmt), parse_regex(s, pattern) (named groups),
parse_key_value(s) (logfmt), parse_common_log(s) (Apache CLF/combined),
parse_syslog(s) (RFC3164), parse_url(s).

Failure semantics match VRL's abort-on-error default: any runtime error
(type mismatch, bad function arg) makes the doc invalid — counted and
dropped by the pipeline, never published half-transformed.

Carried over whole from the JAX package's `indexing/transform.py`.
"""

from __future__ import annotations

import datetime as _dt
import functools
import hashlib
import json
import math
import re
import time
from typing import Any, Callable, Optional
from urllib.parse import urlsplit, parse_qsl


class TransformParseError(Exception):
    """Script rejected at compile time."""


class TransformRuntimeError(Exception):
    """Per-doc evaluation failure (doc becomes invalid)."""


class _Drop(Exception):
    """Control-flow: drop() discards the current doc."""


# --------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t]+)
  | (?P<comment>\#[^\n]*)
  | (?P<newline>[\n;]+)
  | (?P<path>\.[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>==|!=|<=|>=|&&|\|\||[=<>+\-*/%!(){},])
""", re.VERBOSE)

_KEYWORDS = ("if", "else", "true", "false", "null")


def _tokenize(script: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(script):
        m = _TOKEN_RE.match(script, pos)
        if m is None:
            raise TransformParseError(
                f"unexpected character {script[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        tokens.append((kind, m.group()))
    tokens.append(("eof", ""))
    return tokens


# --------------------------------------------------------------------------
# runtime helpers (the function library)

def _fn_string(x):
    if x is None:
        return ""
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, (dict, list)):
        return json.dumps(x)
    return str(x)


def _fn_int(x):
    try:
        return int(float(x)) if isinstance(x, str) else int(x)
    except (TypeError, ValueError) as exc:
        raise TransformRuntimeError(f"int(): {exc}")


def _fn_float(x):
    try:
        return float(x)
    except (TypeError, ValueError) as exc:
        raise TransformRuntimeError(f"float(): {exc}")


def _str_arg(name: str, x) -> str:
    if not isinstance(x, str):
        raise TransformRuntimeError(f"{name}() requires a string, got "
                                    f"{type(x).__name__}")
    return x


def _fn_parse_json(x):
    try:
        return json.loads(_str_arg("parse_json", x))
    except ValueError as exc:
        raise TransformRuntimeError(f"parse_json(): {exc}")


def _fn_length(x):
    if isinstance(x, (str, list, dict)):
        return len(x)
    raise TransformRuntimeError(
        f"length() requires string/array/object, got {type(x).__name__}")


def _fn_join(arr, sep):
    if not isinstance(arr, list):
        raise TransformRuntimeError("join() requires an array")
    return _str_arg("join", sep).join(_fn_string(v) for v in arr)


def _num_arg(name: str, x) -> float:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise TransformRuntimeError(f"{name}() requires a number, got "
                                    f"{type(x).__name__}")
    return x


@functools.lru_cache(maxsize=256)
def _compiled_regex(pattern: str) -> "re.Pattern":
    try:
        return re.compile(pattern)
    except re.error as exc:
        raise TransformRuntimeError(f"parse_regex(): bad pattern: {exc}")


def _fn_parse_regex(s, pattern):
    """Named capture groups -> object (VRL parse_regex!); no match is a
    per-doc error, like VRL's abort-on-error default."""
    m = _compiled_regex(_str_arg("parse_regex", pattern)).search(
        _str_arg("parse_regex", s))
    if m is None:
        raise TransformRuntimeError("parse_regex(): no match")
    out = {k: v for k, v in m.groupdict().items() if v is not None}
    if not out:  # positional groups fall back to _0.._n
        out = {f"_{i}": g for i, g in enumerate(m.groups(), 1)
               if g is not None}
    return out


_KV_RE = re.compile(r'([A-Za-z0-9_.\-]+)=("(?:[^"\\]|\\.)*"|\S*)')


def _fn_parse_key_value(s):
    """logfmt-style `k=v k2="quoted v"` -> object (VRL
    parse_key_value!)."""
    out = {}
    for key, raw in _KV_RE.findall(_str_arg("parse_key_value", s)):
        if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
            try:
                out[key] = json.loads(raw)
            except ValueError:
                out[key] = raw[1:-1]
        else:
            out[key] = raw
    return out


_CLF_RE = re.compile(
    r'^(?P<host>\S+) (?P<identity>\S+) (?P<user>\S+) '
    r'\[(?P<timestamp>[^\]]+)\] "(?P<method>\S+) (?P<path>\S+)'
    r'(?: (?P<protocol>[^"]+))?" (?P<status>\d{3}) (?P<size>\d+|-)'
    r'(?: "(?P<referrer>[^"]*)" "(?P<user_agent>[^"]*)")?')


def _fn_parse_common_log(s):
    """Apache common/combined log format -> object (VRL
    parse_common_log! / parse_apache_log!)."""
    m = _CLF_RE.match(_str_arg("parse_common_log", s))
    if m is None:
        raise TransformRuntimeError("parse_common_log(): no match")
    out = {k: v for k, v in m.groupdict().items() if v is not None}
    out["status"] = int(out["status"])
    out["size"] = 0 if out["size"] == "-" else int(out["size"])
    return out


_SYSLOG_RE = re.compile(
    r'^<(?P<pri>\d{1,3})>(?P<timestamp>[A-Z][a-z]{2} [ \d]\d '
    r'\d{2}:\d{2}:\d{2}) (?P<hostname>\S+) '
    r'(?P<appname>[^\[:\s]+)(?:\[(?P<procid>\d+)\])?: ?(?P<message>.*)$')


def _fn_parse_syslog(s):
    """RFC3164 syslog line -> object with facility/severity split out
    (VRL parse_syslog!)."""
    m = _SYSLOG_RE.match(_str_arg("parse_syslog", s))
    if m is None:
        raise TransformRuntimeError("parse_syslog(): no match")
    out = {k: v for k, v in m.groupdict().items() if v is not None}
    pri = int(out.pop("pri"))
    out["facility"] = pri // 8
    out["severity"] = pri % 8
    if "procid" in out:
        out["procid"] = int(out["procid"])
    return out


def _fn_parse_url(s):
    parts = urlsplit(_str_arg("parse_url", s))
    out: dict[str, Any] = {"scheme": parts.scheme, "host": parts.hostname,
                           "path": parts.path}
    if parts.port is not None:
        out["port"] = parts.port
    if parts.query:
        out["query"] = dict(parse_qsl(parts.query))
    if parts.fragment:
        out["fragment"] = parts.fragment
    return out


_TS_FORMATS = ("%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z",
               "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
               "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d")


def _fn_to_unix_timestamp(x):
    """Epoch seconds from a number (pass-through) or an RFC3339-ish
    string (VRL to_unix_timestamp)."""
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return int(x)
    text = _str_arg("to_unix_timestamp", x).replace("Z", "+00:00")
    for fmt in _TS_FORMATS:
        try:
            parsed = _dt.datetime.strptime(text, fmt)
        except ValueError:
            continue
        if parsed.tzinfo is None:
            parsed = parsed.replace(tzinfo=_dt.timezone.utc)
        return int(parsed.timestamp())
    raise TransformRuntimeError(
        f"to_unix_timestamp(): unrecognized timestamp {x!r}")


def _fn_parse_timestamp(s, fmt):
    """strptime with an explicit format -> epoch seconds (VRL
    parse_timestamp!)."""
    try:
        parsed = _dt.datetime.strptime(_str_arg("parse_timestamp", s),
                                       _str_arg("parse_timestamp", fmt))
    except ValueError as exc:
        raise TransformRuntimeError(f"parse_timestamp(): {exc}")
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=_dt.timezone.utc)
    return int(parsed.timestamp())


def _fn_format_timestamp(ts, fmt):
    """Epoch seconds -> string via strftime, UTC (VRL
    format_timestamp!)."""
    try:
        moment = _dt.datetime.fromtimestamp(
            _num_arg("format_timestamp", ts), tz=_dt.timezone.utc)
    except (OverflowError, OSError, ValueError) as exc:
        raise TransformRuntimeError(f"format_timestamp(): {exc}")
    return moment.strftime(_str_arg("format_timestamp", fmt))


def _fn_slice(x, start, end):
    lo = int(_num_arg("slice", start))
    hi = int(_num_arg("slice", end))
    if isinstance(x, (str, list)):
        return x[lo:hi]
    raise TransformRuntimeError(
        f"slice() requires string/array, got {type(x).__name__}")


def _fn_push(arr, value):
    if not isinstance(arr, list):
        raise TransformRuntimeError("push() requires an array")
    return arr + [value]


def _fn_merge(a, b):
    if not isinstance(a, dict) or not isinstance(b, dict):
        raise TransformRuntimeError("merge() requires two objects")
    return {**a, **b}


_FUNCTIONS: dict[str, tuple[int, Callable]] = {
    "string": (1, _fn_string),
    "int": (1, _fn_int),
    "float": (1, _fn_float),
    "bool": (1, lambda x: bool(x)),
    "lowercase": (1, lambda x: _str_arg("lowercase", x).lower()),
    "uppercase": (1, lambda x: _str_arg("uppercase", x).upper()),
    # VRL spells these downcase/upcase — both spellings resolve
    "downcase": (1, lambda x: _str_arg("downcase", x).lower()),
    "upcase": (1, lambda x: _str_arg("upcase", x).upper()),
    "trim": (1, lambda x: _str_arg("trim", x).strip()),
    "replace": (3, lambda s, a, b: _str_arg("replace", s).replace(
        _str_arg("replace", a), _str_arg("replace", b))),
    "contains": (2, lambda s, sub: _str_arg("contains", sub)
                 in _str_arg("contains", s)),
    "starts_with": (2, lambda s, p: _str_arg("starts_with", s).startswith(
        _str_arg("starts_with", p))),
    "ends_with": (2, lambda s, p: _str_arg("ends_with", s).endswith(
        _str_arg("ends_with", p))),
    "split": (2, lambda s, sep: _str_arg("split", s).split(
        _str_arg("split", sep))),
    "join": (2, _fn_join),
    "length": (1, _fn_length),
    "now": (0, lambda: int(time.time())),
    "parse_json": (1, _fn_parse_json),
    "encode_json": (1, lambda x: json.dumps(x)),
    # numeric (round is half-away-from-zero like VRL, not Python's
    # banker's rounding: round(2.5) == 3, round(-2.5) == -3)
    "round": (1, lambda x: math.floor(_num_arg("round", x) + 0.5)
              if _num_arg("round", x) >= 0
              else math.ceil(_num_arg("round", x) - 0.5)),
    "floor": (1, lambda x: math.floor(_num_arg("floor", x))),
    "ceil": (1, lambda x: math.ceil(_num_arg("ceil", x))),
    "abs": (1, lambda x: abs(_num_arg("abs", x))),
    # strings / arrays / objects
    "slice": (3, _fn_slice),
    "truncate": (2, lambda s, n: _str_arg("truncate", s)
                 [: int(_num_arg("truncate", n))]),
    "push": (2, _fn_push),
    "merge": (2, _fn_merge),
    # hashes (hex digests, VRL md5/sha1/sha2)
    "md5": (1, lambda x: hashlib.md5(
        _str_arg("md5", x).encode()).hexdigest()),
    "sha1": (1, lambda x: hashlib.sha1(
        _str_arg("sha1", x).encode()).hexdigest()),
    "sha256": (1, lambda x: hashlib.sha256(
        _str_arg("sha256", x).encode()).hexdigest()),
    # timestamps
    "to_unix_timestamp": (1, _fn_to_unix_timestamp),
    "parse_timestamp": (2, _fn_parse_timestamp),
    "format_timestamp": (2, _fn_format_timestamp),
    # structured parsers
    "parse_regex": (2, _fn_parse_regex),
    "parse_key_value": (1, _fn_parse_key_value),
    "parse_common_log": (1, _fn_parse_common_log),
    "parse_syslog": (1, _fn_parse_syslog),
    "parse_url": (1, _fn_parse_url),
}


def _get_path(doc: dict, parts: tuple[str, ...]):
    cur: Any = doc
    for p in parts:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(p)
    return cur


def _set_path(doc: dict, parts: tuple[str, ...], value) -> None:
    cur = doc
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _del_path(doc: dict, parts: tuple[str, ...]) -> None:
    cur: Any = doc
    for p in parts[:-1]:
        if not isinstance(cur, dict):
            return
        cur = cur.get(p)
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)


def _binop(op: str, a, b):
    try:
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _fn_string(a) + _fn_string(b)
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return a % b
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except (TypeError, ZeroDivisionError) as exc:
        raise TransformRuntimeError(f"{op!r}: {exc}")
    raise TransformRuntimeError(f"unknown operator {op!r}")


# --------------------------------------------------------------------------
# parser: recursive descent → closures over the doc

class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.tokens[self.i]

    def next(self) -> tuple[str, str]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, got = self.next()
        if got != value:
            raise TransformParseError(f"expected {value!r}, got {got!r}")

    def skip_newlines(self) -> None:
        while self.peek()[0] == "newline":
            self.next()

    # --- statements -------------------------------------------------------
    def parse_block(self, until: Optional[str]) -> Callable[[dict], None]:
        stmts: list[Callable[[dict], None]] = []
        self.skip_newlines()
        while True:
            kind, value = self.peek()
            if kind == "eof" or (until is not None and value == until):
                break
            stmts.append(self.parse_statement())
            self.skip_newlines()

        def run(doc: dict) -> None:
            for stmt in stmts:
                stmt(doc)
        return run

    def parse_statement(self) -> Callable[[dict], None]:
        kind, value = self.peek()
        if kind == "ident" and value == "if":
            return self.parse_if()
        if kind == "ident" and value == "del":
            self.next()
            self.expect("(")
            pkind, pval = self.next()
            if pkind != "path":
                raise TransformParseError("del() takes a field path")
            self.expect(")")
            parts = tuple(pval[1:].split("."))
            return lambda doc: _del_path(doc, parts)
        if kind == "ident" and value == "drop":
            self.next()
            self.expect("(")
            self.expect(")")
            def do_drop(doc: dict) -> None:
                raise _Drop()
            return do_drop
        if kind == "path":
            self.next()
            parts = tuple(value[1:].split("."))
            self.expect("=")
            expr = self.parse_expr()
            return lambda doc: _set_path(doc, parts, expr(doc))
        raise TransformParseError(f"unexpected token {value!r}")

    def parse_if(self) -> Callable[[dict], None]:
        self.next()  # 'if'
        cond = self.parse_expr()
        self.expect("{")
        then_block = self.parse_block(until="}")
        self.expect("}")
        else_block: Optional[Callable[[dict], None]] = None
        self.skip_newlines()
        if self.peek() == ("ident", "else"):
            self.next()
            self.expect("{")
            else_block = self.parse_block(until="}")
            self.expect("}")

        def run(doc: dict) -> None:
            if cond(doc):
                then_block(doc)
            elif else_block is not None:
                else_block(doc)
        return run

    # --- expressions (precedence climbing) --------------------------------
    def parse_expr(self) -> Callable[[dict], Any]:
        return self.parse_or()

    def parse_or(self) -> Callable[[dict], Any]:
        left = self.parse_and()
        while self.peek()[1] == "||":
            self.next()
            right = self.parse_and()
            prev = left
            left = lambda doc, a=prev, b=right: bool(a(doc)) or bool(b(doc))
        return left

    def parse_and(self) -> Callable[[dict], Any]:
        left = self.parse_cmp()
        while self.peek()[1] == "&&":
            self.next()
            right = self.parse_cmp()
            prev = left
            left = lambda doc, a=prev, b=right: bool(a(doc)) and bool(b(doc))
        return left

    def parse_cmp(self) -> Callable[[dict], Any]:
        left = self.parse_add()
        while self.peek()[1] in ("==", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            right = self.parse_add()
            prev = left
            left = lambda doc, a=prev, b=right, o=op: _binop(o, a(doc), b(doc))
        return left

    def parse_add(self) -> Callable[[dict], Any]:
        left = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            right = self.parse_mul()
            prev = left
            left = lambda doc, a=prev, b=right, o=op: _binop(o, a(doc), b(doc))
        return left

    def parse_mul(self) -> Callable[[dict], Any]:
        left = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            right = self.parse_unary()
            prev = left
            left = lambda doc, a=prev, b=right, o=op: _binop(o, a(doc), b(doc))
        return left

    def parse_unary(self) -> Callable[[dict], Any]:
        kind, value = self.peek()
        if value == "!":
            self.next()
            inner = self.parse_unary()
            return lambda doc: not inner(doc)
        if value == "-":
            self.next()
            inner = self.parse_unary()
            return lambda doc: _binop("-", 0, inner(doc))
        return self.parse_primary()

    def parse_primary(self) -> Callable[[dict], Any]:
        kind, value = self.next()
        if kind == "number":
            num = float(value) if "." in value else int(value)
            return lambda doc: num
        if kind == "string":
            try:
                text = json.loads(value)  # handles escapes
            except ValueError as exc:
                raise TransformParseError(f"bad string literal {value}: {exc}")
            return lambda doc: text
        if kind == "path":
            parts = tuple(value[1:].split("."))
            return lambda doc: _get_path(doc, parts)
        if kind == "ident":
            if value == "true":
                return lambda doc: True
            if value == "false":
                return lambda doc: False
            if value == "null":
                return lambda doc: None
            if value in ("if", "else"):
                raise TransformParseError(f"{value!r} is not an expression")
            return self.parse_call(value)
        if value == "(":
            inner = self.parse_expr()
            self.expect(")")
            return inner
        raise TransformParseError(f"unexpected token {value!r} in expression")

    def parse_call(self, name: str) -> Callable[[dict], Any]:
        if name == "exists":
            self.expect("(")
            pkind, pval = self.next()
            if pkind != "path":
                raise TransformParseError("exists() takes a field path")
            self.expect(")")
            parts = tuple(pval[1:].split("."))
            return lambda doc: _get_path(doc, parts) is not None
        if name not in _FUNCTIONS:
            raise TransformParseError(f"unknown function {name!r}")
        arity, fn = _FUNCTIONS[name]
        self.expect("(")
        args: list[Callable[[dict], Any]] = []
        if self.peek()[1] != ")":
            args.append(self.parse_expr())
            while self.peek()[1] == ",":
                self.next()
                args.append(self.parse_expr())
        self.expect(")")
        if len(args) != arity:
            raise TransformParseError(
                f"{name}() takes {arity} argument(s), got {len(args)}")
        return lambda doc: fn(*(a(doc) for a in args))


# --------------------------------------------------------------------------

class Transform:
    """A compiled transform script: `apply(doc)` returns the transformed doc
    (a copy — the input is never mutated) or None when drop()ped."""

    def __init__(self, script: str):
        self.script = script
        parser = _Parser(_tokenize(script))
        self._program = parser.parse_block(until=None)
        if parser.peek()[0] != "eof":
            raise TransformParseError(
                f"trailing tokens at {parser.peek()[1]!r}")

    def apply(self, doc: dict, copy: bool = True) -> Optional[dict]:
        if not isinstance(doc, dict):
            # typed, so the pipeline counts the doc invalid instead of
            # crashing the whole drain pass on one malformed record
            raise TransformRuntimeError(
                f"document must be a JSON object, got {type(doc).__name__}")
        # copy=False lets the ingest hot path skip the deep copy when the
        # caller discards the input anyway (the pipeline does)
        out = (json.loads(json.dumps(doc)) if copy else doc) if doc else {}
        try:
            self._program(out)
        except _Drop:
            return None
        except TransformRuntimeError:
            raise
        except Exception as exc:  # noqa: BLE001 - stdlib leaks (OverflowError,
            # ValueError from split("") etc.) must stay per-doc failures,
            # never abort the whole drain pass
            raise TransformRuntimeError(f"{type(exc).__name__}: {exc}")
        return out


def transform_script_of(params) -> Optional[str]:
    """Extract the raw script from a SourceConfig's params, or None.
    The single source of truth for the `transform` param shape."""
    if not isinstance(params, dict):
        if params:
            raise TransformParseError("source params must be a JSON object")
        return None
    spec = params.get("transform")
    if not spec:
        return None
    script = spec.get("script") if isinstance(spec, dict) else spec
    if not isinstance(script, str) or not script.strip():
        raise TransformParseError("transform requires a script string")
    return script


def transform_from_source_params(params) -> Optional[Transform]:
    """`transform: {script: ...}` in a SourceConfig's params (reference:
    `TransformConfig` on the source, doc_processor.rs:94)."""
    script = transform_script_of(params)
    return Transform(script) if script is not None else None
