"""Partition routing expressions (reference:
`quickwit-doc-mapper/src/routing_expression/mod.rs`).

A doc mapping's `partition_key` is a tiny DSL over document fields:

    RoutingExpr   := SubExpr [ "," RoutingExpr ]
    SubExpr       := Identifier [ "(" Arguments ")" ]
    Identifier    := field path chars (alnum _ - . \\ / @ $), `\\.` escapes
                     a literal dot inside one path segment
    Arguments     := ( "(" RoutingExpr ")" | SubExpr | Number ) [ "," ... ]

with one function, `hash_mod(expr, N)`. Evaluation hashes the addressed
document values into a stable 64-bit partition id: docs with equal keys
land in the same partition, so splits hold value-homogeneous doc sets
(better tag pruning, cheaper targeted deletes) and only same-partition
splits merge.

Hashing diverges from the reference deliberately: instead of SipHash we
feed the same type-tagged byte encoding (injective per JSON value) into
blake2b — stable across processes and platforms, no third-party dep. The
expression structure is folded into the hash exactly like the reference
salts its hasher with the expression tree, so changing the expression
changes every partition id.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Any, Optional


class RoutingExprError(ValueError):
    pass


# --------------------------------------------------------------------------
# AST

@dataclass(frozen=True)
class _Field:
    path: tuple[str, ...]


@dataclass(frozen=True)
class _Composite:
    children: tuple[Any, ...]


@dataclass(frozen=True)
class _Modulo:
    inner: Any
    modulo: int


# --------------------------------------------------------------------------
# parser

_IDENT_CHARS = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.\\/@$")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def parse(self) -> Any:
        exprs = self._routing_expr()
        self._ws()
        if self.pos != len(self.text):
            raise RoutingExprError(
                f"unexpected trailing input at {self.pos}: "
                f"{self.text[self.pos:]!r}")
        if not exprs:
            return _Composite(())
        if len(exprs) == 1:
            return exprs[0]
        return _Composite(tuple(exprs))

    def _routing_expr(self) -> list:
        out = [self._sub_expr()]
        while True:
            self._ws()
            if self._peek() != ",":
                break
            self.pos += 1
            out.append(self._sub_expr())
        return out

    def _sub_expr(self) -> Any:
        self._ws()
        ident = self._identifier()
        self._ws()
        if self._peek() != "(":
            return _Field(_split_field_path(ident))
        self.pos += 1
        args = self._arguments()
        self._ws()
        if self._peek() != ")":
            raise RoutingExprError(f"expected ')' at {self.pos}")
        self.pos += 1
        if ident != "hash_mod":
            raise RoutingExprError(f"unknown function {ident!r}")
        if (len(args) != 2 or isinstance(args[0], int)
                or not isinstance(args[1], int)):
            raise RoutingExprError(
                "hash_mod expects (expression, number) arguments")
        if args[1] <= 0:
            raise RoutingExprError("hash_mod modulo must be positive")
        return _Modulo(args[0], args[1])

    def _arguments(self) -> list:
        args = [self._argument()]
        while True:
            self._ws()
            if self._peek() != ",":
                break
            self.pos += 1
            args.append(self._argument())
        return args

    def _argument(self) -> Any:
        self._ws()
        ch = self._peek()
        if ch.isdigit():
            start = self.pos
            while self._peek().isdigit():
                self.pos += 1
            return int(self.text[start:self.pos])
        if ch == "(":
            self.pos += 1
            exprs = self._routing_expr()
            self._ws()
            if self._peek() != ")":
                raise RoutingExprError(f"expected ')' at {self.pos}")
            self.pos += 1
            if len(exprs) == 1:
                return exprs[0]
            return _Composite(tuple(exprs))
        return self._sub_expr()

    def _identifier(self) -> str:
        start = self.pos
        while self._peek() in _IDENT_CHARS and self._peek():
            # `\x` consumes the escaped char with the backslash
            if self.text[self.pos] == "\\" and self.pos + 1 < len(self.text):
                self.pos += 2
            else:
                self.pos += 1
        if self.pos == start:
            raise RoutingExprError(
                f"expected identifier at position {self.pos}")
        return self.text[start:self.pos]


def _split_field_path(ident: str) -> tuple[str, ...]:
    """Split on unescaped dots; `\\.` is a literal dot in a segment."""
    parts: list[str] = []
    cur: list[str] = []
    i = 0
    while i < len(ident):
        ch = ident[i]
        if ch == "\\" and i + 1 < len(ident):
            cur.append(ident[i + 1])
            i += 2
        elif ch == ".":
            parts.append("".join(cur))
            cur = []
            i += 1
        else:
            cur.append(ch)
            i += 1
    parts.append("".join(cur))
    if any(not p for p in parts):
        raise RoutingExprError(f"empty path segment in {ident!r}")
    return tuple(parts)


# --------------------------------------------------------------------------
# evaluation

class _Hasher:
    """Structured stable hasher (role of the reference's SipHasher use)."""

    def __init__(self, seed: bytes = b""):
        self._h = hashlib.blake2b(seed, digest_size=8)

    def write(self, data: bytes) -> None:
        self._h.update(data)

    def write_u8(self, v: int) -> None:
        self._h.update(bytes([v]))

    def write_u64(self, v: int) -> None:
        self._h.update(struct.pack("<Q", v & (2**64 - 1)))

    def finish(self) -> int:
        return struct.unpack("<Q", self._h.digest())[0]

    def state(self) -> bytes:
        return self._h.digest()


_TAG_FIELD, _TAG_COMPOSITE, _TAG_MODULO = 0, 1, 2


def _hash_json_value(value: Any, hasher: _Hasher) -> None:
    """Injective per-value byte feed (reference `hash_json_val`)."""
    if value is None:
        hasher.write_u8(0)
    elif isinstance(value, bool):
        hasher.write_u8(1)
        hasher.write_u8(1 if value else 0)
    elif isinstance(value, (int, float)):
        hasher.write_u8(2)
        hasher.write(repr(value).encode())
    elif isinstance(value, str):
        data = value.encode()
        hasher.write_u8(3)
        hasher.write_u64(len(data))
        hasher.write(data)
    elif isinstance(value, list):
        hasher.write_u8(4)
        hasher.write_u64(len(value))
        for item in value:
            _hash_json_value(item, hasher)
    elif isinstance(value, dict):
        hasher.write_u8(5)
        hasher.write_u64(len(value))
        # sorted order: JSON-equal objects must hash equal regardless of
        # key insertion order (equal-key-same-partition contract)
        for key, val in sorted(value.items(), key=lambda kv: str(kv[0])):
            kdata = str(key).encode()
            hasher.write_u64(len(kdata))
            hasher.write(kdata)
            _hash_json_value(val, hasher)
    else:
        hasher.write_u8(6)
        hasher.write(str(value).encode())


_MISSING = object()


def _find_value(doc: Any, path: tuple[str, ...]) -> Any:
    """Value at `path`, or the _MISSING sentinel (a present null is a
    value, distinct from an absent key — matching the reference)."""
    for key in path:
        if not isinstance(doc, dict) or key not in doc:
            return _MISSING
        doc = doc[key]
    return doc


def _eval(node: Any, doc: dict, hasher: _Hasher) -> None:
    if isinstance(node, _Field):
        hasher.write_u8(_TAG_FIELD)
        value = _find_value(doc, node.path)
        if value is _MISSING:
            hasher.write_u8(0)
        else:
            hasher.write_u8(1)
            _hash_json_value(value, hasher)
    elif isinstance(node, _Composite):
        hasher.write_u8(_TAG_COMPOSITE)
        for child in node.children:
            _eval(child, doc, hasher)
    else:  # _Modulo
        hasher.write_u8(_TAG_MODULO)
        sub = _Hasher()
        _eval(node.inner, doc, sub)
        hasher.write_u64(sub.finish() % node.modulo)


def _hash_structure(node: Any, hasher: _Hasher) -> None:
    """Salt with the expression tree (reference Hash for InnerRoutingExpr)."""
    if isinstance(node, _Field):
        hasher.write_u8(_TAG_FIELD)
        hasher.write_u64(len(node.path))
        hasher.write(".".join(node.path).encode())
    elif isinstance(node, _Composite):
        hasher.write_u8(_TAG_COMPOSITE)
        for child in node.children:
            _hash_structure(child, hasher)
    else:
        hasher.write_u8(_TAG_MODULO)
        _hash_structure(node.inner, hasher)
        hasher.write_u64(node.modulo)


class RoutingExpr:
    """Compiled partition routing expression."""

    def __init__(self, expr: str = ""):
        expr = (expr or "").strip()
        self.source = expr
        if not expr:
            self._inner = None
            self._salt = b""
            return
        self._inner = _Parser(expr).parse()
        salt_hasher = _Hasher()
        _hash_structure(self._inner, salt_hasher)
        self._salt = salt_hasher.state()

    @property
    def is_empty(self) -> bool:
        return self._inner is None

    def field_names(self) -> list[str]:
        out: list[str] = []

        def walk(node):
            if isinstance(node, _Field):
                out.append(".".join(node.path))
            elif isinstance(node, _Composite):
                for child in node.children:
                    walk(child)
            elif isinstance(node, _Modulo):
                walk(node.inner)

        if self._inner is not None:
            walk(self._inner)
        return out

    def eval_hash(self, doc: dict) -> int:
        """Stable u64 partition id for a JSON document (0 when empty)."""
        if self._inner is None:
            return 0
        hasher = _Hasher(self._salt)
        _eval(self._inner, doc, hasher)
        return hasher.finish()
