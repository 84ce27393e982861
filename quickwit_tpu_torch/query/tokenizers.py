"""Text tokenizers.

Role of the reference's `quickwit-query/src/tokenizers/` (and tantivy's
tokenizer API): turn field text into index tokens. Parity-critical because the
same tokenizer must run at indexing and query time.

Registry mirrors the reference's named tokenizers:
- ``raw``: whole value as a single token (no lowercasing), capped length
- ``default``: split on non-alphanumeric, lowercase, drop tokens > 255 chars
- ``en_stem``: default + Porter-lite stemming
- ``whitespace``: split on whitespace, no lowercasing
- ``lowercase``: single token, lowercased (reference's raw+lowercase)
- ``chinese_compatible``: CJK codepoints as single tokens, latin runs as words
- ``source_code_default``: splits identifiers on case/underscore boundaries
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Iterator

MAX_TOKEN_LEN = 255


@dataclass(frozen=True)
class Token:
    text: str
    position: int  # token position (for phrase queries)


Tokenizer = Callable[[str], list[Token]]

_WORD_RE = re.compile(r"[0-9A-Za-zÀ-ɏЀ-ӿ]+")
_CJK_RE = re.compile(
    r"([一-鿿㐀-䶿぀-ヿ가-힯])|([0-9A-Za-z]+)"
)
_CODE_RE = re.compile(
    r"(?:[A-Z]+(?![a-z]))|(?:[A-Z][a-z]+)|(?:[a-z]+)|(?:[0-9]+)"
)


def _raw(text: str) -> list[Token]:
    text = text[:MAX_TOKEN_LEN]
    return [Token(text, 0)] if text else []


def _lowercase(text: str) -> list[Token]:
    text = text[:MAX_TOKEN_LEN].lower()
    return [Token(text, 0)] if text else []


def _default(text: str) -> list[Token]:
    return [
        Token(m.group(0).lower(), pos)
        for pos, m in enumerate(_WORD_RE.finditer(text))
        if len(m.group(0)) <= MAX_TOKEN_LEN
    ]


def _whitespace(text: str) -> list[Token]:
    return [Token(tok, pos) for pos, tok in enumerate(text.split()) if len(tok) <= MAX_TOKEN_LEN]


def _en_stem(text: str) -> list[Token]:
    """Default tokenization + Porter2 (English Snowball) stemming —
    byte-compatible with tantivy's rust-stemmers "english" output
    (`porter2.py`), so `en_stem` index terms match the reference's."""
    from .porter2 import stem
    return [Token(stem(t.text), t.position) for t in _default(text)]


def _chinese_compatible(text: str) -> list[Token]:
    out: list[Token] = []
    pos = 0
    for m in _CJK_RE.finditer(text):
        tok = m.group(0)
        out.append(Token(tok.lower(), pos))
        pos += 1
    return out


def _source_code(text: str) -> list[Token]:
    out: list[Token] = []
    pos = 0
    for m in _CODE_RE.finditer(text):
        out.append(Token(m.group(0).lower(), pos))
        pos += 1
    return out


_REGISTRY: dict[str, Tokenizer] = {
    "raw": _raw,
    "lowercase": _lowercase,
    "default": _default,
    "en_stem": _en_stem,
    "whitespace": _whitespace,
    "chinese_compatible": _chinese_compatible,
    "source_code_default": _source_code,
}


def get_tokenizer(name: str) -> Tokenizer:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown tokenizer {name!r}; known: {sorted(_REGISTRY)}")


def tokenizer_names() -> list[str]:
    return sorted(_REGISTRY)


def known_tokenizer(name: str) -> bool:
    return name in _REGISTRY
