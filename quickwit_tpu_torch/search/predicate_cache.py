"""Predicate / negative cache: provably-empty split pruning.

Role of the reference's `CacheNode` + term-absence negative cache
(`quickwit-query/src/query_ast/cache_node.rs:33,40`,
`quickwit-search/src/leaf_cache.rs:197`, consultation at
`leaf.rs:758-841`): a split is provably empty for a query when any
**conjunctively required** term has previously been proven absent from
it. Absence is an immutable, query- and time-window-independent property
of an (immutable) split, so the consultation is sound regardless of the
rest of the query — extra required clauses can only make it emptier.

TPU-first twist: in this engine the payoff is even larger than in the
reference. A pruned split skips not just warmup IO but the whole
device pipeline — byte-range GETs, plan lowering, H2D transfer, and a
jitted kernel launch (plus, for a cold split, the footer open itself:
consultation happens *before* the reader is constructed).

Absences are recorded during plan lowering: every term-dictionary miss
is a proof, whether or not the term was required in that query.
"""

from __future__ import annotations

from collections import OrderedDict

from ..models.doc_mapper import DocMapper, FieldMapping, FieldType
from ..observability.metrics import (
    PREDICATE_CACHE_EVICTED_BYTES_TOTAL, PREDICATE_CACHE_HITS_TOTAL,
    PREDICATE_CACHE_MISSES_TOTAL,
)
from ..query import ast as Q
from ..query.tokenizers import get_tokenizer
from ..common import sync

# Accounted cost of one absence marker beyond its key strings: the
# OrderedDict slot, the key tuple, and three string headers. An estimate
# (CPython internals vary), but a stable one — the point is that the cache
# is bounded in BYTES like its sibling tiers, not in entries, so long
# field/term keys can't blow past an entry-count bound's implied size.
_ENTRY_OVERHEAD_BYTES = 160


class PredicateCache:
    """Byte-bounded LRU of (split_id, field, term) → proven-absent markers."""

    def __init__(self, max_bytes: int = 8 << 20):
        self._entries: OrderedDict[tuple[str, str, str], int] = OrderedDict()
        self.max_bytes = max_bytes
        self._size = 0
        self._lock = sync.lock("PredicateCache._lock")
        self.hits = 0
        self.misses = 0
        self.evicted_bytes = 0

    @staticmethod
    def _entry_bytes(key: tuple[str, str, str]) -> int:
        return _ENTRY_OVERHEAD_BYTES + sum(len(part) for part in key)

    def record_term_absent(self, split_id: str, field: str, term: str) -> None:
        key = (split_id, field, term)
        nbytes = self._entry_bytes(key)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._size -= old
            self._entries[key] = nbytes
            self._size += nbytes
            dropped = 0
            while self._size > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._size -= evicted
                dropped += evicted
            if dropped:
                self.evicted_bytes += dropped
        if dropped:
            PREDICATE_CACHE_EVICTED_BYTES_TOTAL.inc(dropped)

    def is_term_absent(self, split_id: str, field: str, term: str) -> bool:
        with self._lock:
            present = (split_id, field, term) in self._entries
            if present:
                self._entries.move_to_end((split_id, field, term))
            return present

    def known_empty(self, split_id: str,
                    required: list[tuple[str, str]]) -> bool:
        """True when any required term is proven absent. Hit/miss counters
        live here (not in `is_term_absent`) so one consultation counts
        once, however many required terms it scans."""
        empty = any(self.is_term_absent(split_id, field, term)
                    for field, term in required)
        with self._lock:
            if empty:
                self.hits += 1
            else:
                self.misses += 1
        if empty:
            PREDICATE_CACHE_HITS_TOTAL.inc()
        else:
            PREDICATE_CACHE_MISSES_TOTAL.inc()
        return empty

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._size

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "size_bytes": self._size,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evicted_bytes": self.evicted_bytes,
            }


def term_is_tokenized_text(fm: FieldMapping) -> bool:
    """True when a Term node on this field lowers as a conjunctive
    full-text match (quickwit query-language semantics). Shared by
    `Lowering._lower_term` and `required_terms` so their dispatch cannot
    drift — divergence would make pruning unsound."""
    return fm.type is FieldType.TEXT and fm.tokenizer not in ("raw",
                                                              "lowercase")


def canonical_query_term(fm: FieldMapping, value: str) -> str:
    """Query-side canonical index-term string — THE transformation plan
    lowering applies before every term-dictionary lookup
    (`Lowering._canonical` delegates here), so predicate-cache keys and
    lookup keys coincide by construction."""
    from ..utils.datetime_utils import parse_datetime_to_micros
    if fm.type is FieldType.TEXT:
        return value
    if fm.type is FieldType.DATETIME:
        return str(parse_datetime_to_micros(value, fm.input_formats)
                   if not str(value).lstrip("-").isdigit()
                   else parse_datetime_to_micros(int(value),
                                                 ("unix_timestamp",)))
    if fm.type is FieldType.F64:
        return repr(float(value))
    if fm.type is FieldType.BOOL:
        return value.lower()
    return str(int(value))


def required_terms(ast: Q.QueryAst,
                   doc_mapper: DocMapper) -> list[tuple[str, str]]:
    """Conjunctively-required (field, canonical_term) pairs of a query:
    terms that every matching document must contain. Mirrors the
    lowering's tokenization/canonicalization so the pairs match
    term-dictionary lookup keys exactly. Unknown node types contribute
    nothing (sound: fewer proofs, never wrong ones)."""
    out: list[tuple[str, str]] = []
    _collect_required(ast, doc_mapper, out)
    return out


def _collect_required(ast: Q.QueryAst, doc_mapper: DocMapper,
                      out: list[tuple[str, str]]) -> None:
    if isinstance(ast, Q.Boost):
        _collect_required(ast.underlying, doc_mapper, out)
        return
    if isinstance(ast, Q.Bool):
        # must/filter are conjunctive; should/must_not prove nothing.
        # Exception: pure-should bools (no must/filter) where EVERY should
        # clause shares the conjunction would need minimum_should_match
        # analysis — skipped (sound).
        for clause in (*ast.must, *ast.filter):
            _collect_required(clause, doc_mapper, out)
        return
    if isinstance(ast, Q.Term):
        fm = doc_mapper.field(ast.field)
        if fm is None or not fm.indexed:
            return
        if not ast.verbatim and term_is_tokenized_text(fm):
            # lowered as a conjunctive full-text match
            _collect_required(Q.FullText(ast.field, ast.value, "and"),
                              doc_mapper, out)
            return
        value = ast.value
        if (not ast.verbatim and fm.type is FieldType.TEXT
                and fm.tokenizer == "lowercase"):
            value = value.lower()
        try:
            out.append((ast.field, canonical_query_term(fm, value)))
        except (ValueError, TypeError):
            pass  # unparsable term value: lowering will surface the error
        return
    if isinstance(ast, Q.FullText):
        fm = doc_mapper.field(ast.field)
        if fm is None:
            return
        if fm.type is not FieldType.TEXT:
            try:
                out.append((ast.field, canonical_query_term(fm, ast.text)))
            except (ValueError, TypeError):
                pass
            return
        tokens = get_tokenizer(fm.tokenizer)(ast.text)
        if ast.mode in ("and", "phrase"):
            out.extend((ast.field, t.text) for t in tokens)
        elif len(tokens) == 1:  # single-token OR is still required
            out.append((ast.field, tokens[0].text))
        return
    # Range / Wildcard / Regex / TermSet / FieldPresence / PhrasePrefix /
    # MatchAll: no single required term — contribute nothing.
