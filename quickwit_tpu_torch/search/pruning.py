"""Dynamic top-K split pruning: sort-value / BM25-score upper bounds.

Role of the reference's `CanSplitDoBetter` (`leaf.rs:1279`): once the
collector holds K hits, a pending split whose best achievable sort key
cannot beat the current Kth value is either skipped outright
(`count_hits_exact=False`) or downgraded to a count-only request that rides
the far cheaper no-sort/no-top-k path. The seed only used split bounds to
ORDER execution (`service._optimize_split_order`); this module supplies the
actual payoff.

Everything here works in the INTERNAL sort-key encoding (`PartialHit
.sort_value`: float64, higher-is-better — desc keeps the raw value, asc
negates it), so one comparison rule covers both orders:

    prune split  iff  best_internal_key(split) < threshold

Strictly less — a split that can only TIE the threshold may still win the
(sort_value2, split_id, doc_id) tie-break at the collector and must run.

Soundness per sort kind:
  timestamp   — split metadata `time_range` bounds every doc (the timestamp
                field is required), so the bound is exact metadata.
  fast field  — the split footer's per-field min/max bounds every doc WITH a
                value; docs missing the value key at MISSING_VALUE_SENTINEL,
                below any finite bound, so the bound covers them too.
  _score desc — per-(field,term) max term frequency recorded at split open:
                BM25's tf/(tf + K1*(1-B+B*norm/avg)) is increasing in tf and
                decreasing in norm, so norm→0, tf→max_tf upper-bounds every
                doc; the query bound sums the per-term bounds over every
                scoring (must+should) term. Impact-ordered splits (format
                v3) replace the formula with the exact dequantized first
                block maximum, which also reflects the real fieldnorms.
                Queries with score contributions
                we cannot bound (phrase, prefix, wildcard, regex) disable
                pruning entirely (return None) — sound, never wrong.
  _score asc / _doc / text sorts — never pruned.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..common import sync

from ..models.doc_mapper import DocMapper, FieldType
from ..ops.bm25 import B, K1, idf
from ..ops.topk import MISSING_VALUE_SENTINEL
from ..query import ast as Q
from ..query.tokenizers import get_tokenizer
from .models import (LeafSearchResponse, SearchRequest, SortField,
                     string_sort_of)
from .predicate_cache import canonical_query_term, term_is_tokenized_text


class ThresholdBox:
    """Monotone (non-decreasing) threshold shared between the merge loop and
    the prefetch worker.

    The collector itself is not thread-safe (`partial_hits` sorts in place),
    so the main thread PUBLISHES the Kth value here after each merge and the
    prefetch thread only READS. Monotonicity makes stale reads sound: the
    true threshold only ever rises, so a reader acting on an old value
    prunes less, never more.
    """

    def __init__(self, seed: Optional[float] = None):
        self._value = seed
        self._lock = sync.lock("ThresholdBox._lock")
        sync.register_shared(self, "ThresholdBox")
        # qwrace planted race (mandatory self-test): with
        # QW_RACE_BREAK_THRESHOLD set, update() does its read-modify-write
        # WITHOUT the box lock — the exact bug the monotone-publish
        # contract above exists to prevent
        self._break_unlocked = os.environ.get(
            "QW_RACE_BREAK_THRESHOLD", "").strip().lower() in (
                "1", "true", "yes")

    def get(self) -> Optional[float]:
        with self._lock:
            sync.note_read(self, "value")
            return self._value

    def update(self, value: Optional[float]) -> None:
        if value is None:
            return
        if self._break_unlocked:
            sync.note_write(self, "value")
            if self._value is None or value > self._value:
                self._value = value
            return
        with self._lock:
            sync.note_write(self, "value")
            if self._value is None or value > self._value:
                self._value = value


class ScoreBoundCache:
    """LRU of (split_id, field, term) → (df, max_tf[, score_cap]) recorded
    at split open.

    Like the predicate cache's absence proofs, the stats are immutable
    properties of an (immutable) split, so entries never invalidate; the
    backing `terms.max_tf` footer array persists them across reader
    evictions and process restarts. `score_cap` (format v3 impact-ordered
    splits) is the EXACT dequantized first-block maximum — sharper than the
    max_tf/norm→0 formula because it reflects the real fieldnorms — or None
    on v2 splits.
    """

    def __init__(self, max_entries: int = 1 << 17):
        self._entries: OrderedDict[tuple[str, str, str],
                                   tuple] = OrderedDict()
        self._max_entries = max_entries
        self._lock = sync.lock("ScoreBoundCache._lock")

    def record(self, split_id: str, field: str, term: str,
               df: int, max_tf: int,
               score_cap: Optional[float] = None) -> None:
        key = (split_id, field, term)
        with self._lock:
            self._entries[key] = (df, max_tf, score_cap)
            self._entries.move_to_end(key)
            while len(self._entries) > self._max_entries:
                self._entries.popitem(last=False)

    def get(self, split_id: str, field: str,
            term: str) -> Optional[tuple]:
        key = (split_id, field, term)
        with self._lock:
            stats = self._entries.get(key)
            if stats is not None:
                self._entries.move_to_end(key)
            return stats

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# --------------------------------------------------------------------------
# scoring-term extraction (mirror of Lowering.lower's scoring dispatch)

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


def term_score_bound(num_docs: int, df: int, max_tf: int,
                     boost: float = 1.0) -> float:
    """Upper bound on one term's BM25 contribution to any doc in a split:
    tf at the split max, fieldnorm at its minimum (0)."""
    if df <= 0 or max_tf <= 0:
        return 0.0  # term absent from the split: matches nothing
    return (boost * idf(num_docs, df) * (K1 + 1.0) * max_tf
            / (max_tf + K1 * (1.0 - B)))


def split_score_upper_bound(
        terms: list[tuple[str, str, float]], num_docs: int,
        stats: Callable[[str, str], Optional[tuple[int, int]]],
) -> Optional[float]:
    """Σ per-term bounds over the query's scoring terms. `stats` maps
    (field, term) → (df, max_tf[, score_cap]) or None when unknown; any
    unknown term makes the split unboundable (None → run it). When the
    3rd element (exact impact block-max cap, format v3) is present it is
    used directly — boost scales linearly through the whole BM25 formula,
    so `boost * cap` stays an upper bound."""
    total = 0.0
    for field, term, boost in terms:
        st = stats(field, term)
        if st is None:
            return None
        if len(st) > 2 and st[2] is not None:
            total += boost * st[2]
        else:
            total += term_score_bound(num_docs, st[0], st[1], boost)
    return total


def record_split_term_stats(cache: ScoreBoundCache, split_id: str, reader,
                            terms: list[tuple[str, str, float]]) -> None:
    """At split open: look up df/max-tf for the query's scoring terms and
    remember them so FUTURE queries can bound this split before opening it
    (the reference persists absence proofs the same way)."""
    for field, term, _boost in terms:
        if cache.get(split_id, field, term) is not None:
            continue
        df, max_tf = reader.term_stats(field, term)
        cache.record(split_id, field, term, df, max_tf,
                     reader.term_score_cap(field, term))


# --------------------------------------------------------------------------
# per-request pruning context + per-split bounds

class PruningContext:
    """Resolved per-request pruning mode, or inert when the sort kind is
    not prunable. `mode` is one of "timestamp" | "fast_field" | "score" |
    None."""

    __slots__ = ("mode", "sort", "terms", "timestamp_field")

    def __init__(self, mode: Optional[str], sort: Optional[SortField],
                 terms: Optional[list] = None,
                 timestamp_field: Optional[str] = None):
        self.mode = mode
        self.sort = sort
        self.terms = terms          # scoring terms (score mode)
        self.timestamp_field = timestamp_field


def pruning_context(request: SearchRequest,
                    doc_mapper: DocMapper) -> PruningContext:
    """Decide whether (and how) this request's pending splits can be pruned
    by a collected-Kth-value threshold."""
    inert = PruningContext(None, None)
    if request.max_hits <= 0 or request.aggs:
        # count/agg-only requests must visit every split in full
        return inert
    if not request.sort_fields:
        return inert
    if string_sort_of(request, doc_mapper) is not None:
        return inert  # split-local ordinals: no cross-split bound
    sort = request.sort_fields[0]
    if sort.field == "_doc":
        return inert
    if sort.field == "_score":
        if sort.order != "desc":
            return inert  # asc: best internal key is trivially 0, useless
        terms = scoring_terms(request.query_ast, doc_mapper)
        if terms is None:
            return inert
        return PruningContext("score", sort, terms=terms)
    fm = doc_mapper.field(sort.field)
    if fm is None or not fm.fast:
        return inert
    if doc_mapper.timestamp_field == sort.field:
        return PruningContext("timestamp", sort,
                              timestamp_field=sort.field)
    if fm.type in (FieldType.I64, FieldType.U64, FieldType.F64,
                   FieldType.DATETIME, FieldType.BOOL):
        return PruningContext("fast_field", sort)
    return inert


def _internal_bound(lo, hi, descending: bool) -> Optional[float]:
    """Best achievable internal key for a value range [lo, hi]."""
    if descending:
        return None if hi is None else float(hi)
    return None if lo is None else -float(lo)


def split_best_internal_key(ctx: PruningContext, split,
                            field_meta_fn=None,
                            score_stats_fn=None) -> Optional[float]:
    """Upper bound on the internal sort key any doc of `split` can reach,
    or None when unknown (split must run).

    `field_meta_fn()` lazily supplies the split footer's FieldMeta for
    fast-field mode (None when the reader is cold and opening it would cost
    more than the kernel it might save); `score_stats_fn(field, term)`
    supplies (df, max_tf) for score mode.
    """
    if ctx.mode == "timestamp":
        tr = split.time_range
        if tr is None:
            return None
        return _internal_bound(tr[0], tr[1], ctx.sort.order == "desc")
    if ctx.mode == "fast_field":
        meta = field_meta_fn() if field_meta_fn is not None else None
        if not meta:
            return None
        bound = _internal_bound(meta.get("min_value"), meta.get("max_value"),
                                ctx.sort.order == "desc")
        if bound is None:
            return None
        # docs missing the value key at the sentinel — below any finite
        # bound, so max() only matters when every doc lacks the field
        return max(bound, MISSING_VALUE_SENTINEL)
    if ctx.mode == "score":
        if score_stats_fn is None:
            return None
        return split_score_upper_bound(ctx.terms, max(split.num_docs, 1),
                                       score_stats_fn)
    return None


# --------------------------------------------------------------------------
# request downgrade + wire seeding

def downgrade_to_count(request: SearchRequest) -> SearchRequest:
    """Count-only form of `request` for a threshold-pruned split when exact
    counts are required: max_hits=0 normalizes the sort to doc order
    (SearchRequest.__post_init__), riding count-from-metadata for match-all
    and the k==0 no-sort/no-top-k kernel otherwise. The time filter MUST be
    carried — counts respect it."""
    return SearchRequest(
        index_ids=request.index_ids,
        query_ast=request.query_ast,
        max_hits=0,
        start_offset=0,
        aggs=None,
        start_timestamp=request.start_timestamp,
        end_timestamp=request.end_timestamp,
        count_hits_exact=True,
        search_after=None,
        snippet_fields=(),
    )


def threshold_from_response(request: SearchRequest, doc_mapper: DocMapper,
                            response: LeafSearchResponse) -> Optional[float]:
    """Seed threshold (internal encoding) from an earlier partial response:
    the Kth sort value once the top window is full. Used by the root's
    retry path so round 2 starts pruning where round 1 left off."""
    needed = request.start_offset + request.max_hits
    if request.max_hits <= 0:
        return None
    if string_sort_of(request, doc_mapper) is not None:
        return None
    if request.sort_fields and request.sort_fields[0].field == "_doc":
        return None
    hits = response.partial_hits
    if len(hits) < needed:
        return None
    return hits[needed - 1].sort_value
