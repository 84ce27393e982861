"""QueryAst → tensor plan lowering.

Role of the reference's `DocMapper::query` + `query_builder.rs` (QueryAst →
tantivy Query + WarmupInfo): against a concrete split, resolve every AST node
into a **static-structure plan** over named device arrays:

- terms resolve to padded posting arrays (ids/tfs) + per-term idf scalars,
- ranges resolve to column slots + traced bound scalars,
- phrases are pre-matched host-side (`ops/phrase.py`) into precomputed
  posting arrays,
- wildcard/regex expand against the term dictionary into term sets,
- aggregations resolve to column slots + static bucket counts.

The plan's `signature` captures only structure + shapes + static params, so
the jitted executor (executor.py) is cached across queries that differ only
in term values/bounds — term data and idf/bounds travel as traced inputs.

Everything here is host code doing exact-byte-range IO through SplitReader
(the warmup role, `leaf.rs:304`): after lowering, the arrays list is the
complete set of buffers the kernel needs in device memory.

Carried over whole from the JAX package's `search/plan.py` (host numpy
only): `idf` comes from this package's `ops/bm25.py` and `RateLimitedLog`
is a local copy. The impact prefix cutoff records the reference's profile
counters and `qw_impact_*` metrics. A phrase's precomputed arrays
carry the slop in their staging key (the JAX package keys them by the terms
alone, so a sloppy phrase there can reuse the exact phrase's postings).
"""

from __future__ import annotations

import fnmatch
import hashlib
import re
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

import numpy as np

from ..models.doc_mapper import DocMapper, FieldMapping, FieldType, canonical_term
from ..ops.bm25 import idf as bm25_idf
from ..ops.phrase import phrase_match
from ..query import ast as Q
from ..query.aggregations import (
    AggSpec, CompositeAgg, CompositeSource, DateHistogramAgg, HistogramAgg,
    MetricAgg, RangeAgg, TermsAgg,
)
from ..query.tokenizers import get_tokenizer
from ..index.impact import IMPACT_BLOCK
from ..index.reader import SplitReader, TermInfo
from ..utils.datetime_utils import parse_datetime_to_micros

import logging

logger = logging.getLogger(__name__)



class RateLimitedLog:
    """At most `limit` emissions of a keyed message per `period_secs`
    window (the subset of the reference package's tracing helper that
    lowering uses)."""

    def __init__(self, limit: int = 5, period_secs: float = 60.0,
                 clock=time.monotonic):
        self.limit = limit
        self.period_secs = period_secs
        self.clock = clock
        self._lock = threading.Lock()
        self._windows: dict[str, tuple[float, int, int]] = {}

    def should_log(self, key: str) -> tuple[bool, int]:
        """(emit_now, num_suppressed_since_last_emit)."""
        now = self.clock()
        with self._lock:
            start, emitted, suppressed = self._windows.get(key,
                                                           (now, 0, 0))
            if now - start >= self.period_secs:
                start, emitted, suppressed = now, 0, suppressed
            if emitted < self.limit:
                self._windows[key] = (start, emitted + 1, 0)
                return True, suppressed
            self._windows[key] = (start, emitted, suppressed + 1)
            return False, 0


_ANALYZER_WARN = RateLimitedLog(limit=3, period_secs=300.0)

MAX_EXPANSIONS = 1024
MAX_BUCKETS = 65536  # reference: AggregationLimitsGuard default bucket limit


class PlanError(ValueError):
    pass


# --------------------------------------------------------------------------
# plan node types (static structure; data lives in slots)

@dataclass(frozen=True)
class PMatchAll:
    def sig(self) -> str:
        return "all"


@dataclass(frozen=True)
class PMatchNone:
    def sig(self) -> str:
        return "none"


@dataclass(frozen=True)
class PPostings:
    """A (possibly precomputed) posting list; scoring via BM25 if requested."""
    ids_slot: int
    tfs_slot: int
    scoring: bool
    norm_slot: int = -1     # dense fieldnorm column (scoring only)
    idf_slot: int = -1      # traced scalar: idf * boost
    avg_len_slot: int = -1  # traced scalar
    # format v3 impact-ordered postings (index/impact.py). The flag is
    # ground truth about the STORAGE order of this term's postings: the
    # executor must not take the posting-space path for field-primary
    # sorts over impact order (posting index no longer equals doc order,
    # so lowest-index-wins ties would diverge from the doc-ordered seed).
    # The slots carry the per-block quantized score bounds + dequant scale
    # for the kernel's block-max early exit; -1 when not armed.
    impact_bmax_slot: int = -1
    impact_scale_slot: int = -1
    impact_ordered: bool = False

    def sig(self) -> str:
        return (f"post({self.ids_slot},{self.tfs_slot},{self.scoring},"
                f"{self.norm_slot},{self.impact_bmax_slot},"
                f"{self.impact_ordered})")


@dataclass(frozen=True)
class PRange:
    values_slot: int
    present_slot: int
    lo_slot: int = -1
    hi_slot: int = -1
    lo_incl: bool = True
    hi_incl: bool = True
    # block-sparse evaluation: per-512-doc-block min/max zonemap arrays in
    # the same domain as values_slot (scaled deltas for packed columns,
    # raw values otherwise); -1 = no zonemaps (v1 splits, derived columns)
    zmin_slot: int = -1
    zmax_slot: int = -1

    def sig(self) -> str:
        return (f"range({self.values_slot},{self.present_slot},{self.lo_slot},"
                f"{self.hi_slot},{self.lo_incl},{self.hi_incl},"
                f"{self.zmin_slot},{self.zmax_slot})")


@dataclass(frozen=True)
class PPresence:
    present_slot: int  # uint8 present column OR int32 ordinals (>= 0 test)
    is_ordinal: bool = False

    def sig(self) -> str:
        return f"pres({self.present_slot},{self.is_ordinal})"


@dataclass(frozen=True)
class PNormPresence:
    norm_slot: int  # fieldnorm > 0 == field had tokens

    def sig(self) -> str:
        return f"npres({self.norm_slot})"


@dataclass(frozen=True)
class PBool:
    must: tuple = ()
    must_not: tuple = ()
    should: tuple = ()
    filter: tuple = ()
    minimum_should_match: Optional[int] = None

    def sig(self) -> str:
        return ("bool(m[" + ",".join(c.sig() for c in self.must) +
                "]n[" + ",".join(c.sig() for c in self.must_not) +
                "]s[" + ",".join(c.sig() for c in self.should) +
                "]f[" + ",".join(c.sig() for c in self.filter) +
                f"]{self.minimum_should_match})")


@dataclass(frozen=True)
class PMaskRef:
    """Query root replaced wholesale by a cached predicate mask
    (search/mask_cache.py): the slot holds the np.packbits-packed uint8
    bitmask (big-endian, 1 bit per padded doc) and the executor unpacks it
    instead of evaluating the query tree. Its sig() forks every compiled-
    executable cache via `LoweredPlan.signature`, like any other root.
    Scoring requests are ineligible (a mask carries no BM25 scores) — the
    lowering rejects the combination."""
    packed_slot: int

    def sig(self) -> str:
        return f"maskref({self.packed_slot})"


# --------------------------------------------------------------------------
# aggregation executables

@dataclass(frozen=True)
class MetricSlots:
    name: str
    kind: str  # avg|min|max|sum|stats|extended_stats|value_count|percentiles|cardinality
    values_slot: int
    present_slot: int
    percents: tuple[float, ...] = ()
    keyed: bool = True  # percentiles output shape
    # cardinality on text columns: per-ordinal 64-bit term hashes
    # (host-precomputed so cross-split merges hash the TERM, not the
    # split-local ordinal); -1 = hash the numeric value in-kernel
    hash_slot: int = -1

    def sig(self) -> str:
        return (f"met({self.kind},{self.values_slot},{self.present_slot},"
                f"{self.hash_slot})")


@dataclass(frozen=True)
class BucketAggExec:
    """date_histogram / histogram / terms lowered onto one bucket-index map."""
    name: str
    kind: str                    # "date_histogram" | "histogram" | "terms"
    values_slot: int             # i64/f64 column or int32 ordinals
    present_slot: int            # -1 for ordinal columns (ordinal >= 0 is presence)
    num_buckets: int             # static
    origin_slot: int = -1        # traced (histograms)
    interval_slot: int = -1      # traced (histograms)
    froms_slot: int = -1         # range agg: [nb] f64 lower bounds
    tos_slot: int = -1           # range agg: [nb] f64 upper bounds
    metrics: tuple[MetricSlots, ...] = ()
    # host-side info for finalization (not part of jit signature)
    host_info: Any = None
    # nested bucket children, arbitrary depth and siblings; each chain
    # computes over a mixed-radix flattened bucket space on device
    subs: tuple["BucketAggExec", ...] = ()

    def sig(self) -> str:
        subs_sig = ";".join(s.sig() for s in self.subs)
        return (f"bagg({self.kind},{self.values_slot},{self.present_slot},"
                f"{self.num_buckets},{self.origin_slot},{self.interval_slot},"
                f"{self.froms_slot},{self.tos_slot},"
                + ",".join(m.sig() for m in self.metrics)
                + f",subs[{subs_sig}])")


@dataclass(frozen=True)
class MetricAggExec:
    name: str
    metric: MetricSlots

    def sig(self) -> str:
        return f"magg({self.metric.sig()})"


@dataclass(frozen=True)
class CompositeSourceExec:
    """One composite-agg key source lowered onto a per-doc i32 key.

    Key encoding (order-preserving): missing → 0, value with
    ordinal/bucket-index `idx` → (idx+1)*2. The odd gap values encode
    `after` positions that fall BETWEEN this split's keys (a term absent
    from the split's dictionary lowers to insertion_point*2+1), so the
    device-side strict `key > after` comparison is exact in every split."""
    kind: str                 # "terms_ord" | "histogram" | "date_histogram"
    values_slot: int
    present_slot: int = -1    # terms_ord derives presence from ordinal >= 0
    origin_slot: int = -1     # histogram kinds (traced scalar)
    interval_slot: int = -1
    missing_bucket: bool = False
    after_slot: int = -1      # traced i32 scalar (plan.has_after only)

    def sig(self) -> str:  # qwlint: disable=QW001 - int() of a python bool dataclass field into the signature string; runs at plan-build time on host
        return (f"csrc({self.kind},{self.values_slot},{self.present_slot},"
                f"{self.origin_slot},{self.interval_slot},"
                f"{int(self.missing_bucket)},{self.after_slot})")


@dataclass(frozen=True)
class CompositeAggExec:
    """`composite` lowered TPU-first: per-source i32 key planes, one
    multi-key `lax.sort` over the doc space, run-boundary detection, and a
    static-size readback of the first `size` distinct key tuples + counts
    (role of tantivy's composite collector driven via `collector.rs:523`).

    Bucket children (`subs`) evaluate in DOC space: the sort permutation
    scatters each doc's run id (composite bucket index) back to its
    original position, and the normal nested-bucket evaluator runs with
    the composite as the outermost radix level (child flat index =
    run_id * child_nb + child_local)."""
    name: str
    sources: tuple[CompositeSourceExec, ...]
    size: int
    has_after: bool
    metrics: tuple["MetricSlots", ...] = ()
    subs: tuple["BucketAggExec", ...] = ()
    host_info: Any = None     # per-source decode info (not jit-relevant)

    def sig(self) -> str:  # qwlint: disable=QW001 - int() of a python bool dataclass field into the signature string; runs at plan-build time on host
        return (f"cagg({self.size},{int(self.has_after)},"
                + ",".join(s.sig() for s in self.sources) + ";"
                + ",".join(m.sig() for m in self.metrics) + ";"
                + ",".join(s.sig() for s in self.subs) + ")")


def coerce_numeric_bound(field_type: FieldType, value: Any):  # qwlint: disable=QW001 - coerces user query-JSON bounds (python str/int/float); no device value can reach here
    """Numeric range-bound coercion shared by the leaf lowering
    (`_parse_bound`) and the root's zonemap pruning
    (`root.extract_numeric_constraints`) — the two MUST stay identical or
    the root could prune a split the leaf matches: int() truncation for
    integer fields, the ES u64 domain clamp, float for f64. Raises
    ValueError/TypeError on unparseable input."""
    if field_type is FieldType.F64:
        return float(value)
    parsed = int(value)
    if field_type is FieldType.U64:
        # ES clamps out-of-domain u64 bounds instead of erroring
        parsed = max(0, min(parsed, (1 << 64) - 1))
    return parsed


def aligned_origin(vmin, interval, offset=0):  # qwlint: disable=QW001 - float() of the np.floor host scalar over column min/max stats, pre-dispatch
    """ES bucket alignment shared by every histogram lowering (plain and
    composite): the bucket boundary k*interval + offset at or below vmin.
    Exact integer math for date micros, float for numeric histograms."""
    if isinstance(interval, int):
        return ((vmin - offset) // interval) * interval + offset
    return float(np.floor((vmin - offset) / interval) * interval + offset)


# --------------------------------------------------------------------------
# sort

# sentinel present_slot: presence is derived on-device as values >= 0
# (dict-ordinal columns encode missing as -1; no bool column shipped)
PRESENT_FROM_VALUES = -2


@dataclass(frozen=True)
class SortExec:
    """Static sort plan: by score, by column, or by doc id; optional
    secondary key (the reference supports up to two sort fields)."""
    by: str                  # "score" | "column" | "doc"
    descending: bool = True
    values_slot: int = -1
    present_slot: int = -1
    by2: str = "none"        # "none" | "score" | "column"
    descending2: bool = True
    values2_slot: int = -1
    present2_slot: int = -1

    def sig(self) -> str:
        return (f"sort({self.by},{self.descending},{self.values_slot},"
                f"{self.present_slot},{self.by2},{self.descending2},"
                f"{self.values2_slot},{self.present2_slot})")


# --------------------------------------------------------------------------

@dataclass
class LoweredPlan:
    root: Any
    sort: SortExec
    aggs: list[Any]
    arrays: list[np.ndarray]          # device inputs, slot-indexed
    array_keys: list[str]             # cache keys for device-transfer reuse
    scalars: list[np.ndarray]         # traced scalar inputs, slot-indexed
    num_docs: int
    num_docs_padded: int
    # search_after pushdown: "none" | "lt" | "lt_tie" | "le" (static; the
    # marker value/doc travel as trailing traced scalars)
    search_after_relation: str = "none"
    sa_value_slot: int = -1
    sa_value2_slot: int = -1
    sa_doc_slot: int = -1
    # text-field (dict-ordinal) primary sort: the leaf decodes the returned
    # ordinals back to term strings; merging happens on the strings
    sort_text_field: Optional[str] = None
    # dynamic top-K threshold pushdown: traced f64 scalar (internal
    # higher-is-better key) masking sub-threshold docs before top_k. Like
    # search_after, only PRESENCE is static — the value rides a scalar slot
    # so the compiled executable is reused across threshold values. Under
    # a stacked multi-query dispatch (search/batcher.py QueryGroupPlanner)
    # every scalar slot — this one included — widens to a [Q] lane vector:
    # each query lane carries its OWN killing threshold, masked per lane
    # inside the one compiled program (executor.dispatch_plan_stacked).
    threshold_slot: int = -1
    # FOR-packed value loads: array slot -> (scale_slot, min_slot) traced
    # scalars. Consumers that need actual values (sort keys, metric/bucket
    # aggs) reconstruct `packed * scale + min` in-kernel; the SLOT map is
    # static (part of the signature), the scale/min values are traced so
    # per-split frames share one compiled executable.
    rebase: dict[int, tuple[int, int]] = dc_field(default_factory=dict)
    # impact prefix cutoff (format v3): when the lowering truncated the
    # sole scoring term's postings to the live above-threshold prefix, the
    # kernel's matched-doc count runs over fewer lanes — the exact count
    # (the term's df) is known host-side and overrides it at the leaf.
    # Host-only; deliberately NOT in the signature.
    count_override: Optional[int] = None
    # chunked execution (search/chunkexec.py): dense chunk sub-plans carry
    # the chunk's global doc offset as a traced int32 scalar so doc-id sort
    # keys and search_after doc comparisons stay in GLOBAL doc space while
    # the arrays are chunk-local. -1 (every plan the normal lowering
    # produces) keeps today's programs byte-identical; presence is static
    # (part of the signature), the offset value is traced so every chunk of
    # a split shares one compiled executable.
    doc_base_slot: int = -1

    def signature(self, k: int) -> tuple:
        # memoized per k: the signature is pure in the plan's static
        # structure (scalar VALUES are deliberately excluded, only dtypes
        # count), every mutation path goes through dataclasses.replace
        # (fresh instance -> fresh memo), and the dispatch hot path asks
        # for it up to three times per query (flight event, profile
        # attribution, executor cache key)
        memo = getattr(self, "_sig_memo", None)
        if memo is None:
            memo = {}
            object.__setattr__(self, "_sig_memo", memo)
        cached = memo.get(k)
        if cached is not None:
            return cached
        shapes = tuple((a.shape, str(a.dtype)) for a in self.arrays)
        scalar_dtypes = tuple(str(s.dtype) for s in self.scalars)
        agg_sig = ",".join(a.sig() for a in self.aggs)
        rebase_sig = tuple(sorted(
            (slot, slots) for slot, slots in self.rebase.items()))
        sig = (self.root.sig(), self.sort.sig(), agg_sig, shapes,
               scalar_dtypes, k, self.num_docs_padded,
               self.search_after_relation, self.sa_value2_slot >= 0,
               self.threshold_slot >= 0, rebase_sig,
               self.doc_base_slot >= 0)
        memo[k] = sig
        return sig

    def structure_digest(self, k: int) -> str:
        """Stable hex digest of the compile-cache structure key.

        The signature tuple is built from primitive types only (node sig
        strings, shape tuples, dtype names, ints/bools), so its repr is
        deterministic across processes — tools/qwir keys its compile-cache
        closure manifest on this digest. Anything that changes the compiled
        program's identity MUST flow through `signature` (and therefore
        through this digest), or the closure certificate stops being a
        proof."""
        import hashlib
        return hashlib.blake2b(repr(self.signature(k)).encode(),
                               digest_size=16).hexdigest()

    def group_key(self, k: int, split_key) -> tuple:
        """Grouping key for device-side multi-query stacking: two queries
        whose plans agree on this key are shape-compatible — same lowered
        structure (node sigs, sort spec, agg shape, array shapes/dtypes,
        scalar dtypes, threshold/search_after/rebase presence) over the
        same split — and may stack as lanes of ONE compiled dispatch with
        their terms/filters/thresholds riding stacked operands
        (docs/query-batching.md). Deliberately WIDER than the convoy key
        (which also pins `array_keys`): distinct queries are the point."""
        return ("qb", self.structure_digest(k), split_key)


class _Builder:
    def __init__(self, reader: SplitReader):
        self.reader = reader
        self.arrays: list[np.ndarray] = []
        self.array_keys: list[str] = []
        self.scalars: list[np.ndarray] = []
        self._array_slots: dict[str, int] = {}

    def add_array(self, key: str, fetch) -> int:  # qwlint: disable=QW001 - np.asarray stages host column data into the plan's jit-input tuple; columns are numpy by the reader contract
        """Deduplicated array slot; `fetch()` runs only on first use."""
        slot = self._array_slots.get(key)
        if slot is None:
            slot = len(self.arrays)
            self.arrays.append(np.asarray(fetch()))
            self.array_keys.append(key)
            self._array_slots[key] = slot
        return slot

    def add_scalar(self, value, dtype) -> int:  # qwlint: disable=QW001 - np.asarray on python/numpy plan scalars being staged as jit inputs, pre-dispatch
        self.scalars.append(np.asarray(value, dtype=dtype))
        return len(self.scalars) - 1


# --------------------------------------------------------------------------

class Lowering:
    """`batch_overrides` (multi-split batches, parallel/fanout.py) forces a
    split-independent plan structure: missing terms lower to empty posting
    slots instead of PMatchNone, date_histogram bucket spaces come from the
    batch-global time range, and terms-agg ordinals are remapped to a
    batch-global dictionary."""

    def __init__(self, doc_mapper: DocMapper, reader: SplitReader,
                 batch_overrides: Optional[dict] = None,
                 absence_sink=None):
        self.doc_mapper = doc_mapper
        self.reader = reader
        self.b = _Builder(reader)
        # absence_sink(field, term): every term-dictionary miss is an
        # immutable proof of absence in this split — feeds the predicate/
        # negative cache (predicate_cache.py)
        self.absence_sink = absence_sink
        self.batch = batch_overrides  # {"histograms": {name: (origin, nb)},
                                      #  "terms_dicts": {field: {key: gord}},
                                      #  "terms_cards": {field: int}}
        # FOR-packed slots needing in-kernel reconstruction (LoweredPlan.rebase)
        self.rebase: dict[int, tuple[int, int]] = {}
        # impact prefix-cutoff context, armed by lower_request ONLY when the
        # whole query is a single scoring term with a pushed-down threshold
        # (no aggs / filters / search_after / time window / batch): the one
        # shape where dropping a term's below-threshold posting tail cannot
        # change any result the threshold mask would keep
        self._impact_term: Optional[tuple[str, str, float]] = None
        self._impact_threshold: Optional[float] = None
        self.count_override: Optional[int] = None

    # --- helpers ----------------------------------------------------------
    def _field(self, name: str) -> FieldMapping:
        fm = self.doc_mapper.field(name)
        if fm is None:
            if (name == "_doc_length"
                    and self.doc_mapper.store_document_size):
                return FieldMapping("_doc_length", FieldType.I64,
                                    fast=True, indexed=False)
            if (self.doc_mapper.mode == "dynamic"
                    and not self.doc_mapper.shadows_concrete_field(name)):
                # unmapped path under dynamic mode: the split may hold it
                # as a materialized dynamic field; term lookups on splits
                # that never saw the path lower to empty postings
                return self.doc_mapper.dynamic_field(name)
            raise PlanError(f"unknown field {name!r}")
        return fm

    def _postings_node(self, field: str, term: str, scoring: bool,
                       boost: float) -> Any:
        fm = self.doc_mapper.field(field)
        if fm is not None and fm.tokenizer == "en_stem":
            extra = self.reader.footer.extra or {}
            from ..index.writer import ANALYZER_VERSION
            if extra.get("analyzer_version", 1) != ANALYZER_VERSION:
                # stemmer output changed since this split was written:
                # query-side terms may not match — results need a reindex
                emit, _ = _ANALYZER_WARN.should_log("analyzer")
                if emit:
                    logger.warning(
                        "split %s was written with analyzer_version %s "
                        "(current %s): en_stem terms may mismatch — "
                        "reindex to refresh", self.reader.path,
                        extra.get("analyzer_version", 1), ANALYZER_VERSION)
        info = self.reader.lookup_term(field, term)
        if info is None:
            if self.absence_sink is not None:
                self.absence_sink(field, term)
            if self.batch is None:
                return PMatchNone()
            return self._empty_postings_node(field, term, scoring)
        impact_ordered = self.reader.impact_info(field) is not None
        prefix = None
        if (scoring and impact_ordered and self.batch is None
                and self._impact_term is not None
                and self._impact_term[0] == field
                and self._impact_term[1] == term):
            prefix = self._impact_prefix(field, info, boost)
        if prefix is not None and prefix["live_len"] < info.post_len:
            # impact order makes the threshold cutoff a PREFIX cutoff: the
            # tail never stages to HBM (smaller arrays fall through the
            # same HbmBudget/residency accounting), and the matched-doc
            # count is restored host-side from the term's df
            live_len = prefix["live_len"]
            ids_slot = self.b.add_array(
                f"post.{field}.{info.ordinal}.ids@{live_len}",
                lambda: self.reader.array_slice(
                    f"inv.{field}.postings.ids", info.post_off, live_len))
            tfs_slot = self.b.add_array(
                f"post.{field}.{info.ordinal}.tfs@{live_len}",
                lambda: self.reader.array_slice(
                    f"inv.{field}.postings.tfs", info.post_off, live_len))
            self.count_override = info.df
        else:
            ids_slot = self.b.add_array(
                f"post.{field}.{info.ordinal}.ids",
                lambda: self.reader.postings(field, info)[0])
            tfs_slot = self.b.add_array(
                f"post.{field}.{info.ordinal}.tfs",
                lambda: self.reader.postings(field, info)[1])
        if not scoring:
            return PPostings(ids_slot, tfs_slot, scoring=False,
                             impact_ordered=impact_ordered)
        meta = self.reader.field_meta(field)
        norm_slot = self._fieldnorm_slot(field)
        idf_value = bm25_idf(self.reader.num_docs, info.df) * boost
        idf_slot = self.b.add_scalar(idf_value, np.float32)
        avg_slot = self.b.add_scalar(meta.get("avg_len", 1.0), np.float32)
        bmax_slot = scale_slot = -1
        if prefix is not None:
            live_blocks = prefix["live_blocks"]
            bmax_live = prefix["bmax"][:live_blocks]
            bmax_slot = self.b.add_array(
                f"impact.{field}.{info.ordinal}.bmax@{live_blocks}",
                lambda: bmax_live)
            # boost folds into the traced scale exactly like it folds into
            # the idf scalar, so the kernel bound covers the boosted score
            scale_slot = self.b.add_scalar(prefix["scale"] * boost,
                                           np.float64)
        return PPostings(ids_slot, tfs_slot, True, norm_slot, idf_slot,
                         avg_slot, impact_bmax_slot=bmax_slot,
                         impact_scale_slot=scale_slot,
                         impact_ordered=impact_ordered)

    def _impact_prefix(self, field: str, info: "TermInfo", boost: float):
        """Host-side prefix-cutoff decision for one impact-ordered term:
        how many leading 128-posting blocks can still reach the pushed-down
        threshold. Block bounds are non-increasing (postings sorted by
        descending impact), so the live set is a prefix; its length rounds
        UP to a power of two of blocks (capped at the term's total) to keep
        the distinct staged shapes — and therefore executor recompiles —
        logarithmic in term length. Returns None when the side arrays are
        unusable."""
        from .hostdecode import host_int
        bmax, scale = self.reader.impact_term_bounds(field, info)
        nblocks = info.post_len // IMPACT_BLOCK
        if nblocks <= 0 or bmax.shape[0] != nblocks:
            return None
        bounds = bmax.astype(np.float64) * (np.float64(scale) * boost)
        live = host_int(np.count_nonzero(bounds >= self._impact_threshold))
        # at least one block stays: downstream shapes must be non-empty,
        # and the kernel mask handles an all-dead block exactly
        live_blocks = 1
        while live_blocks < live:
            live_blocks *= 2
        live_blocks = min(live_blocks, nblocks)
        skipped = nblocks - live_blocks
        from ..observability.profile import profile_add
        profile_add("impact_blocks_scored", live_blocks)
        from ..observability.metrics import (
            IMPACT_BLOCKS_SCORED_TOTAL, IMPACT_BLOCKS_SKIPPED_TOTAL,
            IMPACT_POSTINGS_BYTES_AVOIDED_TOTAL, IMPACT_PREFIX_CUTOFFS_TOTAL)
        IMPACT_BLOCKS_SCORED_TOTAL.inc(live_blocks)
        if skipped > 0:
            # ids + tfs are int32: 8 bytes per posting never staged
            bytes_avoided = skipped * IMPACT_BLOCK * 8
            profile_add("impact_blocks_skipped", skipped)
            profile_add("impact_postings_bytes_avoided", bytes_avoided)
            profile_add("impact_prefix_cutoffs")
            IMPACT_BLOCKS_SKIPPED_TOTAL.inc(skipped)
            IMPACT_POSTINGS_BYTES_AVOIDED_TOTAL.inc(bytes_avoided)
            IMPACT_PREFIX_CUTOFFS_TOTAL.inc()
        return {"bmax": bmax, "scale": scale, "live_blocks": live_blocks,
                "live_len": live_blocks * IMPACT_BLOCK}

    def _fieldnorm_slot(self, field: str) -> int:
        """Fieldnorm array slot, tolerating splits that never materialized
        the field (dynamic-mode paths absent from a split): zeros keep the
        plan structure uniform and contribute nothing to BM25."""
        reader = self.reader
        if reader.has_array(f"inv.{field}.fieldnorm"):
            return self.b.add_array(
                f"norm.{field}", lambda: reader.fieldnorm(field))
        return self.b.add_array(
            f"norm.{field}.absent",
            lambda: np.zeros(reader.num_docs_padded, dtype=np.int32))

    def _empty_postings_node(self, field: str, term: str, scoring: bool) -> Any:
        """Uniform-structure stand-in for a term absent from this split."""
        from ..index.format import POSTING_PAD
        # impact_ordered is in the plan sig: the stand-in has no postings
        # (either storage-order claim is vacuously true), so mirror the
        # batch peers that do hold the field — otherwise a v3 batch with
        # the field absent from ONE split fails the uniformity check
        impact = any(
            r.impact_info(field) is not None
            for r in self.batch.get("batch_readers", ()))
        sentinel = self.reader.num_docs_padded
        ids_slot = self.b.add_array(
            f"post.{field}.absent:{term}.ids",
            lambda: np.full(POSTING_PAD, sentinel, dtype=np.int32))
        tfs_slot = self.b.add_array(
            f"post.{field}.absent:{term}.tfs",
            lambda: np.zeros(POSTING_PAD, dtype=np.int32))
        if not scoring:
            return PPostings(ids_slot, tfs_slot, scoring=False,
                             impact_ordered=impact)
        meta = self.reader.field_meta(field)
        norm_slot = self._fieldnorm_slot(field)
        idf_slot = self.b.add_scalar(0.0, np.float32)
        avg_slot = self.b.add_scalar(meta.get("avg_len", 1.0), np.float32)
        return PPostings(ids_slot, tfs_slot, True, norm_slot, idf_slot,
                         avg_slot, impact_ordered=impact)

    def _precomputed_node(self, key: str, ids: np.ndarray, freqs: np.ndarray,  # qwlint: disable=QW001 - int() of the host-side document frequency from reader metadata when minting the idf scalar
                          field: str, scoring: bool, boost: float,
                          df_for_idf: int) -> Any:
        from ..index.format import POSTING_PAD, pad_to
        if ids.size == 0 and self.batch is None:
            return PMatchNone()
        padded = pad_to(max(ids.size, 1), POSTING_PAD)
        pids = np.full(padded, self.reader.num_docs_padded, dtype=np.int32)
        ptfs = np.zeros(padded, dtype=np.int32)
        pids[: ids.size] = ids
        ptfs[: freqs.size] = freqs
        ids_slot = self.b.add_array(f"pre.{key}.ids", lambda: pids)
        tfs_slot = self.b.add_array(f"pre.{key}.tfs", lambda: ptfs)
        if not scoring:
            return PPostings(ids_slot, tfs_slot, scoring=False)
        meta = self.reader.field_meta(field)
        norm_slot = self._fieldnorm_slot(field)
        idf_slot = self.b.add_scalar(
            bm25_idf(self.reader.num_docs, max(int(df_for_idf), 1)) * boost, np.float32)
        avg_slot = self.b.add_scalar(meta.get("avg_len", 1.0), np.float32)
        return PPostings(ids_slot, tfs_slot, True, norm_slot, idf_slot, avg_slot)

    def _column_slots(self, field: str) -> tuple[int, int]:
        fm = self._field(field)
        if not fm.fast:
            raise PlanError(f"field {field!r} is not a fast field")
        packed = self._packed_column_slots(field)
        if packed is not None:
            return packed
        values_slot = self.b.add_array(
            f"col.{field}.values", lambda: self.reader.column_values(field)[0])
        present_slot = self.b.add_array(
            f"col.{field}.present", lambda: self.reader.column_values(field)[1])
        return values_slot, present_slot

    def _packed_column_slots(self, field: str) -> Optional[tuple[int, int]]:
        """Column slots over the PACKED delta lanes (format v2): the narrow
        array is what ships to HBM, and a per-slot rebase entry (traced
        scale/min scalars) tells value consumers to reconstruct
        `delta * scale + min` in-register — full-width semantics, compact
        bytes. Works under batch plans: the slot map is structural, the
        frame values ride per-split traced scalars."""
        info = self.reader.column_packing(field)
        if info is None:
            return None
        values_slot = self.b.add_array(
            f"col.{field}.packed",
            lambda: self.reader.column_packed(field)[0])
        present_slot = self.b.add_array(
            f"col.{field}.present",
            lambda: self.reader.column_packed(field)[1])
        if values_slot not in self.rebase:
            meta = self.reader.field_meta(field)
            sdtype = (np.uint64
                      if (meta.get("col_type") or meta.get("type")) == "u64"
                      else np.int64)
            scale_slot = self.b.add_scalar(info["for_scale"], sdtype)
            min_slot = self.b.add_scalar(info["for_min"], sdtype)
            self.rebase[values_slot] = (scale_slot, min_slot)
        return values_slot, present_slot

    def _zonemap_slots(self, field: str) -> tuple[int, int]:
        """(zmin_slot, zmax_slot) of a column's block zonemaps, or (-1, -1)
        for splits that predate them (format v1)."""
        zm = self.reader.column_zonemaps(field)
        if zm is None:
            return -1, -1
        zmin_slot = self.b.add_array(f"col.{field}.zmin", lambda: zm[0])
        zmax_slot = self.b.add_array(f"col.{field}.zmax", lambda: zm[1])
        return zmin_slot, zmax_slot

    def _parse_bound(self, fm: FieldMapping, value: Any) -> Any:  # qwlint: disable=QW001 - int() truncation of query-JSON bounds on host (mirrors coerce_numeric_bound)
        if fm.type is FieldType.DATETIME:
            return parse_datetime_to_micros(value, fm.input_formats) \
                if not isinstance(value, (int, float)) or isinstance(value, bool) \
                else parse_datetime_to_micros(value, ("unix_timestamp",))
        if fm.type in (FieldType.I64, FieldType.U64, FieldType.F64):
            return coerce_numeric_bound(fm.type, value)
        if fm.type is FieldType.IP:
            return int(value)
        if fm.type is FieldType.BOOL:
            return 1 if str(value).lower() == "true" else 0
        raise PlanError(f"range query unsupported on field type {fm.type}")

    # --- node lowering ----------------------------------------------------
    def lower(self, ast: Q.QueryAst, scoring: bool, boost: float = 1.0) -> Any:
        if isinstance(ast, Q.MatchAll):
            return PMatchAll()
        if isinstance(ast, Q.MatchNone):
            return PMatchNone()
        if isinstance(ast, Q.Boost):
            return self.lower(ast.underlying, scoring, boost * ast.boost)
        if isinstance(ast, Q.Term):
            return self._lower_term(ast, scoring, boost)
        if isinstance(ast, Q.TermSet):
            nodes = []
            for field, terms in ast.terms_per_field.items():
                fm = self._field(field)
                for term in terms:
                    if not fm.indexed and fm.fast \
                            and fm.type is FieldType.TEXT:
                        nodes.append(self._fast_only_term(field, term))
                    else:
                        nodes.append(self._postings_node(
                            field, self._canonical(fm, term), False, boost))
            return self._or(nodes)
        if isinstance(ast, Q.FullText):
            return self._lower_full_text(ast, scoring, boost)
        if isinstance(ast, Q.PhrasePrefix):
            return self._lower_phrase_prefix(ast, scoring, boost)
        if isinstance(ast, Q.Wildcard):
            pattern = ast.pattern
            fm_w = self.doc_mapper.field(ast.field)
            if (fm_w is not None and fm_w.type is FieldType.TEXT
                    and fm_w.tokenizer not in ("raw", "whitespace")):
                # ES analyzes wildcard terms with the field's analyzer:
                # `Jou*al` matches tokens of lowercasing tokenizers
                # (raw and whitespace preserve case)
                pattern = pattern.lower()
            return self._lower_pattern(
                ast.field, fnmatch.translate(pattern), scoring, boost,
                literal_prefix=("" if ast.case_insensitive
                                else _wildcard_prefix(pattern)),
                case_insensitive=ast.case_insensitive)
        if isinstance(ast, Q.Regex):
            return self._lower_pattern(
                ast.field, ast.pattern, scoring, boost,
                literal_prefix=("" if ast.case_insensitive
                                else _regex_prefix(ast.pattern)),
                case_insensitive=ast.case_insensitive)
        if isinstance(ast, Q.FieldPresence):
            return self._lower_presence(ast.field)
        if isinstance(ast, Q.Range):
            return self._lower_range(ast)
        if isinstance(ast, Q.Bool):
            return PBool(
                must=tuple(self.lower(c, scoring, boost) for c in ast.must),
                must_not=tuple(self.lower(c, False, boost) for c in ast.must_not),
                should=tuple(self.lower(c, scoring, boost) for c in ast.should),
                filter=tuple(self.lower(c, False, boost) for c in ast.filter),
                minimum_should_match=ast.minimum_should_match,
            )
        raise PlanError(f"cannot lower query node {type(ast).__name__}")

    def _canonical(self, fm: FieldMapping, value: str) -> str:
        # single source of truth shared with the predicate cache's
        # required-term extraction: a drift between the two would make
        # negative-cache pruning unsound, not just ineffective
        from .predicate_cache import canonical_query_term
        return canonical_query_term(fm, value)

    def _lower_term(self, ast: Q.Term, scoring: bool, boost: float) -> Any:
        from .predicate_cache import term_is_tokenized_text
        fm = self._field(ast.field)
        if not ast.verbatim and term_is_tokenized_text(fm):
            # terms on tokenized text behave as a conjunctive full-text match
            # (quickwit's query language semantics)
            return self._lower_full_text(
                Q.FullText(ast.field, ast.value, "and"), scoring, boost)
        if not fm.indexed:
            if fm.fast and fm.type is FieldType.TEXT:
                # fast-only text field: exact-term match as an ordinal
                # EQUALITY on the dictionary column (reference: fast-field
                # queries on index:false fields)
                return self._fast_only_term(ast.field, ast.value)
            raise PlanError(f"field {ast.field!r} is not indexed")
        value = ast.value
        if (not ast.verbatim and fm.type is FieldType.TEXT
                and fm.tokenizer == "lowercase"):
            value = value.lower()
        return self._postings_node(ast.field, self._canonical(fm, value), scoring, boost)

    def _lower_full_text(self, ast: Q.FullText, scoring: bool, boost: float) -> Any:
        fm = self._field(ast.field)
        if fm.type is not FieldType.TEXT:
            return self._postings_node(ast.field, self._canonical(fm, ast.text),
                                       scoring, boost)
        if not fm.indexed:
            if fm.fast:
                # fast-only text field: the query text matches the exact
                # stored value on the dictionary column (reference:
                # fast-field search on index:false fields)
                return self._fast_only_term(ast.field, ast.text)
            raise PlanError(f"field {ast.field!r} is not indexed")
        tokens = get_tokenizer(fm.tokenizer)(ast.text)
        if not tokens:
            # ES zero_terms_query: "all" matches everything when the text
            # tokenizes to nothing (e.g. punctuation-only)
            if getattr(ast, "zero_terms", "none") == "all":
                return PMatchAll()
            return PMatchNone()
        if ast.mode in ("bool_prefix_and", "bool_prefix_or"):
            # match_bool_prefix: every analyzed token is a term match
            # except the LAST, which matches as a prefix
            prefix_node = self._lower_phrase_prefix(
                Q.PhrasePrefix(ast.field, tokens[-1].text), scoring, boost)
            term_nodes = [self._postings_node(ast.field, t.text, scoring,
                                              boost)
                          for t in tokens[:-1]]
            clauses = tuple(term_nodes) + (prefix_node,)
            if len(clauses) == 1:
                return clauses[0]
            if ast.mode == "bool_prefix_and":
                return PBool(must=clauses)
            return PBool(should=clauses, minimum_should_match=1)
        if ast.mode == "phrase" and len(tokens) > 1:
            return self._lower_phrase(ast.field, [t.text for t in tokens],
                                      ast.slop, scoring, boost)
        nodes = [self._postings_node(ast.field, t.text, scoring, boost)
                 for t in tokens]
        if len(nodes) == 1:
            return nodes[0]
        if ast.mode in ("and", "phrase"):
            return PBool(must=tuple(nodes))
        return self._or(nodes, scoring=scoring)

    def _lower_phrase(self, field: str, terms: list[str], slop: int,
                      scoring: bool, boost: float) -> Any:
        fm = self._field(field)
        if fm.record != "position":
            raise PlanError(
                f"phrase query on field {field!r} requires record='position'")
        infos = []
        empty = np.array([], dtype=np.int32)
        for term in terms:
            info = self.reader.lookup_term(field, term)
            if info is None:
                if self.absence_sink is not None:
                    self.absence_sink(field, term)
                if self.batch is None:
                    return PMatchNone()
                # batch mode: keep the structure uniform across splits
                return self._precomputed_node(
                    f"{field}.phrase.absent:" + "/".join(terms), empty, empty,
                    field, scoring, boost, df_for_idf=0)
            infos.append(info)
        postings = [self.reader.postings(field, i) for i in infos]
        positions = [self.reader.positions(field, i) for i in infos]
        ids, freqs = phrase_match(postings, positions, [i.df for i in infos],
                                  slop, term_keys=terms)
        key = f"{field}.phrase." + ".".join(str(i.ordinal) for i in infos)
        if slop > 0:
            # the matches depend on the slop: without it in the staging key
            # a sloppy phrase after the exact one of the same terms would
            # score the exact phrase's staged postings (the JAX package
            # keys them by the terms alone)
            key += f".slop{slop}"
        return self._precomputed_node(key, ids, freqs, field, scoring, boost,
                                      df_for_idf=ids.size)

    def _lower_phrase_prefix(self, ast: Q.PhrasePrefix, scoring: bool, boost: float) -> Any:
        fm = self._field(ast.field)
        tokenizer_name = getattr(ast, "analyzer", None) or fm.tokenizer
        tokens = [t.text for t in get_tokenizer(tokenizer_name)(ast.phrase)]
        if not tokens:
            return PMatchNone()
        td = self.reader.term_dict(ast.field)
        if td is None:
            return PMatchNone()
        prefix = tokens[-1]
        expansions = []
        budget = ast.max_expansions
        for term, _df in td.iter_terms(start=prefix):
            if not term.startswith(prefix):
                break
            expansions.append(term)
            # the exact term is a match, not an "expansion": it does not
            # consume the budget (tantivy prefix semantics)
            if term != prefix:
                budget -= 1
            if budget <= 0:
                break
        if not expansions:
            return PMatchNone()
        if len(tokens) == 1:
            return self._or([self._postings_node(ast.field, t, scoring, boost)
                             for t in expansions], scoring=scoring)
        nodes = [self._lower_phrase(ast.field, tokens[:-1] + [exp], 0, scoring, boost)
                 for exp in expansions]
        return self._or(nodes, scoring=scoring)

    def _lower_pattern(self, field: str, pattern: str, scoring: bool,
                       boost: float, literal_prefix: str = "",
                       case_insensitive: bool = False) -> Any:
        fm = self._field(field)
        td = self.reader.term_dict(field)
        if td is None:
            return PMatchNone()
        compiled = re.compile(pattern,
                              re.IGNORECASE if case_insensitive else 0)
        matches = []
        for term, _df in td.iter_terms(start=literal_prefix or None):
            if literal_prefix and not term.startswith(literal_prefix):
                break
            if compiled.fullmatch(term):
                matches.append(term)
                if len(matches) > MAX_EXPANSIONS:
                    raise PlanError(
                        f"pattern on {field!r} expands to more than {MAX_EXPANSIONS} terms")
        return self._or([self._postings_node(field, t, False, boost) for t in matches])

    def _lower_presence(self, field: str) -> Any:
        fm = self.doc_mapper.field(field)
        if fm is None:
            # ES exists semantics: an unknown field name may be the parent
            # path of mapped dotted fields ("payload" covers "payload.*");
            # a name matching nothing simply matches no documents
            prefix = field + "."
            children = [f for f in self.doc_mapper.field_mappings
                        if f.name.startswith(prefix)
                        and (f.fast or (f.indexed
                                        and f.type is FieldType.TEXT))]
            nodes = [self._lower_presence(f.name) for f in children]
            if self.doc_mapper.mode == "dynamic":
                # per-split dynamic fields from the footer registry: the
                # exact path, or any materialized leaf under it
                for name, meta in self.reader.footer.fields.items():
                    if not meta.get("dynamic"):
                        continue
                    if name == field or name.startswith(prefix):
                        nodes.append(self._dynamic_presence(name, meta))
            if not nodes:
                return PMatchNone()
            return self._or(nodes)
        if fm.fast:
            meta = self.reader.field_meta(field)
            if meta.get("column_kind") == "ordinal":
                slot = self.b.add_array(
                    f"col.{field}.ordinals", lambda: self.reader.column_ordinals(field))
                return PPresence(slot, is_ordinal=True)
            _vals, present_slot = self._column_slots(field)
            return PPresence(present_slot)
        if fm.indexed and fm.type is FieldType.TEXT:
            return PNormPresence(self._fieldnorm_slot(field))
        raise PlanError(f"presence query needs a fast or indexed text field: {field!r}")

    def _dynamic_presence(self, name: str, meta: dict) -> Any:
        """Presence of one materialized dynamic field in this split."""
        kind = meta.get("column_kind")
        if kind == "ordinal":
            slot = self.b.add_array(
                f"col.{name}.ordinals",
                lambda: self.reader.column_ordinals(name))
            return PPresence(slot, is_ordinal=True)
        if kind == "numeric":
            _vals, present_slot = self._column_slots(name)
            return PPresence(present_slot)
        if meta.get("indexed"):
            return PNormPresence(self._fieldnorm_slot(name))
        return PMatchNone()

    def _fast_only_term(self, field: str, value: str) -> Any:
        """Exact term on a fast-only (index:false) text field: an ordinal
        equality interval on the dictionary column."""
        fm = self._field(field)
        return self._lower_text_range(Q.Range(
            field, lower=Q.RangeBound(value, True),
            upper=Q.RangeBound(value, True)), fm)

    def _lower_text_range(self, ast: Q.Range, fm: FieldMapping) -> Any:
        """Lexicographic range on a text field via the sorted ordinal
        column (ordinals are assigned in sorted term order, so the range
        becomes an integer ordinal interval computed host-side — ES range
        on keyword semantics)."""
        import bisect
        if not fm.fast:
            raise PlanError(
                f"range on text field {ast.field!r} requires fast=true")
        meta = self.reader.field_meta(ast.field)
        if meta.get("column_kind") != "ordinal":
            raise PlanError(
                f"range on text field {ast.field!r} needs an ordinal column")
        terms = self.reader.column_dict(ast.field)

        def norm(v: Any) -> str:
            text = str(v)
            return text.lower() if fm.normalizer == "lowercase" else text

        lo_ord = 0
        hi_ord = len(terms) - 1
        if ast.lower is not None:
            v = norm(ast.lower.value)
            lo_ord = (bisect.bisect_left(terms, v) if ast.lower.inclusive
                      else bisect.bisect_right(terms, v))
        if ast.upper is not None:
            v = norm(ast.upper.value)
            hi_ord = (bisect.bisect_right(terms, v) - 1
                      if ast.upper.inclusive
                      else bisect.bisect_left(terms, v) - 1)
        if lo_ord > hi_ord:
            if self.batch is None:
                return PMatchNone()
            lo_ord, hi_ord = 0, -1  # uniform structure, empty interval
        ord_slot = self.b.add_array(
            f"col.{ast.field}.ordinals",
            lambda: self.reader.column_ordinals(ast.field))
        present_slot = self.b.add_array(
            f"col.{ast.field}.ord_present",
            lambda: (self.reader.column_ordinals(ast.field) >= 0)
            .astype(np.uint8))
        lo_slot = self.b.add_scalar(lo_ord, np.int32)
        hi_slot = self.b.add_scalar(hi_ord, np.int32)
        return PRange(ord_slot, present_slot, lo_slot, hi_slot, True, True)

    def _lower_range(self, ast: Q.Range, bounds_are_micros: bool = False) -> Any:  # qwlint: disable=QW001 - int() of host-coerced query bounds when choosing the packed fast path
        """`bounds_are_micros`: bounds on a datetime field are already in
        micros (request-level time filters) — skip input-format parsing."""
        fm = self._field(ast.field)
        if (self.doc_mapper.field(ast.field) is None
                and self.doc_mapper.mode == "dynamic"
                and fm.type is FieldType.TEXT):
            # dynamic path: route by the column this split actually
            # materialized (string→ordinal, numeric→typed values); a
            # split that never saw the field (or coerced it to another
            # class) matches nothing
            meta = self.reader.field_meta(ast.field)
            kind = meta.get("column_kind")
            if kind == "numeric":
                fm = FieldMapping(ast.field,
                                  FieldType(meta.get("col_type", "f64")),
                                  fast=True, indexed=False)
            elif kind != "ordinal":
                return PMatchNone()
        if fm.type is FieldType.TEXT:
            return self._lower_text_range(ast, fm)
        dtype = (np.float64 if fm.type is FieldType.F64
                 else np.uint64 if fm.type is FieldType.U64
                 else np.int64)
        if bounds_are_micros:
            parse = lambda v: int(v)  # noqa: E731
        elif ast.format and fm.type is FieldType.DATETIME:
            from ..utils.datetime_utils import parse_java_time_format
            parse = lambda v: parse_java_time_format(ast.format, str(v))  # noqa: E731
        else:
            parse = lambda v: self._parse_bound(fm, v)  # noqa: E731
        if fm.type is FieldType.DATETIME and fm.fast_precision:
            # bounds truncate to the column precision, matching stored
            # values (reference fast_precision semantics)
            from ..utils.datetime_utils import truncate_to_precision
            base_parse = parse
            parse = lambda v: truncate_to_precision(  # noqa: E731
                base_parse(v), fm.fast_precision)
        lo_val = parse(ast.lower.value) if ast.lower is not None else None
        hi_val = parse(ast.upper.value) if ast.upper is not None else None
        lo_incl = ast.lower.inclusive if ast.lower is not None else True
        hi_incl = ast.upper.inclusive if ast.upper is not None else True

        packed = self._packed_range_slots(ast.field, fm, lo_val, lo_incl,
                                          hi_val, hi_incl)
        if packed is not None:
            return packed

        s32 = self._s32_range_slots(ast.field, fm, lo_val, lo_incl,
                                    hi_val, hi_incl)
        if s32 is not None:
            return PRange(*s32, lo_incl, hi_incl)

        values_slot, present_slot = self._column_slots(ast.field)
        lo_slot = (self.b.add_scalar(lo_val, dtype)
                   if lo_val is not None else -1)
        hi_slot = (self.b.add_scalar(hi_val, dtype)
                   if hi_val is not None else -1)
        zmin_slot, zmax_slot = self._zonemap_slots(ast.field)
        return PRange(values_slot, present_slot, lo_slot, hi_slot,
                      lo_incl, hi_incl, zmin_slot, zmax_slot)

    def _packed_range_slots(self, field: str, fm: FieldMapping, lo_val,  # qwlint: disable=QW001 - int() of numpy packing metadata (bit widths, frame mins) from the column header, pre-dispatch
                            lo_incl: bool, hi_val, hi_incl: bool):
        """Narrow-integer fast path for range predicates over FOR-packed
        columns: bounds rebase host-side into the scaled delta domain
        (`ceil((lo - for_min) / for_scale)` / floor for the upper), so the
        kernel compares the u8/u16/u32 delta lanes against i32 scalars —
        no full-width operands in HBM and no i64 emulation on device.
        EXACT for every bound: stored values are for_min + k*for_scale, so
        the monotone ceil/floor rebase preserves the predicate. Bounds
        normalize to inclusive integers first; out-of-frame bounds clamp
        to span+1 / -1, which match nothing (deltas live in [0, span]).
        Returns a complete PRange (with zonemap gating) or None."""
        if fm.type is FieldType.F64:
            return None  # f64 columns are never packed
        info = self.reader.column_packing(field)
        if info is None:
            return None
        m, s = int(info["for_min"]), int(info["for_scale"])
        meta = self.reader.field_meta(field)
        span = (int(meta["max_value"]) - m) // s  # fits i32 by construction
        if lo_val is None:
            lo_r = 0
        else:
            lo_exact = int(lo_val) + (0 if lo_incl else 1)
            lo_r = -((m - lo_exact) // s)  # ceil((lo - m) / s)
        if hi_val is None:
            hi_r = span
        else:
            hi_exact = int(hi_val) - (0 if hi_incl else 1)
            hi_r = (hi_exact - m) // s     # floor((hi - m) / s)
        lo_r = max(0, min(lo_r, span + 1))
        hi_r = max(-1, min(hi_r, span))
        values_slot = self.b.add_array(
            f"col.{field}.packed",
            lambda: self.reader.column_packed(field)[0])
        present_slot = self.b.add_array(
            f"col.{field}.present",
            lambda: self.reader.column_packed(field)[1])
        lo_slot = self.b.add_scalar(lo_r, np.int32)
        hi_slot = self.b.add_scalar(hi_r, np.int32)
        zmin_slot, zmax_slot = self._zonemap_slots(field)
        return PRange(values_slot, present_slot, lo_slot, hi_slot,
                      True, True, zmin_slot, zmax_slot)

    def _s32_range_slots(self, field: str, fm: FieldMapping, lo_val,  # qwlint: disable=QW001 - int() of host query bounds snapped to the i32-seconds domain, pre-dispatch
                         lo_incl: bool, hi_val, hi_incl: bool):
        """i32-seconds fast path for datetime range filters (the range
        twin of the date_histogram s32 path): i64 compares are emulated
        on TPU and the µs values column is 2x the HBM bytes of the
        derived seconds column. EXACT for whole-second inclusive-lower /
        exclusive-upper bounds regardless of sub-second values, because
        floor is monotone: ts >= L*1e6 <=> floor(ts/1e6) >= L, and
        ts < U*1e6 <=> floor(ts/1e6) < U. Any other bound shape (or a
        batch plan, whose per-split base would break uniformity) returns
        None and takes the i64 path. Returns (values_slot, present_slot,
        lo_slot, hi_slot) or None."""
        if (fm.type is not FieldType.DATETIME or self.batch is not None
                or (lo_val is not None
                    and not (lo_incl and lo_val % 1_000_000 == 0))
                or (hi_val is not None
                    and not (not hi_incl and hi_val % 1_000_000 == 0))):
            return None
        meta = self.reader.field_meta(field)
        vmin, vmax = meta.get("min_value"), meta.get("max_value")
        if vmin is None:
            return None
        base_s = vmin // 1_000_000
        # every compared quantity must fit i32 after the base shift;
        # out-of-split bounds clamp (equivalent: they pass/fail all docs)
        span_ok = (vmax // 1_000_000 - base_s) < 2**31 - 2
        if not span_ok:
            return None

        def offset(bound_micros: int) -> int:
            shifted = bound_micros // 1_000_000 - base_s
            return int(max(-(2**31) + 2, min(shifted, 2**31 - 2)))

        values_slot, present_slot = self._s32_column_slots(field, base_s)
        lo_slot = (self.b.add_scalar(offset(lo_val), np.int32)
                   if lo_val is not None else -1)
        hi_slot = (self.b.add_scalar(offset(hi_val), np.int32)
                   if hi_val is not None else -1)
        return values_slot, present_slot, lo_slot, hi_slot

    def _or(self, nodes: list, scoring: bool = False) -> Any:
        nodes = [n for n in nodes if not isinstance(n, PMatchNone)]
        if not nodes:
            return PMatchNone()
        if len(nodes) == 1:
            return nodes[0]
        return PBool(should=tuple(nodes))

    # --- aggregations -----------------------------------------------------
    def lower_metric(self, spec: MetricAgg) -> MetricSlots:
        fm = self._field(spec.field)
        if spec.kind == "cardinality":
            return self._lower_cardinality(spec, fm)
        if fm.type is FieldType.TEXT:
            raise PlanError(f"metric aggregation on text field {spec.field!r}")
        values_slot, present_slot = self._column_slots(spec.field)
        return MetricSlots(spec.name, spec.kind, values_slot, present_slot,
                           tuple(spec.percents),
                           keyed=getattr(spec, "keyed", True))

    def _lower_cardinality(self, spec: MetricAgg,
                           fm: FieldMapping) -> MetricSlots:
        """Cardinality via HLL registers computed on device. Text columns
        gather host-precomputed per-ordinal TERM hashes so register merges
        are consistent across splits (ordinals are split-local)."""
        if not fm.fast:
            raise PlanError(
                f"cardinality aggregation requires fast field {spec.field!r}")
        meta = self.reader.field_meta(spec.field)
        if meta.get("column_kind") == "ordinal":
            ord_slot = self.b.add_array(
                f"col.{spec.field}.ordinals",
                lambda: self.reader.column_ordinals(spec.field))

            def term_hashes() -> np.ndarray:
                from ..ops.aggs import hll_hash_bytes
                terms = self.reader.column_dict(spec.field)
                return np.array([hll_hash_bytes(t.encode()) for t in terms]
                                or [0], dtype=np.uint64)

            hash_slot = self.b.add_array(
                f"col.{spec.field}.ord_hash", term_hashes)
            return MetricSlots(spec.name, "cardinality", ord_slot, -1,
                               hash_slot=hash_slot)
        values_slot, present_slot = self._column_slots(spec.field)
        return MetricSlots(spec.name, "cardinality", values_slot,
                           present_slot)

    def lower_agg(self, spec: AggSpec) -> Any:
        if isinstance(spec, MetricAgg):
            return MetricAggExec(spec.name, self.lower_metric(spec))
        if isinstance(spec, CompositeAgg):
            return self._lower_composite_agg(spec)
        return self._lower_bucket_tree(spec, spec.name, parent_space=1)

    def _lower_bucket_tree(self, spec: AggSpec, path: str,
                           parent_space: int) -> "BucketAggExec":
        """Lower one bucket agg and its children recursively. Children
        resolve batch overrides under path-qualified keys ("a>b>c"): ES
        names are only unique per level. `parent_space` is the flattened
        bucket count above this node — the chain product is capped."""
        exec_ = self._lower_bucket_agg(spec, override_key=path)
        space = parent_space * max(exec_.num_buckets, 1)
        if space > MAX_BUCKETS and parent_space > 1:
            # the cap guards the flattened PRODUCT space; a single level's
            # own bucket count is governed by its own kind's limits
            # (histogram caps at lowering; terms ordinal spaces uncapped)
            raise PlanError(
                f"nested aggregation {path!r} would create {space} "
                f"buckets (max {MAX_BUCKETS})")
        children = []
        for sub_spec in getattr(spec, "sub_buckets", ()):
            child = self._lower_bucket_tree(
                sub_spec, f"{path}>{sub_spec.name}", space)
            if exec_.kind == "terms_mv" or child.kind == "terms_mv":
                raise PlanError(
                    "multivalued terms aggs cannot nest (pair arrays and "
                    "doc-space buckets have different shapes)")
            children.append(child)
        if children:
            from dataclasses import replace as dc_replace
            exec_ = dc_replace(exec_, subs=tuple(children))
        return exec_

    def _lower_bucket_agg(self, spec: AggSpec,  # qwlint: disable=QW001 - int() of agg-spec JSON sizes/intervals and numpy column stats while sizing static bucket counts
                          override_key: Optional[str] = None) -> "BucketAggExec":
        override_key = override_key or spec.name
        if isinstance(spec, DateHistogramAgg):
            fm = self._field(spec.field)
            if fm.type is not FieldType.DATETIME or not fm.fast:
                raise PlanError("date_histogram requires a fast datetime field")
            meta = self.reader.field_meta(spec.field)
            vmin, vmax = meta.get("min_value"), meta.get("max_value")
            interval = spec.interval_micros
            # resolve the bucket space (batch-global origin wins)
            if self.batch is not None and override_key in self.batch.get("histograms", {}):
                origin, num_buckets = self.batch["histograms"][override_key]
            elif vmin is None:
                origin, num_buckets = 0, 1
            else:
                lo, hi = vmin, vmax
                if spec.extended_bounds:
                    lo = min(lo, spec.extended_bounds[0])
                    hi = max(hi, spec.extended_bounds[1])
                # ES `offset` shifts every bucket boundary: buckets start at
                # k*interval + offset
                offset = getattr(spec, "offset_micros", 0)
                origin = aligned_origin(lo, interval, offset)
                num_buckets = int((hi - origin) // interval) + 1
                if num_buckets > MAX_BUCKETS:
                    raise PlanError(
                        f"date_histogram would create {num_buckets} buckets "
                        f"(max {MAX_BUCKETS})")
            # i32 seconds fast path: i64 division is emulated on TPU; for
            # whole-second intervals the bucket index computes on a derived
            # (ts_micros//1e6 - base_s) i32 column (base cancels per split)
            base_s = (vmin // 1_000_000) if vmin is not None else 0
            # guard the full i32 range: value offsets span (vmax-vmin)/1e6 and
            # the in-kernel (value - origin) subtraction adds |origin offset|;
            # batches must stay on the i64 path (per-split vmin would lower
            # splits to different structures and break batch uniformity)
            use_s32 = (interval % 1_000_000 == 0
                       and origin % 1_000_000 == 0
                       and self.batch is None
                       and vmin is not None
                       and (vmax // 1_000_000 - base_s)
                       + abs(origin // 1_000_000 - base_s) < 2**31)
            if use_s32:
                values_slot, present_slot = self._s32_column_slots(
                    spec.field, base_s)
                origin_slot = self.b.add_scalar(
                    origin // 1_000_000 - base_s, np.int32)
                interval_slot = self.b.add_scalar(interval // 1_000_000, np.int32)
            else:
                values_slot, present_slot = self._column_slots(spec.field)
                origin_slot = self.b.add_scalar(origin, np.int64)
                interval_slot = self.b.add_scalar(interval, np.int64)
            return BucketAggExec(
                spec.name, "date_histogram", values_slot, present_slot,
                num_buckets, origin_slot, interval_slot,
                metrics=self._metric_tuple(spec.sub_metrics),
                host_info={"interval": interval, "origin": origin,
                           "min_doc_count": spec.min_doc_count,
                           "extended_bounds": spec.extended_bounds,
                           "offset": getattr(spec, "offset_micros", 0)})
        if isinstance(spec, HistogramAgg):
            fm = self._field(spec.field)
            values_slot, present_slot = self._column_slots(spec.field)
            if self.batch is not None and override_key in self.batch.get("histograms", {}):
                origin, num_buckets = self.batch["histograms"][override_key]
                return BucketAggExec(
                    spec.name, "histogram", values_slot, present_slot, num_buckets,
                    self.b.add_scalar(origin, np.float64),
                    self.b.add_scalar(spec.interval, np.float64),
                    metrics=self._metric_tuple(spec.sub_metrics),
                    host_info={"interval": spec.interval, "origin": origin,
                               "min_doc_count": spec.min_doc_count})
            meta = self.reader.field_meta(spec.field)
            vmin, vmax = meta.get("min_value"), meta.get("max_value")
            if vmin is None:
                vmin = vmax = 0
            origin = aligned_origin(vmin, spec.interval)
            num_buckets = int((vmax - origin) // spec.interval) + 1
            if num_buckets > MAX_BUCKETS:
                raise PlanError(f"histogram would create {num_buckets} buckets")
            return BucketAggExec(
                spec.name, "histogram", values_slot, present_slot, num_buckets,
                self.b.add_scalar(origin, np.float64),
                self.b.add_scalar(spec.interval, np.float64),
                metrics=self._metric_tuple(spec.sub_metrics),
                host_info={"interval": spec.interval, "origin": origin,
                           "min_doc_count": spec.min_doc_count})
        if isinstance(spec, TermsAgg):
            return self._lower_terms_agg(spec)
        if isinstance(spec, RangeAgg):
            fm = self._field(spec.field)
            if fm.type is FieldType.TEXT or not fm.fast:
                raise PlanError(
                    f"range aggregation requires a fast numeric field: "
                    f"{spec.field!r}")
            values_slot, present_slot = self._column_slots(spec.field)
            froms = np.array([lo if lo is not None else -np.inf
                              for _, lo, _ in spec.ranges], dtype=np.float64)
            tos = np.array([hi if hi is not None else np.inf
                            for _, _, hi in spec.ranges], dtype=np.float64)
            # the bounds belong to the request, not the split: their bytes
            # are part of the staging key, or a later request with a range
            # agg of the same name would reuse these staged bounds (the
            # JAX package keys them by name alone)
            bounds = (froms.tobytes() + tos.tobytes()).hex()
            froms_slot = self.b.add_array(
                f"agg.{spec.name}.range_froms.{bounds}", lambda: froms)
            tos_slot = self.b.add_array(
                f"agg.{spec.name}.range_tos.{bounds}", lambda: tos)
            return BucketAggExec(
                spec.name, "range", values_slot, present_slot,
                len(spec.ranges),
                froms_slot=froms_slot, tos_slot=tos_slot,
                metrics=self._metric_tuple(spec.sub_metrics),
                host_info={"ranges": list(spec.ranges),
                           "min_doc_count": 0})
        raise PlanError(f"unsupported aggregation {spec!r}")

    def _metric_tuple(self, specs: tuple[MetricAgg, ...]) -> tuple[MetricSlots, ...]:
        return tuple(self.lower_metric(m) for m in specs)

    def _terms_host_info(self, spec: TermsAgg, keys) -> dict:
        """The one terms finalization-parameter dict (four call sites)."""
        return {"keys": keys, "size": spec.size,
                "min_doc_count": spec.min_doc_count,
                "order_desc": spec.order_by_count_desc,
                "order_target": spec.order_target,
                "split_size": spec.split_size}

    def _lower_terms_agg(self, spec: TermsAgg) -> Any:
        fm = self._field(spec.field)
        if not fm.fast:
            raise PlanError(f"terms aggregation requires fast field: {spec.field!r}")
        meta = self.reader.field_meta(spec.field)
        if meta.get("multivalued") and self.batch is not None:
            # multivalued pair arrays have split-dependent shapes: the
            # batch path cannot host them — fall back per split
            raise PlanError(
                f"multivalued terms agg {spec.field!r} is per-split")
        if self.batch is not None and spec.field in self.batch.get("terms_dicts", {}):
            # remap this split's local ordinals into the batch-global dictionary
            global_of = self.batch["terms_dicts"][spec.field]
            cardinality = self.batch["terms_cards"][spec.field]
            global_keys = self.batch["terms_keys"][spec.field]

            def fetch_remapped():
                if meta.get("column_kind") == "ordinal":
                    local = self.reader.column_ordinals(spec.field)
                    local_keys = self.reader.column_dict(spec.field)
                else:
                    local, local_keys = self._ordinalize_numeric(spec.field)
                lut = np.array([global_of[k] for k in local_keys], dtype=np.int32)
                out = np.full_like(local, -1)
                valid = local >= 0
                out[valid] = lut[local[valid]]
                return out

            # the remapped column depends on the batch's whole dictionary:
            # its key carries the dictionary's digest, so a resident copy
            # staged for one split set never serves another
            digests = self.batch.setdefault("terms_digests", {})
            digest = digests.get(spec.field)
            if digest is None:
                digest = digests[spec.field] = hashlib.blake2b(
                    repr(global_keys).encode(), digest_size=8).hexdigest()
            return BucketAggExec(
                spec.name, "terms",
                self.b.add_array(f"col.{spec.field}.ordinals_global.{digest}",
                                 fetch_remapped),
                -1, max(cardinality, 1),
                metrics=self._metric_tuple(spec.sub_metrics),
                host_info=self._terms_host_info(spec, global_keys))
        if meta.get("column_kind") == "ordinal" and meta.get("multivalued"):
            if self.batch is not None:
                raise PlanError(
                    f"multivalued terms agg {spec.field!r} is per-split "
                    "(batch path falls back)")
            if spec.sub_metrics or spec.sub_buckets:
                raise PlanError(
                    f"sub-aggregations under multivalued terms "
                    f"{spec.field!r} are not supported yet")
            keys = self.reader.column_dict(spec.field)
            ords_slot = self.b.add_array(
                f"col.{spec.field}.mv_ords",
                lambda: self.reader.array(f"col.{spec.field}.mv_ords"))
            docs_slot = self.b.add_array(
                f"col.{spec.field}.mv_docs",
                lambda: self.reader.array(f"col.{spec.field}.mv_docs"))
            return BucketAggExec(
                spec.name, "terms_mv", ords_slot, docs_slot,
                max(len(keys), 1),
                host_info=self._terms_host_info(spec, keys))
        if meta.get("column_kind") == "ordinal":
            ordinals_slot = self.b.add_array(
                f"col.{spec.field}.ordinals", lambda: self.reader.column_ordinals(spec.field))
            keys = self.reader.column_dict(spec.field)
            return BucketAggExec(
                spec.name, "terms", ordinals_slot, -1, max(len(keys), 1),
                metrics=self._metric_tuple(spec.sub_metrics),
                host_info=self._terms_host_info(spec, keys))
        # numeric column: ordinalize host-side once per split (cached)
        ordinals, uniques = self._ordinalize_numeric(spec.field)
        return BucketAggExec(
            spec.name, "terms",
            self.b.add_array(f"col.{spec.field}.ordinals_dyn", lambda: ordinals),
            -1, max(len(uniques), 1),
            metrics=self._metric_tuple(spec.sub_metrics),
            host_info=self._terms_host_info(spec, uniques))

    def _lower_composite_agg(self, spec: CompositeAgg) -> CompositeAggExec:
        if self.batch is not None:
            # split-local ordinals/origins in the key encoding: the batch
            # (vmapped multi-split) path falls back per split like
            # multivalued terms
            raise PlanError(f"composite agg {spec.name!r} is per-split")
        execs = []
        infos = []
        for si, src in enumerate(spec.sources):
            after_val = spec.after[si] if spec.after is not None else None
            execs.append(self._lower_composite_source(
                spec.name, src, spec.after is not None, after_val, infos))
        children = []
        for sub_spec in getattr(spec, "sub_buckets", ()):
            child = self._lower_bucket_tree(
                sub_spec, f"{spec.name}>{sub_spec.name}",
                parent_space=spec.size)
            if child.kind == "terms_mv":
                raise PlanError(
                    "multivalued terms aggs cannot nest under composite "
                    "(pair arrays and doc-space buckets have different "
                    "shapes)")
            children.append(child)
        return CompositeAggExec(
            name=spec.name, sources=tuple(execs), size=spec.size,
            has_after=spec.after is not None,
            metrics=self._metric_tuple(spec.sub_metrics),
            subs=tuple(children),
            host_info={"sources": infos, "size": spec.size,
                       "metric_kinds": {m.name: m.kind
                                        for m in spec.sub_metrics}})

    def _lower_composite_source(self, agg_name: str, src: CompositeSource,  # qwlint: disable=QW001 - int()/float()/.item() decode split-local key metadata from host numpy column stats into the source spec
                                has_after: bool, after_val,
                                infos: list) -> CompositeSourceExec:
        fm = self._field(src.field)
        if not fm.fast:
            raise PlanError(
                f"composite {agg_name!r}: source field {src.field!r} must "
                "be a fast field")
        meta = self.reader.field_meta(src.field)
        if meta.get("multivalued"):
            raise PlanError(
                f"composite {agg_name!r}: multivalued source field "
                f"{src.field!r} is not supported")

        def after_slot_for(encoded) -> int:
            if not has_after:
                return -1
            clamped = int(np.clip(encoded, -(2**31) + 1, 2**31 - 2))
            return self.b.add_scalar(clamped, np.int32)

        if src.kind == "terms":
            if meta.get("column_kind") == "ordinal":
                values_slot = self.b.add_array(
                    f"col.{src.field}.ordinals",
                    lambda: self.reader.column_ordinals(src.field))
                keys = self.reader.column_dict(src.field)
            else:
                ordinals, uniques = self._ordinalize_numeric(src.field)
                values_slot = self.b.add_array(
                    f"col.{src.field}.ordinals_dyn", lambda: ordinals)
                keys = uniques
            enc = 0
            if after_val is not None:
                import bisect
                keys_list = list(keys)
                if keys_list and not isinstance(after_val,
                                                type(keys_list[0])):
                    # the dictionary's type is authoritative: coerce the
                    # marker (a term field holding literal "i64:42" was
                    # prefix-decoded to int) rather than letting bisect
                    # raise a TypeError mid-split
                    try:
                        after_val = type(keys_list[0])(after_val)
                    except (TypeError, ValueError):
                        raise PlanError(
                            f"composite after value for source "
                            f"{src.name!r} does not match the field type")
                pos = bisect.bisect_left(keys_list, after_val)
                if pos < len(keys_list) and keys_list[pos] == after_val:
                    enc = (pos + 1) * 2       # exact: strictly past it
                else:
                    enc = pos * 2 + 1         # between split-local keys
                enc = max(enc, 1)             # non-null after excludes null
            infos.append({"name": src.name, "kind": "terms",
                          "keys": [k.item() if isinstance(k, np.generic)
                                   else k for k in keys]})
            return CompositeSourceExec(
                "terms_ord", values_slot,
                missing_bucket=src.missing_bucket,
                after_slot=after_slot_for(enc))
        if src.kind == "date_histogram":
            if fm.type is not FieldType.DATETIME:
                raise PlanError(
                    f"composite {agg_name!r}: date_histogram source "
                    f"requires a datetime field, got {src.field!r}")
            interval = src.interval_micros
            vmin = meta.get("min_value")
            vmax = meta.get("max_value")
            origin = 0 if vmin is None else aligned_origin(vmin, interval)
            # the key encoding (idx+1)*2 must fit i32, a looser bound than
            # MAX_BUCKETS (composite never materializes a bucket array)
            if vmax is not None and (vmax - origin) // interval > 2**29:
                raise PlanError(
                    f"composite {agg_name!r}: date_histogram interval too "
                    "fine for the split's time range")
            enc = 0
            if after_val is not None:
                micros = int(float(after_val) * 1000)  # ES after is ms
                enc = max(int((micros - origin) // interval + 1) * 2, 1)
            infos.append({"name": src.name, "kind": "date_histogram",
                          "origin": int(origin), "interval": int(interval)})
            # whole-second intervals ride the same derived-i32 seconds
            # column as the plain date_histogram lowering (i64 division is
            # emulated on TPU); origin is interval-aligned so origin%1s==0
            base_s = (vmin // 1_000_000) if vmin is not None else 0
            use_s32 = (interval % 1_000_000 == 0
                       and vmin is not None
                       and (vmax // 1_000_000 - base_s)
                       + abs(origin // 1_000_000 - base_s) < 2**31)
            if use_s32:
                values_slot, present_slot = self._s32_column_slots(
                    src.field, base_s)
                origin_slot = self.b.add_scalar(
                    origin // 1_000_000 - base_s, np.int32)
                interval_slot = self.b.add_scalar(
                    interval // 1_000_000, np.int32)
            else:
                values_slot, present_slot = self._column_slots(src.field)
                origin_slot = self.b.add_scalar(origin, np.int64)
                interval_slot = self.b.add_scalar(interval, np.int64)
            return CompositeSourceExec(
                "date_histogram", values_slot, present_slot,
                origin_slot=origin_slot, interval_slot=interval_slot,
                missing_bucket=src.missing_bucket,
                after_slot=after_slot_for(enc))
        # histogram
        if fm.type is FieldType.TEXT:
            raise PlanError(
                f"composite {agg_name!r}: histogram source requires a "
                f"numeric field, got {src.field!r}")
        interval_f = src.interval
        vmin = meta.get("min_value")
        vmax = meta.get("max_value")
        origin_f = 0.0 if vmin is None else aligned_origin(vmin, interval_f)
        # i32 key-encoding bound, looser than MAX_BUCKETS (see above)
        if vmax is not None and (vmax - origin_f) / interval_f > 2**29:
            raise PlanError(
                f"composite {agg_name!r}: histogram interval too fine for "
                "the split's value range")
        values_slot, present_slot = self._column_slots(src.field)
        enc = 0
        if after_val is not None:
            idx = int(np.floor((float(after_val) - origin_f) / interval_f))
            enc = max((idx + 1) * 2, 1)
        infos.append({"name": src.name, "kind": "histogram",
                      "origin": origin_f, "interval": interval_f})
        return CompositeSourceExec(
            "histogram", values_slot, present_slot,
            origin_slot=self.b.add_scalar(origin_f, np.float64),
            interval_slot=self.b.add_scalar(interval_f, np.float64),
            missing_bucket=src.missing_bucket,
            after_slot=after_slot_for(enc))

    def _ordinalize_numeric(self, field: str):
        return ordinalize_numeric_column(self.reader, field)

    def _s32_column_slots(self, field: str, base_s: int) -> tuple[int, int]:
        """(values_slot, present_slot) of the derived i32-seconds column —
        the ONE place its cache keys and derivation are defined (shared by
        the range fast path and both date_histogram lowerings)."""
        values_slot = self.b.add_array(
            f"col.{field}.values_s32",
            lambda: self._seconds_column(field, base_s))
        # present column only — the i64 values column is not read
        present_slot = self.b.add_array(
            f"col.{field}.present",
            lambda: self.reader.column_values(field)[1])
        return values_slot, present_slot

    def _seconds_column(self, field: str, base_s: int) -> np.ndarray:
        """Derived i32 seconds column, cached per reader."""
        cache_key = f"_s32.{field}.{base_s}"
        cache = getattr(self.reader, "_dyn_cache", None)
        if cache is None:
            cache = self.reader._dyn_cache = {}
        cached = cache.get(cache_key)
        if cached is None:
            values, _present = self.reader.column_values(field)
            cached = (values // 1_000_000 - base_s).astype(np.int32)
            cache[cache_key] = cached
        return cached

    def _is_text_sort(self, field: str) -> bool:
        """True for dict-ordinal (raw text fast) columns: sortable on device
        by local ordinal — the dictionary is lex-sorted, so per-split
        ordinal order == string order. Cross-split comparison happens on
        the DECODED term strings in the collector (the reference likewise
        returns term bytes as leaf sort values for string sorts)."""
        fm = self._field(field)
        if fm.type is not FieldType.TEXT:
            return False
        if not fm.fast:
            raise PlanError(f"sorting by text field {field!r} requires "
                            f"fast: true")
        return True

    def _ordinal_sort_slots(self, field: str) -> tuple[int, int]:
        def fetch_ordinals():
            return self.reader.column_ordinals(field)
        values_slot = self.b.add_array(f"col.{field}.ordinals", fetch_ordinals)
        # presence is derivable on-device (ordinal >= 0): the sentinel slot
        # avoids shipping + keeping a whole bool column in HBM
        return values_slot, PRESENT_FROM_VALUES

    # --- sort -------------------------------------------------------------
    def lower_sort(self, sort_field: str, order: str,
                   sort2_field: Optional[str] = None,
                   sort2_order: str = "desc") -> SortExec:
        descending = order == "desc"
        if sort_field == "_score":
            primary = SortExec("score", descending)
        elif sort_field == "_doc":
            primary = SortExec("doc", descending)
        elif self._is_text_sort(sort_field):
            if sort2_field is not None and sort2_field != "_doc":
                raise PlanError(
                    f"text-field sort {sort_field!r} cannot be combined "
                    f"with a secondary sort key")
            values_slot, present_slot = self._ordinal_sort_slots(sort_field)
            return SortExec("column", descending, values_slot, present_slot)
        else:
            values_slot, present_slot = self._column_slots(sort_field)
            primary = SortExec("column", descending, values_slot, present_slot)
        if sort2_field is None or sort2_field == "_doc" or primary.by == "doc":
            # doc order is the implicit final tie-break already
            return primary
        from dataclasses import replace as dc_replace
        if sort2_field == "_score":
            return dc_replace(primary, by2="score",
                              descending2=sort2_order == "desc")
        if self._is_text_sort(sort2_field):
            raise PlanError(
                f"text field {sort2_field!r} is not supported as a "
                f"secondary sort key")
        v2, p2 = self._column_slots(sort2_field)
        return dc_replace(primary, by2="column",
                          descending2=sort2_order == "desc",
                          values2_slot=v2, present2_slot=p2)


def ordinalize_numeric_column(reader: SplitReader, field: str):  # qwlint: disable=QW001 - .item() over host numpy uniques building the ordinal dictionary; reader columns are numpy, never device arrays
    """(ordinals, unique_values) of a numeric fast column, cached per reader
    (terms aggregations over numeric fields need a dictionary)."""
    cache_key = f"_ordinalized.{field}"
    cached = getattr(reader, "_dyn_cache", {}).get(cache_key)
    if cached is not None:
        return cached
    values, present = reader.column_values(field)
    real = values[: reader.num_docs][present[: reader.num_docs].astype(bool)]
    uniques = np.unique(real)
    ordinals = np.full(reader.num_docs_padded, -1, dtype=np.int32)
    mask = present.astype(bool)
    ordinals[mask] = np.searchsorted(uniques, values[mask]).astype(np.int32)
    result = (ordinals, [v.item() for v in uniques])
    if not hasattr(reader, "_dyn_cache"):
        reader._dyn_cache = {}
    reader._dyn_cache[cache_key] = result
    return result


def _wildcard_prefix(pattern: str) -> str:
    for i, ch in enumerate(pattern):
        if ch in "*?[":
            return pattern[:i]
    return pattern


def _regex_prefix(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch in ".*+?()[]{}|^$\\":
            break
        out.append(ch)
    return "".join(out)


def lower_request(
    query_ast: Q.QueryAst,
    doc_mapper: DocMapper,
    reader: SplitReader,
    agg_specs: list[AggSpec],
    sort_field: str = "_score",
    sort_order: str = "desc",
    sort2_field: Optional[str] = None,
    sort2_order: str = "desc",
    start_timestamp: Optional[int] = None,
    end_timestamp: Optional[int] = None,
    batch_overrides: Optional[dict] = None,
    search_after: Optional[tuple] = None,  # (internal_value, relation, doc_id)
    absence_sink=None,
    sort_value_threshold: Optional[float] = None,  # internal higher-is-better
    mask_override: Optional[np.ndarray] = None,  # packed predicate mask
    mask_key: Optional[str] = None,              # its array-cache key
) -> LoweredPlan:
    """Full request lowering: query + request-level time filter + sort + aggs.

    `mask_override` (Tier A, search/mask_cache.py): a cached packed filter
    bitmask standing in for the whole predicate — query lowering AND the
    time-filter wrap are skipped (the digest already covers both), so no
    predicate column is fetched or staged. Sort and agg columns lower as
    usual. `mask_key` keys the mask's array slot so warm splits reuse its
    device copy through `ResidentColumnStore` like any column."""
    low = Lowering(doc_mapper, reader, batch_overrides, absence_sink)
    scoring = "_score" in (sort_field, sort2_field)
    if mask_override is not None:
        if scoring:
            raise PlanError("mask_override cannot serve scoring requests")
        root = PMaskRef(packed_slot=low.b.add_array(
            mask_key or "mask.override", lambda: mask_override))
        return _finish_lowering(low, root, reader, agg_specs, sort_field,
                                sort_order, sort2_field, sort2_order,
                                search_after, sort_value_threshold)
    if (sort_value_threshold is not None and batch_overrides is None
            and not agg_specs and search_after is None
            and start_timestamp is None and end_timestamp is None
            and sort_field == "_score" and sort_order == "desc"
            and sort2_field is None):
        # impact prefix cutoff: sound only when the request is EXACTLY one
        # scoring term — a bare Term/FullText (possibly boosted), never a
        # Bool, so no filter/should sibling can rescue a dropped posting
        # and the term's df is the exact matched-doc count
        node = query_ast
        while isinstance(node, Q.Boost):
            node = node.underlying
        if isinstance(node, (Q.Term, Q.FullText)):
            from .pruning import scoring_terms
            terms = scoring_terms(query_ast, doc_mapper)
            if terms is not None and len(terms) == 1:
                low._impact_term = terms[0]
                low._impact_threshold = sort_value_threshold
    root = low.lower(query_ast, scoring=scoring)
    if start_timestamp is not None or end_timestamp is not None:
        ts_field = doc_mapper.timestamp_field
        if ts_field is None:
            raise PlanError("time-range request on an index without timestamp field")
        # end_timestamp is exclusive (reference: SearchRequest semantics)
        ts_node = low._lower_range(Q.Range(
            ts_field,
            lower=Q.RangeBound(start_timestamp, True) if start_timestamp is not None else None,
            upper=Q.RangeBound(end_timestamp, False) if end_timestamp is not None else None,
        ), bounds_are_micros=True)
        root = PBool(must=(root,), filter=(ts_node,))
    return _finish_lowering(low, root, reader, agg_specs, sort_field,
                            sort_order, sort2_field, sort2_order,
                            search_after, sort_value_threshold)


def _finish_lowering(  # qwlint: disable=QW001 - float()/int() of search_after/threshold wire values (python scalars off the root merge) staged as plan scalars
    low: "Lowering",
    root: Any,
    reader: SplitReader,
    agg_specs: list[AggSpec],
    sort_field: str,
    sort_order: str,
    sort2_field: Optional[str],
    sort2_order: str,
    search_after: Optional[tuple],
    sort_value_threshold: Optional[float],
) -> LoweredPlan:
    """Sort/agg/search-after/threshold lowering shared by the query path
    and the mask-override path of `lower_request`."""
    sort = low.lower_sort(sort_field, sort_order, sort2_field, sort2_order)
    sort_text_field = sort_field if (
        sort_field not in ("_score", "_doc")
        and low._is_text_sort(sort_field)) else None
    aggs = [low.lower_agg(spec) for spec in agg_specs]
    sa_relation, sa_value_slot, sa_value2_slot, sa_doc_slot = "none", -1, -1, -1
    if search_after is not None:
        sa_value, sa_value2, sa_relation, sa_doc = search_after
        sa_value_slot = low.b.add_scalar(float(sa_value), np.float64)
        if sa_value2 is not None:
            sa_value2_slot = low.b.add_scalar(float(sa_value2), np.float64)
        sa_doc_slot = low.b.add_scalar(int(sa_doc), np.int32)
    threshold_slot = -1
    if (sort_value_threshold is not None and sort_field != "_doc"
            and sort_text_field is None):
        # text sorts compare split-local ordinals — a cross-split threshold
        # is meaningless there, so the pushdown silently disarms
        threshold_slot = low.b.add_scalar(
            float(sort_value_threshold), np.float64)
    return LoweredPlan(
        root=root, sort=sort, aggs=aggs,
        arrays=low.b.arrays, array_keys=low.b.array_keys, scalars=low.b.scalars,
        num_docs=reader.num_docs, num_docs_padded=reader.num_docs_padded,
        search_after_relation=sa_relation,
        sa_value_slot=sa_value_slot, sa_value2_slot=sa_value2_slot,
        sa_doc_slot=sa_doc_slot,
        sort_text_field=sort_text_field,
        threshold_slot=threshold_slot,
        rebase=low.rebase,
        count_override=low.count_override,
    )


# --------------------------------------------------------------------------
# slot classification (staged-bytes attribution, observability/metrics.py)

def _query_node_slots(node: Any, out: set[int]) -> None:
    if isinstance(node, PPostings):
        for slot in (node.ids_slot, node.tfs_slot, node.norm_slot,
                     node.impact_bmax_slot):
            if slot >= 0:
                out.add(slot)
    elif isinstance(node, PRange):
        for slot in (node.values_slot, node.present_slot,
                     node.zmin_slot, node.zmax_slot):
            if slot >= 0:
                out.add(slot)
    elif isinstance(node, PPresence):
        if node.present_slot >= 0:
            out.add(node.present_slot)
    elif isinstance(node, PNormPresence):
        if node.norm_slot >= 0:
            out.add(node.norm_slot)
    elif isinstance(node, PBool):
        for clause in (*node.must, *node.must_not, *node.should, *node.filter):
            _query_node_slots(clause, out)
    # PMatchAll / PMatchNone / PMaskRef: no predicate columns. A PMaskRef's
    # packed slot is deliberately NOT a predicate column — it's the cached
    # substitute for them, and counting it would make the "zero predicate
    # staging on a warm hit" invariant unassertable.


def _metric_slots(metric: MetricSlots, out: set[int]) -> None:
    for slot in (metric.values_slot, metric.present_slot, metric.hash_slot):
        if slot >= 0:
            out.add(slot)


def _agg_slots(agg: Any, out: set[int]) -> None:
    if isinstance(agg, BucketAggExec):
        for slot in (agg.values_slot, agg.present_slot,
                     agg.froms_slot, agg.tos_slot):
            if slot >= 0:
                out.add(slot)
        for metric in agg.metrics:
            _metric_slots(metric, out)
        for sub in agg.subs:
            _agg_slots(sub, out)
    elif isinstance(agg, MetricAggExec):
        _metric_slots(agg.metric, out)
    elif isinstance(agg, CompositeAggExec):
        for source in agg.sources:
            for slot in (source.values_slot, source.present_slot):
                if slot >= 0:
                    out.add(slot)
        for metric in agg.metrics:
            _metric_slots(metric, out)
        for sub in agg.subs:
            _agg_slots(sub, out)


def predicate_only_slots(plan: LoweredPlan) -> set[int]:
    """Array slots referenced ONLY by the query root — the staging a
    predicate-mask hit avoids. Slots shared with sort or aggs are excluded
    (a mask hit still stages those), as are sort/agg-only slots."""
    root_slots: set[int] = set()
    _query_node_slots(plan.root, root_slots)
    other_slots: set[int] = set()
    for slot in (plan.sort.values_slot, plan.sort.present_slot,
                 plan.sort.values2_slot, plan.sort.present2_slot):
        if slot >= 0:
            other_slots.add(slot)
    for agg in plan.aggs:
        _agg_slots(agg, other_slots)
    return root_slots - other_slots


# --------------------------------------------------------------------------
# chunked-execution slot classification (search/chunkexec.py)

@dataclass(frozen=True)
class ChunkSlotPlan:
    """How each array slot of a plan partitions along the doc dimension.

    `chunkexec` slices a dense plan into doc-span sub-plans; every slot
    must fall into exactly one class or the plan is chunk-ineligible:

    - `posting_pairs`: (ids_slot, tfs_slot) posting lists — doc ids are
      filtered to the chunk's doc window and rebased host-side (out-of-
      window lanes get the chunk's OOB scatter sentinel).
    - `doc_slots`: per-padded-doc columns (values, presence, fieldnorms,
      ordinals) — sliced `[base : base + span]`.
    - `zone_slots`: per-ZONEMAP_BLOCK zonemaps — sliced by block index.
    - `packed_slots`: np.packbits doc bitmasks — sliced by byte index.
    - `full_slots`: bounded non-doc tables (range-agg bounds, per-ordinal
      hash tables, impact block maxima) — passed through whole.
    """
    posting_pairs: tuple[tuple[int, int], ...]
    doc_slots: frozenset
    zone_slots: frozenset
    packed_slots: frozenset
    full_slots: frozenset


def chunk_slot_plan(plan: LoweredPlan) -> Optional[ChunkSlotPlan]:
    """Classify every array slot for doc-dimension chunking, or return None
    when the plan is chunk-ineligible (composite aggs sort the whole doc
    space at once; multivalued pair arrays gather by global doc id; any
    slot the walkers cannot attribute is conservatively disqualifying)."""
    from ..index.format import ZONEMAP_BLOCK
    pairs: list[tuple[int, int]] = []
    doc: set[int] = set()
    zone: set[int] = set()
    packed: set[int] = set()
    full: set[int] = set()

    def walk_node(node: Any) -> bool:
        if isinstance(node, PPostings):
            pairs.append((node.ids_slot, node.tfs_slot))
            if node.norm_slot >= 0:
                doc.add(node.norm_slot)
            if node.impact_bmax_slot >= 0:
                full.add(node.impact_bmax_slot)
            return True
        if isinstance(node, PRange):
            doc.add(node.values_slot)
            if node.present_slot >= 0:
                doc.add(node.present_slot)
            for slot in (node.zmin_slot, node.zmax_slot):
                if slot >= 0:
                    zone.add(slot)
            return True
        if isinstance(node, PPresence):
            doc.add(node.present_slot)
            return True
        if isinstance(node, PNormPresence):
            doc.add(node.norm_slot)
            return True
        if isinstance(node, PBool):
            return all(walk_node(c) for c in
                       (*node.must, *node.must_not, *node.should, *node.filter))
        if isinstance(node, PMaskRef):
            packed.add(node.packed_slot)
            return True
        return isinstance(node, (PMatchAll, PMatchNone))

    def walk_metric(metric: MetricSlots) -> bool:
        doc.add(metric.values_slot)
        if metric.present_slot >= 0:
            doc.add(metric.present_slot)
        if metric.hash_slot >= 0:
            full.add(metric.hash_slot)  # per-ordinal table, not per-doc
        return True

    def walk_agg(agg: Any) -> bool:
        if isinstance(agg, BucketAggExec):
            if agg.kind == "terms_mv":
                return False  # pair arrays gather the mask by global doc id
            doc.add(agg.values_slot)
            if agg.present_slot >= 0:
                doc.add(agg.present_slot)
            for slot in (agg.froms_slot, agg.tos_slot):
                if slot >= 0:
                    full.add(slot)  # [num_buckets] bound tables
            return (all(walk_metric(m) for m in agg.metrics)
                    and all(walk_agg(s) for s in agg.subs))
        if isinstance(agg, MetricAggExec):
            return walk_metric(agg.metric)
        return False  # CompositeAggExec: whole-doc-space sort

    if not walk_node(plan.root):
        return None
    for slot in (plan.sort.values_slot, plan.sort.present_slot,
                 plan.sort.values2_slot, plan.sort.present2_slot):
        if slot >= 0:
            doc.add(slot)
    for agg in plan.aggs:
        if not walk_agg(agg):
            return None

    padded = plan.num_docs_padded
    pair_slots = {s for p in pairs for s in p}
    classified = doc | zone | packed | full | pair_slots
    if classified != set(range(len(plan.arrays))):
        return None  # a slot nobody attributed — refuse to slice blind
    # one class per slot: a slot consumed under two different partitioning
    # rules cannot be sliced consistently
    buckets = [doc, zone, packed, full, pair_slots]
    for i, a in enumerate(buckets):
        for b in buckets[i + 1:]:
            if a & b:
                return None
    for slot in doc:
        a = plan.arrays[slot]
        if a.ndim != 1 or a.shape[0] != padded:
            return None
    for slot in zone:
        a = plan.arrays[slot]
        if a.ndim != 1 or a.shape[0] * ZONEMAP_BLOCK != padded:
            return None
    for slot in packed:
        a = plan.arrays[slot]
        if a.ndim != 1 or a.shape[0] != padded // 8:
            return None
    for ids_slot, tfs_slot in pairs:
        if plan.arrays[ids_slot].shape != plan.arrays[tfs_slot].shape:
            return None
    return ChunkSlotPlan(
        posting_pairs=tuple(pairs), doc_slots=frozenset(doc),
        zone_slots=frozenset(zone), packed_slots=frozenset(packed),
        full_slots=frozenset(full))
