"""Split writer: typed docs → one immutable split file.

Role of the reference's indexer hot loop (`quickwit-indexing/src/actors/
indexer.rs` driving tantivy's `IndexWriter` + `Packager`'s hotcache build),
re-targeted at the device array layout of `format.py`:

- postings per term are **dense padded int32 arrays** (ids + term freqs),
  padded to POSTING_PAD lanes with `id = num_docs_padded` (an out-of-bounds
  sentinel whose scatter contributions are dropped on device) and `tf = 0`
  (zero BM25 contribution),
- fast fields are dense padded columns with presence masks (numeric) or
  dictionary ordinals (raw text), numeric ones frame-of-reference packed
  into u8/u16/u32 lanes where the span allows (`_pack_numeric`),
  multivalued raw text ones with (doc, ordinal) pair arrays,
- the doc store is zlib block-compressed JSON rows with a block index,
- per-field stats (df, avg field length, min/max) land in the footer so BM25
  and range pruning need no extra reads.

Counterpart of the JAX package's `index/writer.py`, host numpy only. Every
inverted field goes through the Python postings builder: the JAX package's
native builder (host C++ under `quickwit_tpu/native`) is not carried over.
For the same docs and mapper the bytes equal the JAX package's Python-path
bytes (its native path writes the same arrays and adds a `"native"` marker
to the field's footer meta).
"""

from __future__ import annotations

import json
import os
import zlib
from collections import defaultdict
from typing import Any, Optional

import numpy as np

from ..models.doc_mapper import (
    DocMapper, FieldMapping, FieldType, TypedDoc, canonical_term,
    dynamic_canonical)
from ..utils.datetime_utils import truncate_to_precision
from .format import (
    DOC_PAD, POSTING_PAD, ZONEMAP_BLOCK, SplitFileBuilder, SplitFooter,
    pad_to)
from .impact import IMPACT_BLOCK, IMPACT_BUCKETS, build_impact_arrays

_STORE_BLOCK_BYTES = 64 * 1024
_NUMERIC_TYPES = (FieldType.I64, FieldType.U64, FieldType.F64, FieldType.BOOL,
                  FieldType.DATETIME, FieldType.IP)

# current analyzer generation (v2 = Porter2 en_stem); stamped into split
# footers so stale-analysis splits are detectable at plan time
ANALYZER_VERSION = 2


class _InvertedFieldBuilder:
    """Postings accumulator of one inverted field."""

    def __init__(self, fm: FieldMapping):
        self.fm = fm
        self.with_positions = fm.record == "position" and fm.type is FieldType.TEXT
        # term -> ([doc_ids], [tfs], [positions])
        self.terms: dict[str, list] = {}
        self.fieldnorms: dict[int, int] = {}   # token count (BM25 doc length)
        self._pos_base: dict[int, int] = {}    # next position base, with gaps
        self.total_tokens = 0

    def add(self, doc_id: int, tokens: list) -> None:
        pos_base = self._pos_base.get(doc_id, 0)
        by_term: dict[str, list[int]] = defaultdict(list)
        for tok in tokens:
            by_term[tok.text].append(pos_base + tok.position)
        for term, positions in by_term.items():
            entry = self.terms.get(term)
            if entry is None:
                entry = self.terms[term] = ([], [], [])
            ids, tfs, poss = entry
            if ids and ids[-1] == doc_id:
                tfs[-1] += len(positions)
                poss[-1].extend(positions)
            else:
                ids.append(doc_id)
                tfs.append(len(positions))
                poss.append(positions)
        ntokens = len(tokens)
        self.fieldnorms[doc_id] = self.fieldnorms.get(doc_id, 0) + ntokens
        # positions of the next value for this doc start after a +1 gap so
        # phrases cannot match across value boundaries (tantivy semantics)
        self._pos_base[doc_id] = pos_base + ntokens + 1
        self.total_tokens += ntokens


class _DynamicColumnBuilder:
    """Accumulates RAW dynamic leaf values; the split decides the column
    type at finish time (reference: tantivy's dynamic column coercion —
    the columnar side coerces mixed numerics to f64, mixed anything-else
    to strings, which is what makes a `long` observed alongside a
    `double` searchable but not aggregatable)."""

    def __init__(self):
        self.values: dict[int, list[Any]] = {}
        self.classes: set[str] = set()
        self._max_int = 0
        self._min_int = 0

    def add(self, doc_id: int, value: Any) -> None:
        if isinstance(value, bool):
            self.classes.add("boolean")
        elif isinstance(value, int):
            self.classes.add("long")
            self._max_int = max(self._max_int, value)
            self._min_int = min(self._min_int, value)
        elif isinstance(value, float):
            self.classes.add("double")
        else:
            self.classes.add("str")
        self.values.setdefault(doc_id, []).append(value)

    def coerced_type(self) -> FieldType:
        if "str" in self.classes:
            return FieldType.TEXT
        if "double" in self.classes:
            return FieldType.F64
        if "long" in self.classes:
            if self._max_int > (1 << 63) - 1:
                # >i64::MAX alongside a negative value: no integer dtype
                # holds both — coerce to f64 (lossy at the extremes, like
                # the reference's columnar coercion)
                return (FieldType.F64 if self._min_int < 0
                        else FieldType.U64)
            return FieldType.I64
        return FieldType.BOOL

    def to_column(self, tokenizer: str) -> "_ColumnBuilder":
        coerced = self.coerced_type()
        fm = FieldMapping("dynamic", coerced, tokenizer=tokenizer,
                          fast=True, indexed=False)
        col = _ColumnBuilder(fm)
        for doc_id, values in self.values.items():
            for value in values:
                if coerced is FieldType.TEXT:
                    col.add(doc_id, dynamic_canonical(value))
                elif coerced is FieldType.BOOL:
                    col.add(doc_id, 1 if value else 0)
                elif coerced is FieldType.F64:
                    col.add(doc_id, float(value))
                else:
                    col.add(doc_id, int(value))
        return col


class _ColumnBuilder:
    def __init__(self, fm: FieldMapping):
        self.fm = fm
        self.is_numeric = fm.type in _NUMERIC_TYPES
        self.values: dict[int, Any] = {}
        # ordinal (text) columns keep EVERY value: the dense column stores
        # the first (sort substrate), extra values ride in (doc, ordinal)
        # pair arrays for terms aggregations (reference: multivalued fast
        # fields)
        self.multi: dict[int, list] = {}
        # zonemap bounds track EVERY value, not just the first one the
        # dense column keeps — Term/Range matching goes through the
        # inverted index, which indexes all of a doc's values, so
        # first-value-only bounds could prune a split that matches
        self.vmin: Any = None
        self.vmax: Any = None

    def add(self, doc_id: int, value: Any) -> None:
        if not self.is_numeric:
            self.multi.setdefault(doc_id, []).append(value)
        else:
            if self.vmin is None or value < self.vmin:
                self.vmin = value
            if self.vmax is None or value > self.vmax:
                self.vmax = value
        # numeric columns keep the first value (dense single-valued)
        self.values.setdefault(doc_id, value)


class SplitWriter:
    """Accumulates docs, emits the split file bytes + summary stats."""

    def __init__(self, doc_mapper: DocMapper):
        self.doc_mapper = doc_mapper
        self.num_docs = 0
        self._inv: dict[str, Any] = {}
        for fm in doc_mapper.indexed_fields:
            self._inv[fm.name] = _InvertedFieldBuilder(fm)
        self._cols: dict[str, _ColumnBuilder] = {
            fm.name: _ColumnBuilder(fm) for fm in doc_mapper.fast_fields
        }
        self._dyn_cols: dict[str, _DynamicColumnBuilder] = {}
        if doc_mapper.store_document_size:
            # synthetic `_doc_length` fast column (reference
            # store_document_size): serialized byte size per doc
            self._cols["_doc_length"] = _ColumnBuilder(FieldMapping(
                "_doc_length", FieldType.I64, fast=True, indexed=False))
        self._sources: list[bytes] = []
        self._uncompressed_docs_size = 0
        self._time_min: Optional[int] = None
        self._time_max: Optional[int] = None
        self.tags: set[str] = set()
        # filled by finish(): per-field zonemap bounds of the mapped
        # numeric fast columns
        self.column_bounds: dict[str, tuple[Any, Any]] = {}

    def add_json_doc(self, doc: dict[str, Any]) -> int:
        return self.add_typed_doc(self.doc_mapper.doc_from_json(doc))

    def add_typed_doc(self, tdoc: TypedDoc) -> int:
        doc_id = self.num_docs
        self.num_docs += 1
        for field_name, values in tdoc.fields.items():
            fm = self.doc_mapper.field(field_name)
            dynamic = False
            if fm is None:
                if self.doc_mapper.mode != "dynamic":
                    continue
                # dynamic mode: unmapped paths materialize per split with
                # the dynamic_mapping options — raw terms over canonical
                # value strings on the inverted side, a typed column
                # (coerced from the observed value classes) on the fast
                # side (doc_mapper._collect_dynamic_leaves keeps values raw)
                dynamic = True
                fm = self.doc_mapper.dynamic_field(field_name)
                if fm.indexed and field_name not in self._inv:
                    self._inv[field_name] = _InvertedFieldBuilder(fm)
            index_values = ([dynamic_canonical(v) for v in values]
                            if dynamic else values)
            if fm.indexed:
                builder = self._inv[field_name]
                for value in index_values:
                    builder.add(doc_id,
                                self.doc_mapper.tokens_for_field(fm, value))
            if fm.fast:
                if dynamic:
                    dcol = self._dyn_cols.setdefault(
                        field_name, _DynamicColumnBuilder())
                    for value in values:
                        dcol.add(doc_id, value)
                else:
                    col = self._cols[field_name]
                    for value in values:
                        col.add(doc_id, _fast_value(fm, value))
            elif dynamic:
                # no column: still record the observed value classes for
                # the per-split field registry (list_fields / field caps)
                dcol = self._dyn_cols.setdefault(
                    field_name, _DynamicColumnBuilder())
                dcol.classes.update(
                    "boolean" if isinstance(v, bool) else
                    "long" if isinstance(v, int) else
                    "double" if isinstance(v, float) else "str"
                    for v in values)
        ts = tdoc.timestamp_micros(self.doc_mapper.timestamp_field)
        if ts is not None:
            self._time_min = ts if self._time_min is None else min(self._time_min, ts)
            self._time_max = ts if self._time_max is None else max(self._time_max, ts)
        self.tags |= self.doc_mapper.tags(tdoc)
        source = json.dumps(tdoc.source, separators=(",", ":")).encode()
        self._sources.append(source)
        self._uncompressed_docs_size += len(source)
        if "_doc_length" in self._cols:
            # measured over the standard (space-separated) JSON text — the
            # canonical "document as received" size for NDJSON ingestion
            self._cols["_doc_length"].add(
                doc_id, len(json.dumps(tdoc.source)))
        return doc_id

    # ------------------------------------------------------------------
    def finish(self) -> bytes:
        if self.num_docs == 0:
            raise ValueError("cannot finish an empty split")
        num_docs_padded = pad_to(self.num_docs, DOC_PAD)
        builder = SplitFileBuilder()
        fields_meta: dict[str, dict[str, Any]] = {}

        for name, inv in self._inv.items():
            fields_meta[name] = self._write_inverted(builder, name, inv, num_docs_padded)
        for name, col in self._cols.items():
            meta = fields_meta.setdefault(name, {"type": col.fm.type.value})
            meta.update(self._write_column(builder, name, col, num_docs_padded))
        dm_tokenizer = (self.doc_mapper.dynamic_mapping.tokenizer
                        if self.doc_mapper.dynamic_mapping else "raw")
        for name, dcol in self._dyn_cols.items():
            meta = fields_meta.setdefault(name, {})
            meta["dynamic"] = True
            meta["value_classes"] = sorted(dcol.classes)
            if dcol.values:
                col = dcol.to_column(dm_tokenizer)
                meta.setdefault("type", col.fm.type.value)
                meta["col_type"] = col.fm.type.value
                meta.update(self._write_column(builder, name, col, num_docs_padded))
        self._write_docstore(builder)

        # split-granular zonemap: bounds over EVERY value of each
        # explicitly-mapped numeric field (i64/u64/f64 — the only fields
        # the root's constraint extraction consults; dynamic columns and
        # synthetic fields would be metastore dead weight)
        self.column_bounds = {
            name: (col.vmin, col.vmax)
            for name, col in self._cols.items()
            if col.vmin is not None
            and col.fm.type in (FieldType.I64, FieldType.U64,
                                FieldType.F64)
            # synthetic columns (_doc_length) are not mapped fields: the
            # root never consults them, so publishing their bounds would
            # be per-split metastore dead weight
            and self.doc_mapper.field(name) is not None}

        footer = SplitFooter(
            num_docs=self.num_docs,
            num_docs_padded=num_docs_padded,
            arrays={},
            fields=fields_meta,
            time_range=(self._time_min, self._time_max) if self._time_min is not None else None,
            doc_mapping_uid=self.doc_mapper.doc_mapping_uid,
            extra={"uncompressed_docs_size_bytes": self._uncompressed_docs_size,
                   # bumped whenever a tokenizer's output changes (e.g.
                   # en_stem light-stemmer → Porter2): query-side analysis
                   # must match index-side terms, so a version mismatch at
                   # plan time warns that the split needs reindexing
                   "analyzer_version": ANALYZER_VERSION},
        )
        return builder.finish(footer)

    def _write_inverted(self, builder: SplitFileBuilder, name: str,
                        inv: _InvertedFieldBuilder,
                        num_docs_padded: int) -> dict[str, Any]:
        terms_sorted = sorted(inv.terms)
        num_terms = len(terms_sorted)
        blob_parts: list[bytes] = []
        offsets = np.zeros(num_terms + 1, dtype=np.int64)
        dfs = np.zeros(num_terms, dtype=np.int32)
        post_offs = np.zeros(num_terms, dtype=np.int64)
        post_lens = np.zeros(num_terms, dtype=np.int32)
        max_tfs = np.zeros(num_terms, dtype=np.int32)

        total_padded = sum(pad_to(len(inv.terms[t][0]), POSTING_PAD) for t in terms_sorted)
        ids_arena = np.full(total_padded, num_docs_padded, dtype=np.int32)
        tfs_arena = np.zeros(total_padded, dtype=np.int32)
        pos_offsets = np.zeros(total_padded + 1, dtype=np.int64) if inv.with_positions else None
        pos_chunks: list[list[int]] = []

        cursor = 0
        blob_len = 0
        pos_cursor = 0
        for t_idx, term in enumerate(terms_sorted):
            encoded = term.encode()
            blob_parts.append(encoded)
            blob_len += len(encoded)
            offsets[t_idx + 1] = blob_len
            ids, tfs, poss = inv.terms[term]
            df = len(ids)
            padded = pad_to(df, POSTING_PAD)
            dfs[t_idx] = df
            post_offs[t_idx] = cursor
            post_lens[t_idx] = padded
            ids_arena[cursor:cursor + df] = ids
            tfs_arena[cursor:cursor + df] = tfs
            max_tfs[t_idx] = max(tfs) if df else 0
            if pos_offsets is not None:
                for i, doc_positions in enumerate(poss):
                    pos_offsets[cursor + i] = pos_cursor
                    pos_chunks.append(doc_positions)
                    pos_cursor += len(doc_positions)
                pos_offsets[cursor + df: cursor + padded + 1] = pos_cursor
            cursor += padded

        norms = np.zeros(num_docs_padded, dtype=np.int32)
        for doc_id, length in inv.fieldnorms.items():
            norms[doc_id] = length

        arrays = {
            "terms.blob": np.frombuffer(b"".join(blob_parts), dtype=np.uint8),
            "terms.offsets": offsets,
            "terms.df": dfs,
            "terms.post_off": post_offs,
            "terms.post_len": post_lens,
            "terms.max_tf": max_tfs,
            "postings.ids": ids_arena,
            "postings.tfs": tfs_arena,
        }
        if pos_offsets is not None:
            arrays["positions.offsets"] = pos_offsets
            arrays["positions.data"] = np.array(
                [p for chunk in pos_chunks for p in chunk], dtype=np.int32)
        arrays["fieldnorm"] = norms
        avg_len = (inv.total_tokens / self.num_docs) if self.num_docs else 0.0
        impact_meta = apply_impact_ordering(arrays, avg_len, self.num_docs)
        for suffix, arr in arrays.items():
            builder.add_array(f"inv.{name}.{suffix}", arr)

        meta = {
            "type": inv.fm.type.value,
            "tokenizer": inv.fm.tokenizer,
            "record": inv.fm.record,
            "indexed": True,
            "num_terms": num_terms,
            "total_tokens": inv.total_tokens,
            "avg_len": avg_len,
        }
        if impact_meta is not None:
            meta["impact"] = impact_meta
        return meta

    def _write_column(self, builder: SplitFileBuilder, name: str,
                      col: _ColumnBuilder, num_docs_padded: int) -> dict[str, Any]:
        present = np.zeros(num_docs_padded, dtype=np.uint8)
        doc_ids = np.fromiter(col.values.keys(), dtype=np.int64, count=len(col.values))
        present[doc_ids] = 1
        if col.is_numeric:
            # u64 columns hold values above i64::MAX (the reference
            # dynamically types >2^63 values as u64); everything else is i64
            dtype = (np.float64 if col.fm.type is FieldType.F64
                     else np.uint64 if col.fm.type is FieldType.U64
                     else np.int64)
            values = np.zeros(num_docs_padded, dtype=dtype)
            vals = np.fromiter(col.values.values(), dtype=dtype, count=len(col.values))
            values[doc_ids] = vals
            meta = {
                "fast": True, "column_kind": "numeric",
                "min_value": (vals.min().item() if len(vals) else None),
                "max_value": (vals.max().item() if len(vals) else None),
            }
            packed = _pack_numeric(col.fm.type, vals)
            if packed is not None:
                # frame-of-reference layout: the narrow delta lanes REPLACE
                # the full-width values array on disk and in device memory;
                # the reader reconstructs full-width views host-side on
                # demand
                deltas, for_min, for_scale, bit_width = packed
                lanes = np.zeros(num_docs_padded, dtype=deltas.dtype)
                lanes[doc_ids] = deltas
                builder.add_array(f"col.{name}.packed", lanes)
                meta["packed"] = {"for_min": for_min, "for_scale": for_scale,
                                  "bit_width": bit_width}
                zdomain = lanes.astype(np.int32)
            else:
                builder.add_array(f"col.{name}.values", values)
                zdomain = values
            builder.add_array(f"col.{name}.present", present)
            zmin, zmax = _column_zonemaps(zdomain, present)
            builder.add_array(f"col.{name}.zmin", zmin)
            builder.add_array(f"col.{name}.zmax", zmax)
            meta["zonemap_block"] = ZONEMAP_BLOCK
            return meta
        # dictionary-encoded raw text column (terms-agg substrate)
        all_values = col.multi if col.multi else {
            d: [v] for d, v in col.values.items()}
        uniques = sorted({str(v) for vs in all_values.values() for v in vs})
        ordinal_of = {term: i for i, term in enumerate(uniques)}
        ordinals = np.full(num_docs_padded, -1, dtype=np.int32)
        for doc_id, value in col.values.items():
            ordinals[doc_id] = ordinal_of[str(value)]
        blob = "".join(uniques).encode()
        dict_offsets = np.zeros(len(uniques) + 1, dtype=np.int64)
        acc = 0
        for i, term in enumerate(uniques):
            acc += len(term.encode())
            dict_offsets[i + 1] = acc
        builder.add_array(f"col.{name}.ordinals", ordinals)
        builder.add_array(f"col.{name}.dict_blob", np.frombuffer(blob, dtype=np.uint8))
        builder.add_array(f"col.{name}.dict_offsets", dict_offsets)
        meta = {"fast": True, "column_kind": "ordinal",
                "cardinality": len(uniques)}
        if any(len(vs) > 1 for vs in all_values.values()):
            # multivalued: (doc, ordinal) pair arrays, one pair per DISTINCT
            # value per doc (ES terms aggs count a doc once per term).
            # Padding: doc 0 with ordinal -1 — excluded on device by the
            # ordinal>=0 test without out-of-bounds gathers.
            pair_docs: list[int] = []
            pair_ords: list[int] = []
            for doc_id in sorted(all_values):
                seen: set[str] = set()
                for value in all_values[doc_id]:
                    text = str(value)
                    if text in seen:
                        continue
                    seen.add(text)
                    pair_docs.append(doc_id)
                    pair_ords.append(ordinal_of[text])
            padded = pad_to(max(len(pair_docs), 1), POSTING_PAD)
            docs_arr = np.zeros(padded, dtype=np.int32)
            ords_arr = np.full(padded, -1, dtype=np.int32)
            docs_arr[:len(pair_docs)] = pair_docs
            ords_arr[:len(pair_ords)] = pair_ords
            builder.add_array(f"col.{name}.mv_docs", docs_arr)
            builder.add_array(f"col.{name}.mv_ords", ords_arr)
            meta["multivalued"] = True
        return meta

    def _write_docstore(self, builder: SplitFileBuilder) -> None:
        blocks: list[bytes] = []
        block_first_doc = [0]
        block_offsets = [0]
        current: list[bytes] = []
        current_size = 0
        for doc_id, source in enumerate(self._sources):
            current.append(source)
            current_size += len(source) + 1
            if current_size >= _STORE_BLOCK_BYTES:
                blocks.append(zlib.compress(b"\n".join(current), 1))
                block_offsets.append(block_offsets[-1] + len(blocks[-1]))
                block_first_doc.append(doc_id + 1)
                current, current_size = [], 0
        if current:
            blocks.append(zlib.compress(b"\n".join(current), 1))
            block_offsets.append(block_offsets[-1] + len(blocks[-1]))
            block_first_doc.append(self.num_docs)
        builder.add_array("store.data", np.frombuffer(b"".join(blocks), dtype=np.uint8))
        builder.add_array("store.block_offsets", np.array(block_offsets, dtype=np.int64))
        builder.add_array("store.block_first_doc", np.array(block_first_doc, dtype=np.int32))


def _packing_enabled() -> bool:
    """Kill switch for A/B comparisons and bug triage: QW_DISABLE_PACKED=1
    writes raw full-width numeric columns (the v1 layout, still under a v2
    footer). Read per call so tests can flip it between splits."""
    return os.environ.get("QW_DISABLE_PACKED", "0") != "1"


def _impact_enabled() -> bool:
    """Kill switch mirroring `_packing_enabled`: QW_DISABLE_IMPACT=1 keeps
    postings doc-ordered with no impact arrays (the v2 layout under a v3
    footer) — the comparator for the impact equivalence suite and bench."""
    return os.environ.get("QW_DISABLE_IMPACT", "0") != "1"


def apply_impact_ordering(arrays: dict[str, np.ndarray], avg_len: float,
                          num_docs: int) -> Optional[dict[str, Any]]:
    """Impact-order one inverted field's posting arenas in place of the
    doc-ordered ones and attach the v3 `impact.*` arrays. `arrays` uses the
    writer's suffix keys (`postings.ids`, `terms.df`, ...); mutated in
    place. Returns the field-meta impact descriptor, or None when the field
    keeps doc order (kill switch, positions recorded, or no terms).

    Shared by the initial write (`_write_inverted`) and the merge path
    (`merge_arrays._merge_inverted`), so merged splits re-quantize against
    their merged df/fieldnorm/avg_len instead of inheriting stale scales.
    """
    if (not _impact_enabled() or "positions.offsets" in arrays
            or not len(arrays["terms.df"])):
        return None
    ids, tfs, quant, bmax, scales = build_impact_arrays(
        arrays["postings.ids"], arrays["postings.tfs"],
        arrays["terms.post_off"], arrays["terms.df"],
        arrays["fieldnorm"], avg_len, num_docs)
    arrays["postings.ids"] = ids
    arrays["postings.tfs"] = tfs
    arrays["impact.quant"] = quant
    arrays["impact.bmax"] = bmax
    arrays["impact.scale"] = scales
    return {"buckets": IMPACT_BUCKETS, "block": IMPACT_BLOCK,
            "ordered": True}


def _pack_numeric(field_type: FieldType, vals: np.ndarray):
    """Frame-of-reference packing decision for one numeric column.

    value = for_min + delta * for_scale, deltas stored in the narrowest
    unsigned lane (u8/u16/u32). for_scale is the GCD of the deltas — it
    collapses quantized domains (whole-second datetime micros scale by
    1e6, all-equal columns collapse to u8 zeros). The scaled span is
    capped just below 2^31 so kernels compare deltas in i32 and the host
    can express a never-matching rebased bound (span+1) in the same
    domain. f64 columns and wider-span integer columns keep the raw
    full-width layout (the high-dynamic-range fallback).

    Returns (deltas, for_min, for_scale, bit_width) or None for raw.
    """
    if not _packing_enabled() or field_type is FieldType.F64 or not len(vals):
        return None
    for_min = int(vals.min())
    span = int(vals.max()) - for_min
    if span >= (1 << 62):  # delta subtraction below must not overflow i64
        return None
    deltas = (vals - vals.dtype.type(for_min)).astype(np.uint64)
    for_scale = int(np.gcd.reduce(deltas)) or 1
    if for_scale > 1:
        deltas //= np.uint64(for_scale)
    span_scaled = span // for_scale
    if span_scaled <= 0xFF:
        bit_width = 8
    elif span_scaled <= 0xFFFF:
        bit_width = 16
    elif span_scaled <= (1 << 31) - 2:
        bit_width = 32
    else:
        return None
    lane = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bit_width]
    return deltas.astype(lane), for_min, for_scale, bit_width


def _column_zonemaps(values: np.ndarray, present: np.ndarray):
    """Per-ZONEMAP_BLOCK-doc min/max over PRESENT values, in the on-disk
    domain of the column (scaled i32 deltas for packed columns, raw values
    otherwise). Blocks with no present docs get inverted sentinels
    (zmin > zmax where the dtype allows) so range predicates skip them."""
    nb = values.shape[0] // ZONEMAP_BLOCK
    v = values.reshape(nb, ZONEMAP_BLOCK)
    p = present.reshape(nb, ZONEMAP_BLOCK).astype(bool)
    if values.dtype.kind == "f":
        lo_sent, hi_sent = -np.inf, np.inf
    else:
        info = np.iinfo(values.dtype)
        lo_sent, hi_sent = info.min, info.max
    zmin = np.where(p, v, hi_sent).min(axis=1).astype(values.dtype)
    zmax = np.where(p, v, lo_sent).max(axis=1).astype(values.dtype)
    return zmin, zmax


def _fast_value(fm: FieldMapping, value: Any):
    if fm.type is FieldType.BOOL:
        return 1 if value else 0
    if fm.type is FieldType.DATETIME:
        return truncate_to_precision(int(value), fm.fast_precision)
    if fm.type in (FieldType.I64, FieldType.U64, FieldType.IP):
        return int(value)
    if fm.type is FieldType.F64:
        return float(value)
    if fm.type is FieldType.TEXT:
        text = str(value)
        # reference: `fast: {normalizer: lowercase}` — the fast column
        # (terms aggs, fast-field reads) observes the normalized form
        return text.lower() if fm.normalizer == "lowercase" else text
    return canonical_term(fm, value)
