"""Array-level split merging — segment merge without re-tokenization.

Role of tantivy's segment merger driven by the reference's `MergeExecutor`
(`merge_executor.rs:54`): N immutable splits combine into one by merging
their index structures directly:

- term dictionaries k-way merge (sorted term streams),
- postings concatenate per term with doc-id offsets applied (numpy slicing,
  no decode: the split format's dense arrays make this a copy + add),
- positions rebased, fieldnorms/columns concatenated and re-padded,
- the doc store concatenates **compressed blocks as-is** (blocks are
  independent zlib streams; only the block index shifts).

This replaces the doc-level re-index path (SplitWriter over fetched docs)
whenever no delete tasks must be applied — the common case — making merge
cost IO-bound instead of tokenize-bound.

Carried over from the JAX package's `index/merge_arrays.py` with the
Python k-way term merge only: the native `fastindex.merge_inverted` path
comes with the port's `native/` package. Both give the same bytes.
"""

from __future__ import annotations

import heapq
import logging
import zlib
from typing import Any, Optional

import numpy as np

from .format import DOC_PAD, POSTING_PAD, SplitFileBuilder, SplitFooter, pad_to
from .reader import SplitReader

logger = logging.getLogger(__name__)


def merge_splits(readers: list[SplitReader], reorder_field: Optional[str] = None,
                 fault_hook=None) -> bytes:
    """Merged split file bytes. All inputs must share a doc mapping (the
    caller guarantees it via doc_mapping_uid, as the reference does).

    `reorder_field` opts into cluster-aware doc reordering (the doc-id
    reassignment of arxiv 1411.1220 applied to the timestamp axis): the
    merged split's doc ids follow ascending `reorder_field` values instead
    of input append order, so per-512-doc zonemaps tighten and range
    filters prune more blocks. Purely a layout decision — the doc SET and
    every per-doc structure are conserved, and any failure (including a
    `fault_hook` chaos fault) falls back to the append-order merge.
    `fault_hook` is the merge executor's FaultInjector binding for the
    "merge.reorder" point."""
    if reorder_field is not None:
        try:
            if fault_hook is not None:
                fault_hook()
            order = _cluster_order(readers, reorder_field)
            if order is not None:
                return _merge_splits_ordered(readers, order)
        except Exception as exc:  # noqa: BLE001 - layout opt must never fail a merge
            logger.warning("cluster reorder on %r failed (%s); "
                           "merging in append order", reorder_field, exc)
    return _merge_splits_ordered(readers, None)


def _cluster_order(readers: list[SplitReader],
                   field: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(new_order, old2new) doc permutation clustering the merged split by
    ascending `field` value (docs missing the value last, ties stable in
    append order), or None when inapplicable: no input holds the column,
    the append order is already clustered, or any inverted field records
    positions (their per-posting arrays are not rebased under a permute)."""
    for r in readers:
        for name, meta in r.footer.fields.items():
            if (meta.get("indexed")
                    and r.has_array(f"inv.{name}.positions.offsets")):
                return None
    num_docs = sum(r.num_docs for r in readers)
    doc_offsets = np.cumsum([0] + [r.num_docs for r in readers])[:-1]
    keys = np.full(num_docs, np.inf, dtype=np.float64)
    found = False
    for reader, offset in zip(readers, doc_offsets):
        if reader.footer.fields.get(field, {}).get("column_kind") != "numeric":
            continue
        n = reader.num_docs
        v, p = reader.column_values(field)
        pm = p[:n].astype(bool)
        keys[offset: offset + n][pm] = v[:n][pm].astype(np.float64)
        found = found or bool(pm.any())
    if not found:
        return None
    new_order = np.argsort(keys, kind="stable").astype(np.int64)
    if np.array_equal(new_order, np.arange(num_docs, dtype=np.int64)):
        return None  # already clustered: keep the cheap append-order layout
    old2new = np.empty(num_docs, dtype=np.int64)
    old2new[new_order] = np.arange(num_docs, dtype=np.int64)
    return new_order, old2new


def _merge_splits_ordered(readers: list[SplitReader],
                          order: Optional[tuple[np.ndarray,
                                                np.ndarray]]) -> bytes:
    new_order, old2new = order if order is not None else (None, None)
    num_docs = sum(r.num_docs for r in readers)
    num_docs_padded = pad_to(num_docs, DOC_PAD)
    doc_offsets = np.cumsum([0] + [r.num_docs for r in readers])[:-1]

    builder = SplitFileBuilder()
    fields_meta: dict[str, dict[str, Any]] = {}

    field_names = _union_fields(readers)
    for name in field_names["inverted"]:
        fields_meta[name] = _merge_inverted(
            builder, name, readers, doc_offsets, num_docs, num_docs_padded,
            new_order, old2new)
    for name in field_names["numeric_cols"]:
        meta = fields_meta.setdefault(name, dict(_first_meta(readers, name)))
        meta.update(_merge_numeric_column(
            builder, name, readers, doc_offsets, num_docs, num_docs_padded,
            new_order))
    for name in field_names["ordinal_cols"]:
        meta = fields_meta.setdefault(name, dict(_first_meta(readers, name)))
        meta.update(_merge_ordinal_column(
            builder, name, readers, doc_offsets, num_docs, num_docs_padded,
            new_order, old2new))
    _merge_docstore(builder, readers, doc_offsets, new_order)

    for name, meta in fields_meta.items():
        # dynamic fields: union the observed value classes across inputs
        # and retype the merged column (str coercion wins; mixed numerics
        # promoted to f64 by _merge_numeric_column)
        classes: set[str] = set()
        dynamic = False
        for r in readers:
            rmeta = r.footer.fields.get(name, {})
            if rmeta.get("dynamic"):
                dynamic = True
                classes.update(rmeta.get("value_classes", ()))
        if not dynamic:
            continue
        meta["dynamic"] = True
        meta["value_classes"] = sorted(classes)
        kind = meta.get("column_kind")
        if kind == "ordinal":
            meta["col_type"] = "text"
        elif kind == "numeric":
            col_types = {r.footer.fields.get(name, {}).get("col_type")
                         for r in readers
                         if r.footer.fields.get(name, {}).get("col_type")}
            meta["col_type"] = (col_types.pop() if len(col_types) == 1
                                else "f64")

    time_ranges = [r.footer.time_range for r in readers if r.footer.time_range]
    time_range = None
    if time_ranges:
        time_range = (min(t[0] for t in time_ranges),
                      max(t[1] for t in time_ranges))
    footer = SplitFooter(
        num_docs=num_docs, num_docs_padded=num_docs_padded, arrays={},
        fields=fields_meta, time_range=time_range,
        doc_mapping_uid=readers[0].footer.doc_mapping_uid,
        extra={"uncompressed_docs_size_bytes": sum(
            r.footer.extra.get("uncompressed_docs_size_bytes", 0)
            for r in readers)},
    )
    return builder.finish(footer)


def _union_fields(readers: list[SplitReader]) -> dict[str, list[str]]:
    inverted, numeric_cols, ordinal_cols = set(), set(), set()
    for r in readers:
        for name, meta in r.footer.fields.items():
            if meta.get("indexed"):
                inverted.add(name)
            kind = meta.get("column_kind")
            if kind == "numeric":
                numeric_cols.add(name)
            elif kind == "ordinal":
                ordinal_cols.add(name)
    # a dynamic field coerced numeric in one split and string in another
    # merges as strings (the writer's own coercion order: str wins)
    numeric_cols -= ordinal_cols
    return {"inverted": sorted(inverted), "numeric_cols": sorted(numeric_cols),
            "ordinal_cols": sorted(ordinal_cols)}


def _first_meta(readers, name) -> dict[str, Any]:
    for r in readers:
        if name in r.footer.fields:
            return r.footer.fields[name]
    return {}


class _ArrayCollector:
    """Builder-shaped shim capturing arrays for post-processing (posting
    re-sort, impact ordering, doc reorder) before they hit the real
    SplitFileBuilder."""

    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}

    def add_array(self, name: str, arr: np.ndarray) -> None:
        self.arrays[name] = arr


def _merge_inverted(builder, name, readers, doc_offsets, num_docs,
                    num_docs_padded, new_order=None,
                    old2new=None) -> dict[str, Any]:
    """The Python k-way merge lands in a collector so the merged arenas
    can be post-processed: doc ids remapped under a cluster reorder, each
    term's postings restored to ascending-doc order (v3 inputs arrive
    impact-ordered — their concatenation is sorted by NEITHER doc nor
    impact), per-term max tf persisted, and finally the merged field
    re-impact-ordered against its own merged df/fieldnorm/avg_len instead
    of inheriting the inputs' stale quantization scales."""
    with_positions = any(
        r.has_array(f"inv.{name}.positions.offsets") for r in readers)
    collect = _ArrayCollector()
    _merge_inverted_python(
        collect, name, readers, doc_offsets, num_docs_padded,
        with_positions)
    prefix = f"inv.{name}."
    arrays = {full[len(prefix):]: arr for full, arr in collect.arrays.items()}

    norms = np.zeros(num_docs_padded, dtype=np.int32)
    total_tokens = 0
    for reader, offset in zip(readers, doc_offsets):
        if not reader.has_array(f"inv.{name}.fieldnorm"):
            continue
        norms[offset: offset + reader.num_docs] = \
            reader.fieldnorm(name)[: reader.num_docs]
        total_tokens += int(reader.field_meta(name).get("total_tokens", 0))
    if new_order is not None:
        norms[:num_docs] = norms[:num_docs][new_order]
    arrays["fieldnorm"] = norms

    dfs = arrays["terms.df"]
    post_offs = arrays["terms.post_off"].astype(np.int64)
    post_lens = arrays["terms.post_len"].astype(np.int64)
    ids = np.array(arrays["postings.ids"], dtype=np.int32, copy=True)
    tfs = np.array(arrays["postings.tfs"], dtype=np.int32, copy=True)
    needs_doc_sort = (old2new is not None or any(
        r.impact_info(name) is not None for r in readers))
    if old2new is not None:
        real = tfs > 0  # pads keep the sentinel id, outside old2new's range
        ids[real] = old2new[ids[real]]
    if len(dfs) and needs_doc_sort and not with_positions:
        # positions fields never reach here reordered: impact ordering
        # skips them at write time and _cluster_order refuses the permute
        seg = np.repeat(np.arange(len(post_offs), dtype=np.int64), post_lens)
        order = np.lexsort((ids, seg))
        ids = ids[order]
        tfs = tfs[order]
    arrays["postings.ids"] = ids
    arrays["postings.tfs"] = tfs
    # per-term max tf: merged splits persist the term_stats input just like
    # freshly written ones, so reader reopens never rescan postings
    if len(dfs):
        arrays["terms.max_tf"] = np.maximum.reduceat(
            tfs, post_offs).astype(np.int32)
    else:
        arrays["terms.max_tf"] = np.zeros(0, dtype=np.int32)

    impact_meta = None
    if not with_positions:
        from .writer import apply_impact_ordering
        avg_len = (total_tokens / num_docs) if num_docs else 0.0
        impact_meta = apply_impact_ordering(arrays, avg_len, num_docs)

    for suffix, arr in arrays.items():
        builder.add_array(prefix + suffix, arr)

    meta = dict(_first_meta(readers, name))
    meta.update({
        "num_terms": len(dfs),
        "total_tokens": total_tokens,
        "avg_len": (total_tokens / num_docs) if num_docs else 0.0,
    })
    if impact_meta is not None:
        meta["impact"] = impact_meta
    else:
        # an inherited first-meta "impact" entry would claim an ordering
        # the merged arenas no longer have
        meta.pop("impact", None)
    return meta


def _merge_inverted_python(builder, name, readers, doc_offsets,
                           num_docs_padded, with_positions) -> int:
    term_dicts = [(i, r.term_dict(name)) for i, r in enumerate(readers)]
    term_dicts = [(i, td) for i, td in term_dicts if td is not None]
    # prefetch whole arenas once per reader: per-term ranged reads would hit
    # the byte-range cache's range-merge thousands of times (quadratic)
    arenas = {}
    for reader_idx, _td in term_dicts:
        r = readers[reader_idx]
        arenas[reader_idx] = {
            "ids": r.array(f"inv.{name}.postings.ids"),
            "tfs": r.array(f"inv.{name}.postings.tfs"),
            "pos_offs": (r.array(f"inv.{name}.positions.offsets")
                         if r.has_array(f"inv.{name}.positions.offsets") else None),
            "pos_data": (r.array(f"inv.{name}.positions.data")
                         if r.has_array(f"inv.{name}.positions.data") else None),
        }

    # k-way merge of sorted term streams: heap of (term, reader_idx, ordinal)
    streams = []
    for reader_idx, td in term_dicts:
        if len(td):
            streams.append((td.term_at(0), reader_idx, 0, td))
    heapq.heapify(streams)

    blob_parts: list[bytes] = []
    offsets_list = [0]
    dfs_list: list[int] = []
    post_offs_list: list[int] = []
    post_lens_list: list[int] = []
    ids_chunks: list[np.ndarray] = []
    tfs_chunks: list[np.ndarray] = []
    pos_offset_chunks: list[np.ndarray] = []
    pos_data_chunks: list[np.ndarray] = []
    blob_len = 0
    cursor = 0
    pos_cursor = 0

    while streams:
        term = streams[0][0]
        group: list[tuple[int, Any, int]] = []  # (reader_idx, td, ordinal)
        while streams and streams[0][0] == term:
            _, reader_idx, ordinal, td = heapq.heappop(streams)
            group.append((reader_idx, td, ordinal))
            if ordinal + 1 < len(td):
                heapq.heappush(
                    streams, (td.term_at(ordinal + 1), reader_idx, ordinal + 1, td))
        group.sort()  # reader order == ascending doc-id ranges

        df = 0
        term_ids: list[np.ndarray] = []
        term_tfs: list[np.ndarray] = []
        term_pos_offsets: list[np.ndarray] = []
        term_pos_data: list[np.ndarray] = []
        for reader_idx, td, ordinal in group:
            info = _info_at(td, ordinal)
            arena = arenas[reader_idx]
            lo, hi = info.post_off, info.post_off + info.df
            term_ids.append(arena["ids"][lo:hi].astype(np.int64)
                            + doc_offsets[reader_idx])
            term_tfs.append(arena["tfs"][lo:hi])
            if with_positions and arena["pos_offs"] is not None:
                offs = arena["pos_offs"][lo: hi + 1]
                # per-posting position list lengths for the real postings
                lens = (offs[1:] - offs[:-1]).astype(np.int64)
                term_pos_offsets.append(lens)
                term_pos_data.append(
                    arena["pos_data"][int(offs[0]): int(offs[-1])])
            df += info.df

        padded = pad_to(max(df, 1), POSTING_PAD)
        ids_arr = np.full(padded, num_docs_padded, dtype=np.int32)
        tfs_arr = np.zeros(padded, dtype=np.int32)
        merged_ids = np.concatenate(term_ids) if term_ids else np.array([], np.int64)
        ids_arr[:df] = merged_ids.astype(np.int32)
        if term_tfs:
            tfs_arr[:df] = np.concatenate(term_tfs)
        ids_chunks.append(ids_arr)
        tfs_chunks.append(tfs_arr)
        if with_positions:
            lens_all = (np.concatenate(term_pos_offsets)
                        if term_pos_offsets else np.array([], np.int64))
            entry_offsets = np.zeros(padded + 1, dtype=np.int64)
            np.cumsum(lens_all, out=entry_offsets[1: df + 1])
            entry_offsets[df + 1:] = entry_offsets[df]
            pos_offset_chunks.append(entry_offsets + pos_cursor)
            data = (np.concatenate(term_pos_data)
                    if term_pos_data else np.array([], np.int32))
            pos_data_chunks.append(data.astype(np.int32))
            pos_cursor += int(entry_offsets[df])

        encoded = term.encode()
        blob_parts.append(encoded)
        blob_len += len(encoded)
        offsets_list.append(blob_len)
        dfs_list.append(df)
        post_offs_list.append(cursor)
        post_lens_list.append(padded)
        cursor += padded

    builder.add_array(f"inv.{name}.terms.blob",
                      np.frombuffer(b"".join(blob_parts), dtype=np.uint8))
    builder.add_array(f"inv.{name}.terms.offsets",
                      np.array(offsets_list, dtype=np.int64))
    builder.add_array(f"inv.{name}.terms.df", np.array(dfs_list, dtype=np.int32))
    builder.add_array(f"inv.{name}.terms.post_off",
                      np.array(post_offs_list, dtype=np.int64))
    builder.add_array(f"inv.{name}.terms.post_len",
                      np.array(post_lens_list, dtype=np.int32))
    builder.add_array(f"inv.{name}.postings.ids",
                      np.concatenate(ids_chunks) if ids_chunks
                      else np.array([], np.int32))
    builder.add_array(f"inv.{name}.postings.tfs",
                      np.concatenate(tfs_chunks) if tfs_chunks
                      else np.array([], np.int32))
    if with_positions:
        # trailing guard entry so slice arithmetic matches the writer layout
        all_offsets = (np.concatenate(
            [c[:-1] for c in pos_offset_chunks] + [[pos_cursor]])
            if pos_offset_chunks else np.array([0], np.int64))
        builder.add_array(f"inv.{name}.positions.offsets",
                          np.asarray(all_offsets, dtype=np.int64))
        builder.add_array(f"inv.{name}.positions.data",
                          np.concatenate(pos_data_chunks) if pos_data_chunks
                          else np.array([], np.int32))
    return len(dfs_list)


def _info_at(td, ordinal: int):
    from .reader import TermInfo
    return TermInfo(ordinal, int(td.dfs[ordinal]), int(td.post_offs[ordinal]),
                    int(td.post_lens[ordinal]))


def _merge_numeric_column(builder, name, readers, doc_offsets, num_docs,
                          num_docs_padded, new_order=None) -> dict[str, Any]:
    dtypes = {r.column_values(name)[0].dtype for r in readers
              if r.footer.fields.get(name, {}).get("column_kind") == "numeric"}
    # dynamic columns typed differently per split (i64 here, f64 there)
    # coerce to f64 on merge — the writer's own mixed-numeric rule
    dtype = dtypes.pop() if len(dtypes) == 1 else np.dtype(np.float64)
    values = np.zeros(num_docs_padded, dtype=dtype)
    present = np.zeros(num_docs_padded, dtype=np.uint8)
    vmin, vmax = None, None
    for reader, offset in zip(readers, doc_offsets):
        meta = reader.footer.fields.get(name, {})
        if meta.get("column_kind") != "numeric":
            continue
        v, p = reader.column_values(name)
        values[offset: offset + reader.num_docs] = v[: reader.num_docs]
        present[offset: offset + reader.num_docs] = p[: reader.num_docs]
        if meta.get("min_value") is not None:
            vmin = meta["min_value"] if vmin is None else min(vmin, meta["min_value"])
            vmax = meta["max_value"] if vmax is None else max(vmax, meta["max_value"])
    if new_order is not None:
        values[:num_docs] = values[:num_docs][new_order]
        present[:num_docs] = present[:num_docs][new_order]
    builder.add_array(f"col.{name}.values", values)
    builder.add_array(f"col.{name}.present", present)
    # merged splits regain per-512-doc zonemaps (the reason the cluster
    # reorder exists: sorted values make the block bounds tight). Domain
    # is the raw values array — the merged column is never FOR-packed
    from .format import ZONEMAP_BLOCK
    from .writer import _column_zonemaps
    zmin, zmax = _column_zonemaps(values, present)
    builder.add_array(f"col.{name}.zmin", zmin)
    builder.add_array(f"col.{name}.zmax", zmax)
    return {"fast": True, "column_kind": "numeric",
            "min_value": vmin, "max_value": vmax,
            "zonemap_block": ZONEMAP_BLOCK, "packed": None}


def _canonical_numeric_strings(reader, name) -> "list[tuple[int, str]]":
    """Per-doc canonical strings of a NUMERIC column — used when a
    dynamic field is string-typed in the merged split but numeric in
    this input. Rendering follows the source split's value classes so it
    matches what the writer's own str-coercion (dynamic_canonical) would
    have produced: bool columns → true/false, integer-only → "5", floats
    → repr. (A long stored in an f64 column — the input split saw both —
    is unrecoverable and renders as repr(float).)"""
    meta = reader.footer.fields.get(name, {})
    classes = set(meta.get("value_classes", ()))
    v, p = reader.column_values(name)
    out = []
    is_bool = meta.get("col_type") == "bool" or classes == {"boolean"}
    ints_only = classes and "double" not in classes and not is_bool
    for doc_id in np.nonzero(p[: reader.num_docs])[0]:
        val = v[doc_id]
        if is_bool:
            text = "true" if val else "false"
        elif ints_only or not np.issubdtype(v.dtype, np.floating):
            text = str(int(val))
        else:
            text = repr(float(val))
        out.append((int(doc_id), text))
    return out

def _merge_ordinal_column(builder, name, readers, doc_offsets, num_docs,
                          num_docs_padded, new_order=None,
                          old2new=None) -> dict[str, Any]:
    # (doc, value-string) pairs per reader; ordinal inputs keep EVERY
    # value via the mv arrays when present, numeric inputs contribute
    # canonical strings (mixed-type dynamic columns coerce to strings)
    per_reader_pairs: list[list[tuple[int, str]]] = []
    union: set[str] = set()
    for reader in readers:
        kind = reader.footer.fields.get(name, {}).get("column_kind")
        if kind == "ordinal":
            local_keys = reader.column_dict(name)
            pairs: list[tuple[int, str]] = []
            if reader.has_array(f"col.{name}.mv_docs"):
                docs = reader.array(f"col.{name}.mv_docs")
                ords = reader.array(f"col.{name}.mv_ords")
                for d, o in zip(docs.tolist(), ords.tolist()):
                    if o >= 0:
                        pairs.append((d, local_keys[o]))
            else:
                local = reader.column_ordinals(name)[: reader.num_docs]
                for doc_id in np.nonzero(local >= 0)[0]:
                    pairs.append((int(doc_id), local_keys[local[doc_id]]))
            per_reader_pairs.append(pairs)
        elif kind == "numeric":
            per_reader_pairs.append(_canonical_numeric_strings(reader, name))
        else:
            per_reader_pairs.append([])
        union.update(v for _d, v in per_reader_pairs[-1])
    uniques = sorted(union)
    ordinal_of = {t: i for i, t in enumerate(uniques)}
    ordinals = np.full(num_docs_padded, -1, dtype=np.int32)
    all_pairs: list[tuple[int, int]] = []  # (global doc, global ordinal)
    multivalued = False
    for pairs, offset in zip(per_reader_pairs, doc_offsets):
        seen_docs: set[int] = set()
        for doc_id, value in pairs:
            g = int(offset) + doc_id
            o = ordinal_of[value]
            if g not in seen_docs:
                ordinals[g] = o  # dense column keeps the first value
                seen_docs.add(g)
            all_pairs.append((g, o))
        if len(seen_docs) != len(pairs):
            multivalued = True
    if new_order is not None:
        ordinals[:num_docs] = ordinals[:num_docs][new_order]
        # pair docs follow the permuted ids; stable doc-ascending re-sort
        # keeps each doc's distinct-value order intact
        all_pairs = sorted(((int(old2new[g]), o) for g, o in all_pairs),
                           key=lambda p: p[0])
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
    if multivalued:
        from .format import POSTING_PAD, pad_to as _pad_to
        seen_pairs: set[tuple[int, int]] = set()
        mv = [p for p in all_pairs
              if p not in seen_pairs and not seen_pairs.add(p)]
        padded = _pad_to(max(len(mv), 1), POSTING_PAD)
        docs_arr = np.zeros(padded, dtype=np.int32)
        ords_arr = np.full(padded, -1, dtype=np.int32)
        docs_arr[: len(mv)] = [d for d, _o in mv]
        ords_arr[: len(mv)] = [o for _d, o in mv]
        builder.add_array(f"col.{name}.mv_docs", docs_arr)
        builder.add_array(f"col.{name}.mv_ords", ords_arr)
        meta["multivalued"] = True
    return meta


def _merge_docstore(builder, readers, doc_offsets, new_order=None) -> None:
    if new_order is not None:
        _rebuild_docstore(builder, readers, new_order)
        return
    data_chunks: list[np.ndarray] = []
    block_offsets = [0]
    block_first = []
    byte_cursor = 0
    for reader, offset in zip(readers, doc_offsets):
        offsets = reader.array("store.block_offsets")
        firsts = reader.array("store.block_first_doc")
        data = reader.array("store.data")
        data_chunks.append(data)
        for b in range(len(firsts) - 1):
            block_first.append(int(firsts[b]) + int(offset))
        for b in range(1, len(offsets)):
            block_offsets.append(byte_cursor + int(offsets[b]))
        byte_cursor += int(offsets[-1])
    total_docs = int(doc_offsets[-1]) + readers[-1].num_docs if len(readers) else 0
    block_first.append(total_docs)
    builder.add_array("store.data",
                      np.concatenate(data_chunks) if data_chunks
                      else np.array([], np.uint8))
    builder.add_array("store.block_offsets", np.array(block_offsets, dtype=np.int64))
    builder.add_array("store.block_first_doc", np.array(block_first, dtype=np.int32))


def _rebuild_docstore(builder, readers, new_order) -> None:
    """Doc-level docstore rebuild for the cluster reorder: the compressed
    input blocks cannot be reused (their doc runs are no longer
    contiguous), so every source line re-blocks in the new order with the
    writer's own blocking parameters."""
    from .writer import _STORE_BLOCK_BYTES
    sources: list[bytes] = []
    for reader in readers:
        block_first = reader.array("store.block_first_doc")
        block_offsets = reader.array("store.block_offsets")
        data = reader.array("store.data")
        for b in range(len(block_first) - 1):
            raw = data[int(block_offsets[b]): int(block_offsets[b + 1])]
            sources.extend(line for line in
                           zlib.decompress(raw.tobytes()).split(b"\n")
                           if line)
    num_docs = len(sources)
    if num_docs != new_order.shape[0]:
        raise ValueError(f"docstore holds {num_docs} docs, permutation "
                         f"covers {new_order.shape[0]}")
    blocks: list[bytes] = []
    block_first_doc = [0]
    block_offsets_out = [0]
    current: list[bytes] = []
    current_size = 0
    for new_id, old_id in enumerate(new_order.tolist()):
        source = sources[old_id]
        current.append(source)
        current_size += len(source) + 1
        if current_size >= _STORE_BLOCK_BYTES:
            blocks.append(zlib.compress(b"\n".join(current), 1))
            block_offsets_out.append(block_offsets_out[-1] + len(blocks[-1]))
            block_first_doc.append(new_id + 1)
            current, current_size = [], 0
    if current:
        blocks.append(zlib.compress(b"\n".join(current), 1))
        block_offsets_out.append(block_offsets_out[-1] + len(blocks[-1]))
        block_first_doc.append(num_docs)
    builder.add_array("store.data",
                      np.frombuffer(b"".join(blocks), dtype=np.uint8))
    builder.add_array("store.block_offsets",
                      np.array(block_offsets_out, dtype=np.int64))
    builder.add_array("store.block_first_doc",
                      np.array(block_first_doc, dtype=np.int32))
