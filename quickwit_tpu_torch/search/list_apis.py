"""list_terms / list_fields.

Roles of the reference's `list_terms.rs` and `list_fields/mod.rs`: enumerate
index terms of a field across splits (range-bounded, limited) and describe
the queryable fields of one or more indexes.
"""

from __future__ import annotations

import heapq
from typing import Any, Optional

from ..metastore.base import ListSplitsQuery, Metastore
from ..models.split_metadata import SplitState
from .service import SearcherContext
from .models import SplitIdAndFooter


def leaf_list_terms(context: SearcherContext, splits: list[SplitIdAndFooter],
                    field: str, start_key: Optional[str] = None,
                    end_key: Optional[str] = None, max_terms: int = 100
                    ) -> list[str]:
    """Merged sorted unique terms of `field` across the given splits."""
    iterators = []
    for split in splits:
        reader = context.reader(split)
        term_dict = reader.term_dict(field)
        if term_dict is None:
            continue
        iterators.append(
            (term for term, _df in term_dict.iter_terms(start=start_key)))
    out: list[str] = []
    for term in heapq.merge(*iterators):
        if end_key is not None and term >= end_key:
            break
        if out and out[-1] == term:
            continue
        out.append(term)
        if len(out) >= max_terms:
            break
    return out


def root_list_terms(metastore: Metastore, context: SearcherContext,
                    index_id: str, field: str,
                    start_key: Optional[str] = None,
                    end_key: Optional[str] = None,
                    max_terms: int = 100) -> list[str]:
    metadata = metastore.index_metadata(index_id)
    splits = metastore.list_splits(ListSplitsQuery(
        index_uids=[metadata.index_uid], states=[SplitState.PUBLISHED]))
    offsets = [SplitIdAndFooter(split_id=s.metadata.split_id,
                                storage_uri=metadata.index_config.index_uri)
               for s in splits]
    return leaf_list_terms(context, offsets, field, start_key, end_key, max_terms)


# concrete field type → list-fields type class (reference ListFieldsType;
# "str" expands to keyword+text on the ES field-caps surface)
_TYPE_CLASS = {"text": "str", "i64": "long", "u64": "long", "f64": "double",
               "bool": "boolean", "datetime": "date", "ip": "ip",
               "bytes": "binary"}
# dynamic column type → the value class it makes aggregatable
_COL_CLASS = {"i64": "long", "u64": "long", "f64": "double",
              "bool": "boolean", "text": "str"}


def list_field_entries(metastore: Metastore, context: SearcherContext,
                       index_patterns: list[str],
                       field_patterns: Optional[list[str]] = None,
                       start_timestamp: Optional[int] = None,
                       end_timestamp: Optional[int] = None,
                       filter_ast: Any = None
                       ) -> list[dict[str, Any]]:
    """Per-(field, type-class) entries aggregated over the PER-SPLIT field
    registries (reference `list_fields/mod.rs`: leaf split-fields metadata
    merged at the root). Dynamic fields carry their observed value
    classes; a class is aggregatable only where the split's coerced
    column is of that class (mixed long+double in one split ⇒ the f64
    column makes `double` aggregatable and `long` searchable-only).
    Timestamps (seconds) prune splits by time range before reading.
    `filter_ast` (ES index_filter) prunes each index's splits via the
    conjunctive terms on THAT index's own tag fields — tags extracted
    per index, never leaking one index's tag semantics onto another."""
    import fnmatch
    entries: dict[tuple[str, str], dict[str, Any]] = {}
    for metadata in metastore.list_indexes():
        if not any(fnmatch.fnmatch(metadata.index_id, p.rstrip(","))
                   for p in index_patterns):
            continue
        required_tags: Optional[set] = None
        if filter_ast is not None:
            from .root import extract_required_tags
            tag_fields = tuple(
                metadata.index_config.doc_mapper.tag_fields)
            required_tags = (extract_required_tags(filter_ast, tag_fields)
                             or None)
        query = ListSplitsQuery(index_uids=[metadata.index_uid],
                                states=[SplitState.PUBLISHED])
        for split in metastore.list_splits(query):
            sm = split.metadata
            if (start_timestamp is not None
                    and sm.time_range_end is not None
                    and sm.time_range_end // 1_000_000 < start_timestamp):
                continue
            if (end_timestamp is not None
                    and sm.time_range_start is not None
                    and sm.time_range_start // 1_000_000 >= end_timestamp):
                continue
            if not sm.matches_tags(required_tags):
                continue
            reader = context.reader(SplitIdAndFooter(
                split_id=sm.split_id,
                storage_uri=metadata.index_config.index_uri))
            for name, meta in reader.footer.fields.items():
                if name.startswith("_"):
                    continue  # synthetic fields (_doc_length) stay hidden
                if field_patterns and not any(
                        fnmatch.fnmatch(name, p) for p in field_patterns):
                    continue
                searchable = bool(meta.get("indexed"))
                if meta.get("dynamic"):
                    coerced = _COL_CLASS.get(meta.get("col_type", ""))
                    for cls in meta.get("value_classes", ()):
                        # a fast-only dynamic field is still queryable
                        # through its coerced column (plan.py
                        # _fast_only_term / numeric-range routing)
                        _merge_entry(entries, name, cls, metadata.index_id,
                                     searchable or cls == coerced,
                                     aggregatable=(cls == coerced))
                else:
                    cls = _TYPE_CLASS.get(meta.get("type", ""))
                    if cls is None:
                        continue
                    _merge_entry(entries, name, cls, metadata.index_id,
                                 searchable or meta.get("fast", False),
                                 aggregatable=bool(meta.get("fast")))
    return [entries[key] for key in sorted(entries)]


def _merge_entry(entries: dict, name: str, cls: str, index_id: str,
                 searchable: bool, aggregatable: bool) -> None:
    entry = entries.setdefault((name, cls), {
        "field_name": name, "type_class": cls, "searchable": False,
        "aggregatable": False, "index_ids": []})
    entry["searchable"] = entry["searchable"] or searchable
    entry["aggregatable"] = entry["aggregatable"] or aggregatable
    if index_id not in entry["index_ids"]:
        entry["index_ids"].append(index_id)


def list_fields(metastore: Metastore, index_patterns: list[str],
                context: Optional[SearcherContext] = None
                ) -> list[dict[str, Any]]:
    """Queryable fields across matching indexes (reference list_fields).

    With a searcher context, fields come from the per-split registries
    (dynamic fields included); without one, from the doc mappings."""
    import fnmatch
    if context is not None:
        out: dict[str, dict[str, Any]] = {}
        for e in list_field_entries(metastore, context, index_patterns):
            entry = out.setdefault(e["field_name"], {
                "field_name": e["field_name"], "field_type": e["type_class"],
                "searchable": False, "aggregatable": False, "index_ids": []})
            entry["searchable"] = entry["searchable"] or e["searchable"]
            entry["aggregatable"] = (entry["aggregatable"]
                                     or e["aggregatable"])
            for index_id in e["index_ids"]:
                if index_id not in entry["index_ids"]:
                    entry["index_ids"].append(index_id)
        return sorted(out.values(), key=lambda e: e["field_name"])
    out = {}
    for metadata in metastore.list_indexes():
        if not any(fnmatch.fnmatch(metadata.index_id, p) for p in index_patterns):
            continue
        for fm in metadata.index_config.doc_mapper.field_mappings:
            entry = out.setdefault(fm.name, {
                "field_name": fm.name, "field_type": fm.type.value,
                "searchable": fm.indexed, "aggregatable": fm.fast,
                "index_ids": []})
            entry["index_ids"].append(metadata.index_id)
    return sorted(out.values(), key=lambda e: e["field_name"])
