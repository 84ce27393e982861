"""Leaf search: one split, end to end on the device.

Role of the reference's `leaf_search_single_split` (`quickwit-search/src/
leaf.rs:657`): lower the query against the split, stage exactly the arrays
the plan needs on the device, run the posting-space program, and emit a
mergeable `LeafSearchResponse`.

Counterpart of the JAX package's `search/leaf.py`, subset: the staging
cache is per reader and per device, with no HBM budget and no resident
column store; execution has no query batcher, no chunked scan, no deadline
and no tenancy. `search_after` markers (numeric and string, one or two
keys), the top-k threshold pushdown and a cached predicate mask
(`mask_override`) reach the device program through `prepare_plan_only`.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.doc_mapper import DocMapper, FieldType
from ..index.reader import SplitReader
from ..query.aggregations import parse_aggs
from .executor import execute_plan
from .models import (LeafSearchResponse, PartialHit, SearchRequest,
                     string_sort_of)
from .plan import BucketAggExec, CompositeAggExec, MetricAggExec, lower_request
from ..ops.topk import MISSING_VALUE_SENTINEL
from .hostdecode import host_array, host_float, host_int, host_list

# staging buffers align every array to this many bytes, so each device view
# starts on a boundary any element type accepts
_STAGE_ALIGN = 256


def decode_raw_sort_value(internal: float, sort_field: str, sort_order: str,
                          sort_is_int: bool, score: float, doc_id: int):
    """Internal higher-is-better key → displayed raw sort value.

    Shared by the single-split and batched decode paths so the sort-key
    encoding lives in exactly one place."""
    if sort_field == "_score":
        return host_float(score)
    if sort_field == "_doc":
        return doc_id
    if internal <= MISSING_VALUE_SENTINEL:
        return None
    raw = internal if sort_order == "desc" else -internal
    return host_int(raw) if sort_is_int else raw


def decode_sort_value_exact(internal: float, sort_field: str,
                            sort_order: str, sort_is_int: bool,
                            score: float, doc_id: int, exact_col):
    """`decode_raw_sort_value` + the exact 64-bit column re-read for int
    sorts (internal f64 keys round at 2^53) — the one decode used for
    primary AND secondary keys on both the per-split and batched paths."""
    raw = decode_raw_sort_value(internal, sort_field, sort_order,
                                sort_is_int, score, doc_id)
    if raw is not None and sort_is_int and exact_col is not None:
        # exact_col is the reader's mmap'd host column, never device data
        return host_int(exact_col[doc_id])
    return raw


def _device_cache(reader: SplitReader, device: torch.device) -> dict:
    caches = getattr(reader, "_torch_device_arrays", None)
    if caches is None:
        caches = reader._torch_device_arrays = {}
    return caches.setdefault(str(device), {})


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def warmup_device_arrays(reader: SplitReader, plan, device=None
                         ) -> tuple[list, int]:
    """Host→device transfer of the plan's arrays, with cross-query reuse
    per reader and device (role of `warmup`, `leaf.rs:304`). Arrays not yet
    on the device are packed into one pinned host buffer and cross in ONE
    non-blocking copy; each array is a typed view of the device buffer.
    Returns (device_arrays in slot order, bytes staged by this call)."""
    dev = resolve_device(device)
    cache = _device_cache(reader, dev)
    missing = [(key, np.ascontiguousarray(arr))
               for key, arr in zip(plan.array_keys, plan.arrays)
               if key not in cache]
    # a key can repeat across slots; stage it once
    missing = list(dict(missing).items())
    offsets = []
    total = 0
    for _, arr in missing:
        offsets.append(total)
        total += -(-arr.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
    if missing:
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        host_np = host.numpy()
        for (_, arr), off in zip(missing, offsets):
            host_np[off: off + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        staged = host.to(dev, non_blocking=True) if dev.type != "cpu" \
            else host
        for (key, arr), off in zip(missing, offsets):
            view = staged[off: off + arr.nbytes].view(_torch_dtype(arr.dtype))
            cache[key] = view.reshape(arr.shape)
    staged_bytes = sum(arr.nbytes for _, arr in missing)
    return [cache[key] for key in plan.array_keys], staged_bytes


def prepare_plan_only(request: SearchRequest, doc_mapper: DocMapper,
                      reader: SplitReader, split_id: str,
                      sort_value_threshold: Optional[float] = None,
                      mask_override=None, mask_key: Optional[str] = None):
    """Storage byte-range IO + plan lowering, without the device transfer.

    `sort_value_threshold` (internal higher-is-better key) is pushed into
    the plan as a scalar masking sub-threshold docs before top-k.
    `mask_override`/`mask_key` forward a packed predicate mask (from
    `executor.compute_packed_mask`, of either engine) to `lower_request`,
    which then skips query lowering and every predicate column."""
    agg_specs = parse_aggs(request.aggs) if request.aggs else []
    sort = request.sort_fields[0] if request.sort_fields else None
    sort_field = sort.field if sort else "_score"
    sort_order = sort.order if sort else "desc"
    sort2 = request.sort_fields[1] if len(request.sort_fields) > 1 else None
    return lower_request(
        request.query_ast, doc_mapper, reader, agg_specs,
        sort_field=sort_field, sort_order=sort_order,
        sort2_field=sort2.field if sort2 else None,
        sort2_order=sort2.order if sort2 else "desc",
        start_timestamp=request.start_timestamp,
        end_timestamp=request.end_timestamp,
        search_after=search_after_marker(request, split_id, sort_field,
                                         sort_order, sort2,
                                         doc_mapper=doc_mapper,
                                         reader=reader),
        sort_value_threshold=sort_value_threshold,
        mask_override=mask_override,
        mask_key=mask_key,
    )


def prepare_single_split(request: SearchRequest, doc_mapper: DocMapper,
                         reader: SplitReader, split_id: str, device=None
                         ) -> tuple[Any, list, int]:
    """Stage 1 of leaf search: storage IO, plan lowering and the batched
    host→device transfer. Returns (plan, device_arrays, staged_bytes)."""
    plan = prepare_plan_only(request, doc_mapper, reader, split_id)
    device_arrays, staged = warmup_device_arrays(reader, plan, device)
    return plan, device_arrays, staged


def leaf_search_single_split(
    request: SearchRequest,
    doc_mapper: DocMapper,
    reader: SplitReader,
    split_id: str,
    device=None,
) -> LeafSearchResponse:
    """One split, end to end, on `device` (default `cuda`)."""
    dev = resolve_device(device)
    plan, device_arrays, _ = prepare_single_split(request, doc_mapper,
                                                  reader, split_id, dev)
    return execute_prepared_split(request, doc_mapper, reader, split_id,
                                  plan, device_arrays, dev)


def execute_prepared_split(
    request: SearchRequest,
    doc_mapper: DocMapper,
    reader: SplitReader,
    split_id: str,
    plan: Any,
    device_arrays: list,
    device=None,
) -> LeafSearchResponse:
    """Stage 2: the posting-space program and its single packed readback,
    decoded into hits and mergeable aggregation states."""
    t0 = time.monotonic()
    sort = request.sort_fields[0] if request.sort_fields else None
    sort_field = sort.field if sort else "_score"
    sort_order = sort.order if sort else "desc"
    sort2 = request.sort_fields[1] if len(request.sort_fields) > 1 else None
    # k=0 (count/agg-only): the executor skips keying and top-k entirely
    k = request.start_offset + request.max_hits
    result = execute_plan(plan, k, device_arrays, device)

    count = result["count"]
    if getattr(plan, "count_override", None) is not None:
        # impact prefix cutoff (plan.py): the kernel only saw the live
        # prefix of a single bare term's postings, so its count is a
        # truncation artifact — the exact match count is the term's df
        count = plan.count_override
    num_hits_returned = min(k, count)
    partial_hits = []
    # text-field sort: internal keys are split-local dictionary ordinals —
    # decode to term strings here (the reference's leaf likewise returns
    # term bytes); collector merges on the strings
    text_dict = (reader.column_dict(plan.sort_text_field)
                 if plan.sort_text_field else None)
    sort_is_int = _sort_values_are_int(doc_mapper, sort_field)
    sort2_is_int = (_sort_values_are_int(doc_mapper, sort2.field)
                    if sort2 else False)
    # exact 64-bit display values: internal keys are f64 (2^53 mantissa),
    # so i64/u64 values near ±2^63 round — re-read the exact column value
    # host-side for the k returned hits (the reference returns exact
    # tantivy column values in hits[].sort)
    exact_col = (reader.column_values(sort_field)[0]
                 if sort_is_int and text_dict is None else None)
    exact_col2 = (reader.column_values(sort2.field)[0]
                  if sort2 is not None and sort2_is_int else None)
    # bulk .tolist() pre-decode: the packed readback already pulled these
    # to host, so ONE conversion per array replaces a per-hit int()/float()
    # in the loop below (everything past here touches Python scalars only)
    sort_values = host_list(result["sort_values"][:num_hits_returned])
    doc_ids = host_list(result["doc_ids"][:num_hits_returned])
    scores = host_list(result["scores"][:num_hits_returned])
    values2 = result.get("sort_values2")
    if values2 is not None:
        values2 = host_list(values2[:num_hits_returned])
    for i in range(num_hits_returned):
        internal = sort_values[i]
        if internal == float("-inf"):
            break  # fewer eligible hits than k (search_after pushdown)
        doc_id = doc_ids[i]
        if text_dict is not None:
            if internal == MISSING_VALUE_SENTINEL:
                raw = None
            else:
                ordinal = host_int(internal if sort_order == "desc"
                                   else -internal)
                raw = text_dict[ordinal]
        else:
            raw = decode_sort_value_exact(
                internal, sort_field, sort_order, sort_is_int,
                scores[i], doc_id, exact_col)
        internal2, raw2 = 0.0, None
        if sort2 is not None and values2 is not None:
            internal2 = values2[i]
            raw2 = decode_sort_value_exact(
                internal2, sort2.field, sort2.order, sort2_is_int,
                scores[i], doc_id, exact_col2)
        partial_hits.append(PartialHit(
            sort_value=internal, split_id=split_id, doc_id=doc_id,
            raw_sort_value=raw, sort_value2=internal2, raw_sort_value2=raw2))

    intermediate_aggs = _intermediate_aggs(plan, result["aggs"])
    elapsed = int((time.monotonic() - t0) * 1e6)
    return LeafSearchResponse(
        num_hits=count,
        partial_hits=partial_hits,
        num_attempted_splits=1,
        num_successful_splits=1,
        failed_splits=[],
        intermediate_aggs=intermediate_aggs,
        resource_stats={"cpu_micros": elapsed},
    )


def search_after_marker(request: SearchRequest, split_id: str,
                        sort_field: str, sort_order: str, sort2=None,
                        doc_mapper=None, reader=None):
    """(internal_value, internal_value2|None, relation, marker_doc) for this
    split, or None.

    A hit qualifies iff key < m, or key == m and (split, doc) > (m_split,
    m_doc); the split relation is static per split:
      split < m_split  → strictly-less ("lt")
      split == m_split → less-or-doc-tie ("lt_tie")
      split > m_split  → less-or-equal ("le")

    String markers (text-field sorts): internal keys are SPLIT-LOCAL
    dictionary ordinals, so the raw term string translates per split via
    binary search in the column dict; a term absent from this split maps
    to the half-ordinal between its neighbors (f64 keys compare exactly),
    with tie relations impossible by construction.
    """
    if not request.search_after:
        return None
    sa = list(request.search_after)
    if sort2 is not None and len(sa) == 4:
        raw, raw2, m_split, m_doc = sa[0], sa[1], sa[2], host_int(sa[3])
    else:
        raw, raw2, m_split, m_doc = sa[0], None, sa[1], host_int(sa[2])
    if m_split is not None:
        m_split = str(m_split)

    string_sort = (string_sort_of(request, doc_mapper)
                   if doc_mapper is not None else None)

    def encode_string(value: str, order: str) -> float:
        terms = reader.column_dict(sort_field)
        index = bisect.bisect_left(terms, value)
        if index < len(terms) and terms[index] == value:
            ordinal = host_float(index)     # exact: tie relations apply
        else:
            ordinal = index - 0.5           # between neighbors: no ties
        return ordinal if order == "desc" else -ordinal

    def encode(value, field, order):
        if value is None:
            return MISSING_VALUE_SENTINEL
        if string_sort is not None and field == sort_field \
                and isinstance(value, str):
            return encode_string(value, order)
        return (host_float(value) if order == "desc"
                else -host_float(value))

    internal = encode(raw, sort_field, sort_order)
    internal2 = (encode(raw2, sort2.field, sort2.order)
                 if sort2 is not None else None)
    if m_split is None or split_id < m_split:
        # a value-only marker is strictly after the value in every split
        relation = "lt"
    elif split_id == m_split:
        relation = "lt_tie"
    else:
        relation = "le"
    return (internal, internal2, relation, m_doc)


def _sort_values_are_int(doc_mapper: DocMapper, sort_field: str) -> bool:
    fm = doc_mapper.field(sort_field)
    return fm is not None and fm.type in (
        FieldType.I64, FieldType.U64, FieldType.DATETIME, FieldType.BOOL, FieldType.IP)


def _truncate_terms_state(state: dict[str, Any]) -> None:
    """Per-split `split_size` truncation (reference/tantivy shard_size
    semantics): forward only the top-N buckets by count; the largest
    dropped count becomes this split's doc_count_error_upper_bound
    contribution (error bounds sum at merge)."""
    counts = host_array(state["counts"])
    split_size = host_int(state["split_size"])
    nonzero = host_int((counts > 0).sum())
    if nonzero <= split_size:
        state["error_bound"] = 0
        return
    order = np.argsort(-counts, kind="stable")
    dropped_max = host_int(counts[order[split_size]])
    kept = np.zeros_like(counts)
    kept_idx = order[:split_size]
    kept[kept_idx] = counts[kept_idx]
    state["error_bound"] = dropped_max
    # ES/tantivy compute sum_other_doc_count from the FULL per-split doc
    # total, not just forwarded buckets — carry the dropped mass
    state["other_docs"] = host_int(counts.sum() - kept.sum())
    state["counts"] = kept


def _sub_state(child, res) -> dict[str, Any]:
    """Mergeable state of one nested bucket child: counts/metrics over
    the FLATTENED (ancestor-radix) space, plus its own children."""
    state = {
        "name": child.name,
        "kind": "terms" if child.kind == "terms_mv" else child.kind,
        "nb": child.num_buckets,
        "counts": host_array(res["counts"]),
        "metrics": {name: {k: host_array(v) for k, v in m.items()}
                    for name, m in res["metrics"].items()},
        "metric_kinds": {m.name: m.kind for m in child.metrics},
        "metric_percents": {m.name: list(m.percents) for m in child.metrics
                            if m.kind == "percentiles"},
        "metric_keyed": {m.name: m.keyed for m in child.metrics},
        **child.host_info,
    }
    if child.subs and "subs" in res:
        state["subs"] = [_sub_state(grandchild, grand_res)
                        for grandchild, grand_res
                        in zip(child.subs, res["subs"])]
    return state


def _intermediate_aggs(plan, agg_results: list) -> dict[str, Any]:
    """Device outputs + host_info → the mergeable intermediate agg states
    (role of the reference's serialized intermediate aggregation results)."""
    out: dict[str, Any] = {}
    for a, res in zip(plan.aggs, agg_results):
        if isinstance(a, BucketAggExec):
            state: dict[str, Any] = {
                # terms_mv is an execution detail; the mergeable state is a
                # plain terms state (counts over the ordinal space)
                "kind": "terms" if a.kind == "terms_mv" else a.kind,
                "counts": host_array(res["counts"]),
                "metrics": {name: {k: host_array(v) for k, v in m.items()}
                            for name, m in res["metrics"].items()},
                "metric_kinds": {m.name: m.kind for m in a.metrics},
                "metric_percents": {m.name: list(m.percents) for m in a.metrics
                                    if m.kind == "percentiles"},
                "metric_keyed": {m.name: m.keyed for m in a.metrics},
                **a.host_info,
            }
            if (a.kind == "terms" and state.get("split_size")
                    and state.get("order_target", "_count") == "_count"):
                # split_size truncation keeps top-N by count — unsound
                # under _key/metric ordering (the globally-first bucket
                # could rank low by count in every split), so those
                # orders forward exact per-split states instead
                _truncate_terms_state(state)
            if a.subs and "subs" in res:
                state["subs"] = [_sub_state(child, child_res)
                                 for child, child_res
                                 in zip(a.subs, res["subs"])]
            out[a.name] = state
        elif isinstance(a, CompositeAggExec):
            run_keys = host_array(res["run_keys"])       # [S, k_runs]
            counts = host_array(res["counts"])
            src_infos = a.host_info["sources"]
            metric_kinds = a.host_info.get("metric_kinds", {})
            res_metrics = {name: {k: host_array(v) for k, v in m.items()}
                           for name, m in res.get("metrics", {}).items()}
            buckets = []
            for j in range(run_keys.shape[1]):
                if counts[j] <= 0:
                    continue
                values = []
                for si, info in enumerate(src_infos):
                    enc = host_int(run_keys[si, j])
                    if enc == 0:
                        values.append(None)
                        continue
                    idx = enc // 2 - 1
                    if info["kind"] == "terms":
                        values.append(info["keys"][idx])
                    else:  # histogram kinds decode to absolute keys
                        values.append(info["origin"] + idx * info["interval"])
                entry = [values, host_int(counts[j])]
                if res_metrics or a.subs:
                    entry.append({
                        name: {k: (host_float(v[j]) if k != "count"
                                   else host_int(v[j]))
                               for k, v in state.items()}
                        for name, state in res_metrics.items()})
                if a.subs:
                    # run index: the collector decodes this bucket's
                    # children out of the flattened child states below
                    entry.append(j)
                buckets.append(entry)
            state_out = {
                "kind": "composite", "buckets": buckets,
                "size": a.host_info["size"],
                "metric_kinds": dict(metric_kinds),
                "sources": [{"name": i["name"], "kind": i["kind"]}
                            for i in src_infos],
            }
            if a.subs and "subs" in res:
                state_out["subs"] = [
                    _sub_state(child, child_res)
                    for child, child_res in zip(a.subs, res["subs"])]
            out[a.name] = state_out
        elif isinstance(a, MetricAggExec):
            met = a.metric
            if met.kind == "percentiles":
                out[a.name] = {"kind": "percentiles",
                               "sketch": host_array(res["sketch"]),
                               "percents": list(met.percents),
                               "keyed": met.keyed}
            elif met.kind == "cardinality":
                out[a.name] = {"kind": "cardinality",
                               "hll": host_array(res["hll"])}
            else:
                out[a.name] = {"kind": met.kind, "state": host_array(res["stats"])}
    return out
