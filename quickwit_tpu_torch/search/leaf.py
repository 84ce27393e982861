"""Leaf search: one split, end to end on the device.

Role of the reference's `leaf_search_single_split` (`quickwit-search/src/
leaf.rs:657`): lower the query against the split, stage exactly the arrays
the plan needs on the device, run the leaf program, and emit a mergeable
`LeafSearchResponse`.

Counterpart of the JAX package's `search/leaf.py`. Staged arrays are cached
per reader and per device by default; the node's search service
(`search/service.py`) passes an `HbmBudget` and a `ResidentColumnStore`
instead, so staging is admitted byte-exactly and residency is keyed by
split id. Work that spans two chunks at the configured span (or the
adaptive sizer's) runs as a resumable chunked scan (`search/chunkexec.py`):
cancellable, preemptable and early-terminable at every chunk boundary,
each chunk through the same `execute_plan`. With a `QueryBatcher`
(`search/batcher.py`), concurrent queries on one split share one dispatch:
shape-compatible distinct queries stack into one lane group, or, under
`QW_DISABLE_QBATCH`, same-array queries ride a convoy. The multi-split
batch is `parallel/fanout.py`'s, and leaf offload is the service's
(`search/service.py`).
`search_after` markers (numeric and string, one or two keys), the top-k
threshold pushdown, a cached predicate mask (`mask_override`) and a subset
of the aggregations (`aggs_override`) reach the device program through
`prepare_plan_only`.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import sync
from ..common.deadline import current_deadline
from ..models.doc_mapper import DocMapper, FieldType
from ..index.reader import SplitReader
from ..observability.metrics import (
    PREDICATE_STAGED_BYTES_TOTAL, SEARCH_KERNEL_THRESHOLD_TOTAL,
    STAGING_BYTES_TOTAL,
)
from ..observability.profile import (
    PHASE_PLAN_BUILD, PHASE_STAGING_CACHE_HIT, PHASE_STAGING_UPLOAD,
    PHASE_TOPK_MERGE, current_profile, profile_add, profiled_phase,
)
from ..query.aggregations import parse_aggs
from ..tenancy.context import effective_tenant
from .batcher import qbatch_enabled
from .chunkexec import PREEMPT_GATE, maybe_execute_chunked
from .executor import execute_plan
from .models import (LeafSearchResponse, PartialHit, SearchRequest,
                     SplitSearchError, string_sort_of)
from .plan import (BucketAggExec, CompositeAggExec, MetricAggExec,
                   lower_request, predicate_only_slots)
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


class _ReaderArrays:
    """The arrays one reader staged on one device: the `HbmBudget` owner of
    the default per-reader cache. It lives as long as its reader, so that
    residency dies with the reader as in the JAX package's per-reader
    cache."""

    __slots__ = ("_device_array_cache", "staging_lock", "__weakref__")

    def __init__(self):
        self._device_array_cache: dict[str, torch.Tensor] = {}
        self.staging_lock = sync.lock("_ReaderArrays.staging_lock")


def _reader_arrays(reader: SplitReader, device: torch.device) -> _ReaderArrays:
    # setdefault is one dict operation: two threads warming one reader
    # agree on the owner
    owners = vars(reader).setdefault("_torch_device_arrays", {})
    return owners.get(str(device)) or owners.setdefault(str(device),
                                                        _ReaderArrays())


def _pinned_owner(reader, dev, budget, store, split_id):
    """The owner of the arrays a warmup serves, pinned in `budget` (when
    given) BEFORE its cache is read: an eviction between the lookup and the
    admission would otherwise clear keys the lookup counted as resident. A
    split's store owner evicted just before the pin is replaced in the
    store, so the pin moves to the new one."""
    while True:
        if store is not None and split_id is not None:
            owner = store.columns_for(split_id)
        else:
            owner = _reader_arrays(reader, dev)
        if budget is None:
            return owner
        budget.admit(owner, 0)
        if store is None or split_id is None or \
                store.peek(split_id) is owner:
            return owner
        budget.release(owner, 0, to_resident=False)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _stage(missing: dict, cache: dict, dev: torch.device) -> None:
    """Pack `missing` ({key: host array}) into one host buffer (pinned for
    a GPU) that crosses in ONE non-blocking copy on the current stream;
    each array becomes a typed view of the device buffer, which is freed
    when its last view dies."""
    offsets = []
    total = 0
    for arr in missing.values():
        offsets.append(total)
        total += -(-arr.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    host_np = host.numpy()
    for arr, off in zip(missing.values(), offsets):
        host_np[off: off + arr.nbytes] = arr.reshape(-1).view(np.uint8)
    staged = host.to(dev, non_blocking=True) if dev.type != "cpu" else host
    for (key, arr), off in zip(missing.items(), offsets):
        view = staged[off: off + arr.nbytes].view(_torch_dtype(arr.dtype))
        cache[key] = view.reshape(arr.shape)


def warmup_device_arrays(reader: SplitReader, plan, budget=None, store=None,
                         split_id: Optional[str] = None, device=None
                         ) -> tuple[list, int, Any]:
    """Host→device transfer of the plan's arrays, with cross-query reuse
    (role of `warmup`, `leaf.rs:304`). Arrays not yet on the device are
    packed into one host buffer and cross in ONE non-blocking copy.

    With an `HbmBudget`, the bytes this call will stage are admitted
    (blocking while over budget) BEFORE the copy. With a
    `ResidentColumnStore` (`store` + `split_id`), residency keys on the
    split id: the `SplitColumns` owner survives reader reopens, and a warm
    repeat query copies nothing (profiled as `staging_cache_hit`).
    Without a store, arrays are cached per reader and device, and residency
    dies with the reader. The store and budget must belong to `device`.

    Returns (device arrays in slot order, bytes staged by this call, owner).
    With a budget the staged bytes are the admitted bytes, and the caller
    releases `owner` (not necessarily the reader) after execution. The
    list holds plain references, so a concurrent LRU eviction clearing the
    cache cannot free what this query's program reads."""
    dev = resolve_device(device)
    owner = _pinned_owner(reader, dev, budget, store, split_id)
    admitted = 0
    try:
        if budget is not None:
            # the bytes are admitted OUTSIDE the owner's staging lock, so
            # a warmup queued for budget never stalls a warm query of the
            # same split; the cache is read again once they are granted
            while True:
                with owner.staging_lock:
                    need = sum(a.nbytes for a in
                               _missing(plan, owner._device_array_cache)
                               .values())
                admitted = budget.admit(owner, need)
                with owner.staging_lock:
                    missing = _missing(plan, owner._device_array_cache)
                    staging_bytes = sum(a.nbytes for a in missing.values())
                    if staging_bytes <= admitted:
                        # this admission pins the owner while its arrays
                        # are in use, also at zero bytes; the lookup's pin
                        # goes, with the bytes a concurrent warmup staged
                        # meanwhile
                        budget.release(owner, admitted - staging_bytes,
                                       to_resident=False)
                        admitted = staging_bytes
                        return _stage_missing(plan, owner, missing,
                                              staging_bytes, dev, store,
                                              split_id)
                # keys went while this one queued: give the bytes back
                # (the lookup's pin stays) and admit what is missing now
                budget.release(owner, admitted, to_resident=False)
                admitted = 0
        # one warmup per owner at a time: a second one waits and finds the
        # first one's arrays, instead of staging them again
        with owner.staging_lock:
            missing = _missing(plan, owner._device_array_cache)
            return _stage_missing(plan, owner, missing,
                                  sum(a.nbytes for a in missing.values()),
                                  dev, store, split_id)
    except BaseException:
        if budget is not None:
            # this warmup's pin, and its bytes once admitted
            budget.release(owner, admitted, to_resident=False)
        raise


def _missing(plan, cache: dict) -> dict:
    # a key that repeats across slots is staged once
    return {key: np.ascontiguousarray(arr)
            for key, arr in zip(plan.array_keys, plan.arrays)
            if key not in cache}


def _stage_missing(plan, owner, missing: dict, staging_bytes: int, dev,
                   store, split_id) -> tuple[list, int, Any]:
    """Stage `missing` into `owner`'s cache (the caller holds its staging
    lock); returns `warmup_device_arrays`' triple."""
    cache = owner._device_array_cache
    if missing:
        STAGING_BYTES_TOTAL.inc(staging_bytes)
        # predicate-only attribution: the bytes a mask-cache hit avoids
        pred_keys = {plan.array_keys[slot]
                     for slot in predicate_only_slots(plan)}
        predicate_bytes = sum(arr.nbytes for key, arr in missing.items()
                              if key in pred_keys)
        if predicate_bytes:
            PREDICATE_STAGED_BYTES_TOTAL.inc(predicate_bytes)
            profile_add("predicate_staging_bytes", predicate_bytes)
        # the phase times the copy's DISPATCH: it is non-blocking and
        # completes in stream order before the program reads it
        with profiled_phase(PHASE_STAGING_UPLOAD) as rec:
            if rec is not None:
                rec["bytes"] = staging_bytes
                rec["arrays"] = len(missing)
            _stage(missing, cache, dev)
        profile_add("staging_bytes", staging_bytes)
        if store is not None and split_id is not None:
            store.note_upload(split_id, staging_bytes, len(missing))
            store.note_hits(sum(1 for key in plan.array_keys
                                if key not in missing), full=False)
    else:
        # the whole plan is device-resident: no transfer, no staging — the
        # phase records the skip (bytes served, none moved)
        with profiled_phase(PHASE_STAGING_CACHE_HIT) as rec:
            if rec is not None:
                rec["bytes"] = 0
                rec["bytes_resident"] = sum(a.nbytes for a in plan.arrays)
                rec["arrays"] = len(plan.array_keys)
        if store is not None and split_id is not None:
            store.note_hits(len(plan.array_keys), full=True)
    return [cache[key] for key in plan.array_keys], staging_bytes, owner


def prepare_plan_only(
    request: SearchRequest,
    doc_mapper: DocMapper,
    reader: SplitReader,
    split_id: str,
    absence_sink=None,
    sort_value_threshold: Optional[float] = None,
    aggs_override: Optional[dict] = None,
    mask_override=None,
    mask_key: Optional[str] = None,
):
    """Storage byte-range IO + plan lowering, without the device transfer.
    The service's per-split path defers staging to the execute stage so
    each split's admit→transfer→execute→release cycle runs alone.

    `sort_value_threshold` (internal higher-is-better key) is pushed into
    the plan as a scalar masking sub-threshold docs before top-k.
    `absence_sink(field, term)` hears of every term the split lacks (the
    predicate cache's negative entries). `aggs_override` replaces the
    request's aggregations: the partial-agg tier passes only those it
    missed ({} lowers none). `mask_override`/`mask_key` forward a packed
    predicate mask (from `executor.compute_packed_mask`, of either engine)
    to `lower_request`, which then skips query lowering and every predicate
    column."""
    aggs_dict = request.aggs if aggs_override is None else aggs_override
    agg_specs = parse_aggs(aggs_dict) if aggs_dict else []
    sort = request.sort_fields[0] if request.sort_fields else None
    sort_field = sort.field if sort else "_score"
    sort_order = sort.order if sort else "desc"
    sort2 = request.sort_fields[1] if len(request.sort_fields) > 1 else None
    # plan_build covers storage byte-range IO plus the lowering itself
    with profiled_phase(PHASE_PLAN_BUILD) as rec:
        if rec is not None:
            rec["split_id"] = split_id
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
            absence_sink=absence_sink,
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
    device_arrays, staged, _owner = warmup_device_arrays(reader, plan,
                                                         device=device)
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
    threshold_box=None,
    fault_injector=None,
    batcher=None,
) -> LeafSearchResponse:
    """Stage 2: the leaf program and its single packed readback, decoded
    into hits and mergeable aggregation states. Work that spans two chunks
    runs as a resumable chunked scan instead (search/chunkexec.py):
    cancellable and preemptable at every chunk boundary, with cross-chunk
    early termination and threshold tightening fed by `threshold_box`;
    `fault_injector` reaches its `kernel.chunk_yield` and
    `kernel.preempt_park` points. A scan cancelled mid-split answers with
    the chunks it merged and a non-retryable cancel failure.

    With a `QueryBatcher`, concurrent queries on this split share one
    dispatch (search/batcher.py). With stacking on, the query enters the
    batcher BEFORE the chunked check, so distinct shape-compatible queries
    can group; a solo rider and a formed group both keep the resumable
    chunked scan inside the batcher. Under `QW_DISABLE_QBATCH` the chunked
    check comes first and only unchunked work rides a convoy."""
    ambient = current_deadline()
    if ambient is not None:
        # shed before launching a program whose result nobody can use; the
        # service turns this into a typed, retryable SplitSearchError
        ambient.check(f"leaf split {split_id} execute")
    t0 = time.monotonic()
    sort = request.sort_fields[0] if request.sort_fields else None
    sort_field = sort.field if sort else "_score"
    sort_order = sort.order if sort else "desc"
    sort2 = request.sort_fields[1] if len(request.sort_fields) > 1 else None
    # k=0 (count/agg-only): the executor skips keying and top-k entirely
    k = request.start_offset + request.max_hits
    if plan.threshold_slot >= 0:
        SEARCH_KERNEL_THRESHOLD_TOTAL.inc()
        profile_add("kernel_threshold_pushdowns")
    # fused splits register with the preempt gate too: their presence is
    # what tells a running chunked scan that higher-class work is waiting
    with PREEMPT_GATE.running(effective_tenant().priority):
        if batcher is not None and qbatch_enabled():
            result = batcher.execute(plan, k, device_arrays,
                                     split_key=id(reader),
                                     threshold_box=threshold_box,
                                     fault_injector=fault_injector,
                                     device=device)
        else:
            result = maybe_execute_chunked(plan, k, device_arrays, device,
                                           threshold_box=threshold_box,
                                           fault_injector=fault_injector)
            if result is None:
                if batcher is not None:
                    result = batcher.execute(plan, k, device_arrays,
                                             split_key=id(reader),
                                             device=device)
                else:
                    result = execute_plan(plan, k, device_arrays, device)
    # cancelled mid-scan with partial_on_cancel: keep the chunks already
    # merged, and flag the split so the response carries the cancel
    partial_cancel = bool(result.get("partial"))

    count = result["count"]
    if getattr(plan, "count_override", None) is not None:
        # impact prefix cutoff (plan.py): the kernel only saw the live
        # prefix of a single bare term's postings, so its count is a
        # truncation artifact — the exact match count is the term's df
        count = plan.count_override
    profile = current_profile()
    t_merge = time.perf_counter()
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
    if profile is not None:
        # host-side top-K decode + agg-state extraction for this split
        profile.record_phase(PHASE_TOPK_MERGE,
                             time.perf_counter() - t_merge, start=t_merge,
                             split_id=split_id, hits=len(partial_hits))
    elapsed = int((time.monotonic() - t0) * 1e6)
    return LeafSearchResponse(
        num_hits=count,
        partial_hits=partial_hits,
        # a partial-on-cancel split still counts as successful (its hits
        # are real and mergeable); the cancel failure is what marks the
        # response cancelled without tripping the every-split-failed guard
        num_attempted_splits=1,
        num_successful_splits=1,
        failed_splits=([SplitSearchError(
            split_id=split_id,
            error="query cancelled: progressive partial results up to the "
                  "last completed chunk boundary",
            retryable=False)] if partial_cancel else []),
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
