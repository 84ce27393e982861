"""Multi-split execution on one device: a leaf's splits as one dispatch.

Counterpart of the JAX package's `parallel/fanout.py`, its single-device
half (role of the reference's per-node leaf batches merged by the
`IncrementalCollector`, SURVEY.md §2.3). `build_batch` lowers one request
against every split of a batch with batch-global bucket spaces, so their
aggregation states merge by position; `dispatch_batch` runs the splits'
programs and the cross-split merge on the device, and `readback_batch`
reads the merged result back in ONE copy and decodes it into one
`LeafSearchResponse` for all the splits.

The JAX package stacks the splits' arrays into [n, ...] operands, pads
them to uniform lengths and runs one `vmap`ped program. The port has no
`vmap` over its programs (they read host scalars and launch the kernel
through ctypes: search/executor.py), so a batch is a lane group, one lane
per split, as a stacked query group is (PR 8's lane machinery):

- each lane runs its own split's program over that split's own staged
  tensors and scalars: no operand is stacked or padded into a copy, so a
  warm batch stages 0 bytes and, through the node's service, shares the
  per-split route's one resident copy of each split;
- where the template takes the fused kernel, the batch's fused steps are
  `score_topk_lanes` launches of at most MAX_LANES splits each, the
  counterpart of the Pallas call under the JAX `vmap`;
- each lane's top-k selects over as many lanes as the JAX stacked program
  would (`executor._widen`: the batch's longest posting list, or its
  padded doc count), so every lane hands the merge the same [kk] winners;
- the cross-split merge runs on the device: the lanes' winners
  concatenated split-major and re-ranked (`exact_topk` ranks like
  `lax.top_k`, `exact_topk_2key` like the two-key `lax.sort`), so ties
  break by (key desc, split asc, doc asc) as the collector's order does;
  the counts summed and the aggregation states combined by
  `_merge_agg_stack`. A pad split (`pad_to_splits`) runs nothing and
  offers -inf candidates.

The JAX readback re-runs a batch whose guided top-k could not certify its
answer (`topk_safe == 0`). The port runs `exact_topk`, whose `topk_safe` is
always 1, so that branch has no counterpart here. The mesh half (the
`torch.distributed` collectives) comes with a later slice.

A query group (`dispatch_query_group`) is Q batches over one split set as
Q x n lanes in one dispatch, each query with its own cross-split merge.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common.clock import monotonic as _clock_monotonic
from ..common.deadline import check_cancelled
from ..index.reader import SplitReader
from ..models.doc_mapper import DocMapper
from ..observability import flight
from ..observability.metrics import (
    QBATCH_GROUPS_TOTAL, QBATCH_MASKED_RIDERS_TOTAL,
    QBATCH_QUERIES_PER_DISPATCH, QBATCH_SHARED_BYTES_AVOIDED_TOTAL,
    SEARCH_KERNEL_LAUNCHES_TOTAL, SEARCH_KERNEL_THRESHOLD_TOTAL,
    STAGING_BYTES_TOTAL,
)
from ..observability.profile import (
    PHASE_EXECUTE, PHASE_PLAN_BUILD, PHASE_STAGING_CACHE_HIT,
    PHASE_STAGING_UPLOAD, PHASE_TOPK_MERGE, profile_add, profiled_phase,
)
from ..ops import topk as topk_ops
from ..ops.kernels.build import KernelError
from ..ops.kernels.score_topk import MAX_LANES, score_topk_lanes
from ..query.aggregations import (
    CompositeAgg, DateHistogramAgg, HistogramAgg, TermsAgg, parse_aggs,
)
from ..search import executor as ex
from ..search import leaf as leaf_mod
from ..search.leaf import (
    _intermediate_aggs, _sort_values_are_int, decode_sort_value_exact,
)
from ..search.models import LeafSearchResponse, PartialHit, SearchRequest
from ..search.plan import (
    MAX_BUCKETS, LoweredPlan, PlanError, lower_request,
    ordinalize_numeric_column,
)


def is_device_fault(exc: BaseException) -> bool:
    """True for a fault of the device path: a kernel that would not build
    or launch, device memory exhausted, a CUDA error. The node's service
    re-raises these from its batch route; it reruns a group split by split
    only for the reasons the JAX service does (a query that does not lower
    uniformly, mixed column packings)."""
    faults = (KernelError, torch.OutOfMemoryError)
    accelerator = getattr(torch, "AcceleratorError", None)
    if accelerator is not None:
        faults += (accelerator,)
    return isinstance(exc, faults) or (
        isinstance(exc, RuntimeError)
        and str(exc).startswith(("CUDA error", "CUDA out of memory")))


# --------------------------------------------------------------------------

@dataclass
class SplitBatch:
    """One request lowered against several splits of one doc mapping."""
    template: LoweredPlan          # structure donor, at the batch's padding
    plans: list[LoweredPlan]       # one per real split, in split order
    split_ids: list[str]           # n entries ("" = padding split)
    num_docs_padded: int           # uniform padded doc count (the largest)
    doc_mapper: DocMapper
    sort_field: str
    sort_order: str
    sort2_field: Optional[str] = None     # secondary sort key (2-key sorts)
    sort2_order: str = "desc"
    readers: list[SplitReader] = None  # for exact int sort-value re-reads

    @property
    def n_splits(self) -> int:
        return len(self.split_ids)


def _global_agg_overrides(agg_specs, readers: list[SplitReader],
                          doc_mapper: DocMapper) -> dict:
    """Compute batch-global bucket spaces so per-split states merge on device."""
    histograms: dict[str, tuple[int, int]] = {}
    terms_dicts: dict[str, dict] = {}
    terms_cards: dict[str, int] = {}
    terms_keys: dict[str, list] = {}
    # nested child buckets need batch-global spaces too (their per-split
    # ordinal/origin spaces would otherwise be summed incoherently on
    # device); children key under "parent>child" since ES names are only
    # unique per level
    expanded: list = []

    def _expand(spec, path):
        if isinstance(spec, CompositeAgg):
            # composite is per-split by design (split-local key
            # encodings) — lowering raises before any override is read,
            # so computing cross-reader dictionaries here is pure waste
            return
        expanded.append((spec, path))
        for sub in getattr(spec, "sub_buckets", ()):
            _expand(sub, f"{path}>{sub.name}")

    for spec in agg_specs:
        _expand(spec, spec.name)
    for spec, override_key in expanded:
        if isinstance(spec, (DateHistogramAgg, HistogramAgg)):
            vmins, vmaxs = [], []
            for r in readers:
                meta = r.field_meta(spec.field)
                if meta.get("min_value") is not None:
                    vmins.append(meta["min_value"])
                    vmaxs.append(meta["max_value"])
            if isinstance(spec, DateHistogramAgg) and spec.extended_bounds:
                vmins.append(spec.extended_bounds[0])
                vmaxs.append(spec.extended_bounds[1])
            if not vmins:
                histograms[override_key] = (0, 1)
                continue
            interval = spec.interval_micros if isinstance(spec, DateHistogramAgg) \
                else spec.interval
            if isinstance(spec, DateHistogramAgg):
                offset = getattr(spec, "offset_micros", 0)
                origin = ((min(vmins) - offset) // interval) * interval \
                    + offset
            else:
                origin = float(np.floor(min(vmins) / interval) * interval)
            num_buckets = int((max(vmaxs) - origin) // interval) + 1
            if num_buckets > MAX_BUCKETS:
                raise PlanError(
                    f"aggregation {spec.name!r} would create {num_buckets} "
                    f"buckets over the batch (max {MAX_BUCKETS})")
            histograms[override_key] = (origin if isinstance(spec, HistogramAgg)
                                        else int(origin), num_buckets)
        elif isinstance(spec, TermsAgg):
            union: set = set()
            for r in readers:
                meta = r.field_meta(spec.field)
                if meta.get("column_kind") == "ordinal":
                    union.update(r.column_dict(spec.field))
                else:
                    _, keys = ordinalize_numeric_column(r, spec.field)
                    union.update(keys)
            keys_sorted = sorted(union, key=lambda v: (str(type(v)), v))
            terms_dicts[spec.field] = {k: i for i, k in enumerate(keys_sorted)}
            terms_cards[spec.field] = len(keys_sorted)
            terms_keys[spec.field] = keys_sorted
    return {"histograms": histograms, "terms_dicts": terms_dicts,
            "terms_cards": terms_cards, "terms_keys": terms_keys}


def build_batch(request: SearchRequest, doc_mapper: DocMapper,
                readers: list[SplitReader], split_ids: list[str],
                pad_to_splits: Optional[int] = None,
                absence_sink=None,
                sort_value_threshold: Optional[float] = None) -> SplitBatch:
    """`absence_sink(split_id, field, term)`: term-dictionary misses found
    during lowering, fed to the predicate/negative cache.

    `sort_value_threshold` is the batch-wide dynamic top-K threshold
    (internal encoding): the same value is lowered into every lane's plan,
    so slot layouts stay uniform. Host only: lowering touches no device
    tensor, so a prefetch worker may build the next batch while this one
    runs."""
    # plan_build covers per-split lowering (storage byte-range IO surfaces
    # as storage_read_* counters) plus the uniformity checks
    with profiled_phase(PHASE_PLAN_BUILD) as rec:
        if rec is not None:
            rec["splits"] = len(split_ids)
            rec["stage"] = "batch"
        return _build_batch(request, doc_mapper, readers, split_ids,
                            pad_to_splits, absence_sink, sort_value_threshold)


def _build_batch(request: SearchRequest, doc_mapper: DocMapper,
                 readers: list[SplitReader], split_ids: list[str],
                 pad_to_splits: Optional[int],
                 absence_sink,
                 sort_value_threshold: Optional[float]) -> SplitBatch:
    agg_specs = parse_aggs(request.aggs) if request.aggs else []
    overrides = _global_agg_overrides(agg_specs, readers, doc_mapper)
    # a term absent from one split lowers to the uniform empty stand-in,
    # whose impact_ordered flag is part of the plan sig since format v3:
    # the stand-in must agree with the splits that DO hold the field
    overrides["batch_readers"] = readers
    sort = request.sort_fields[0] if request.sort_fields else None
    sort_field = sort.field if sort else "_score"
    sort_order = sort.order if sort else "desc"
    sort2 = request.sort_fields[1] if len(request.sort_fields) > 1 else None

    num_docs_padded = max(r.num_docs_padded for r in readers)
    plans: list[LoweredPlan] = []
    for reader, split_id in zip(readers, split_ids, strict=True):
        plan = lower_request(
            request.query_ast, doc_mapper, reader, agg_specs,
            sort_field=sort_field, sort_order=sort_order,
            sort2_field=sort2.field if sort2 else None,
            sort2_order=sort2.order if sort2 else "desc",
            start_timestamp=request.start_timestamp,
            end_timestamp=request.end_timestamp,
            batch_overrides=overrides,
            absence_sink=(None if absence_sink is None else
                          lambda f, t, s=split_id: absence_sink(s, f, t)),
            sort_value_threshold=sort_value_threshold,
        )
        plans.append(plan)
    sigs = {p.root.sig() + p.sort.sig() + ",".join(a.sig() for a in p.aggs)
            for p in plans}
    if len(sigs) != 1:
        raise ValueError(
            "query does not lower to a uniform structure across splits "
            "(wildcard/regex/phrase-prefix queries need per-split execution)")

    n = len(plans)
    total = pad_to_splits or n
    if total < n:
        raise ValueError(
            f"pad_to_splits={pad_to_splits} is smaller than the number of "
            f"splits ({n})")
    template = plans[0]
    for slot, key in enumerate(template.array_keys):
        dtype = template.arrays[slot].dtype
        if any(p.arrays[slot].dtype != dtype for p in plans[1:]):
            # e.g. FOR-packed lanes of different widths (u8 vs u16): the
            # lanes would compute alike, but the JAX batch refuses them and
            # its service searches such a group per split
            raise ValueError(
                f"array slot {key!r} has non-uniform dtypes across splits "
                "(mixed column packings need per-split execution)")
    for slot in range(len(template.scalars)):
        dtype = np.asarray(template.scalars[slot]).dtype
        if any(np.asarray(p.scalars[slot]).dtype != dtype for p in plans[1:]):
            raise ValueError(
                f"scalar slot {slot} has non-uniform dtypes across splits "
                "(mixed column packings need per-split execution)")
    ids = list(split_ids) + [""] * (total - n)
    return SplitBatch(
        # the template at the batch-uniform padded size, as the JAX
        # package retargets its template (lane 0 keeps its own)
        template=dc_replace(template, num_docs_padded=num_docs_padded),
        plans=plans, split_ids=ids, num_docs_padded=num_docs_padded,
        doc_mapper=doc_mapper, sort_field=sort_field, sort_order=sort_order,
        sort2_field=sort2.field if sort2 else None,
        sort2_order=sort2.order if sort2 else "desc",
        readers=list(readers),
    )


# --------------------------------------------------------------------------
# merged execution

# lane program key -> {device: program}; lanes of one signature share one
_LANE_PROGRAMS: dict[tuple, dict[str, Any]] = {}
ex.PROGRAM_CACHES.append(_LANE_PROGRAMS)


def _merge_agg_stack(trees: list):
    """The lanes' agg state trees (one per split, equal structure) → one
    tree, each leaf combined over the lanes by the name of its nearest
    dict key: counts and sums add, min/max combine (HLL registers by max),
    and a stats vector [count, sum, sum_sq, min, max] adds its first three.
    Integer sums widen as the JAX `jnp.sum` does (int32 → int64)."""
    def red(name, leaves):
        stacked = torch.stack(leaves)
        if name == "min":
            return stacked.amin(0)
        if name in ("max", "hll"):
            return stacked.amax(0)
        if name == "stats":
            return torch.cat([stacked[:, :3].sum(0), stacked[:, 3:4].amin(0),
                              stacked[:, 4:5].amax(0)])
        return stacked.sum(0)

    def walk(nodes, name):
        first = nodes[0]
        if isinstance(first, torch.Tensor):
            return red(name, nodes)
        if isinstance(first, dict):
            return {key: walk([node[key] for node in nodes], key)
                    for key in first}
        if isinstance(first, (list, tuple)):
            return type(first)(walk([node[i] for node in nodes], name)
                               for i in range(len(first)))
        return None

    return walk(trees, None)


def _lane_width(batch: SplitBatch) -> int:
    """How many lanes each split's top-k selects over: the length of the
    JAX stacked program's operand, the batch's longest posting list for a
    posting-space plan and the batch's padded doc count otherwise."""
    t = batch.template
    if ex._posting_space_eligible(t):
        return max(p.arrays[t.root.ids_slot].shape[0] for p in batch.plans)
    return batch.num_docs_padded


def _merge_lanes(results: list, k: int, n_splits: int, dev):
    """The cross-split merge over the lanes' result trees (the real splits,
    in split order), as the JAX `batch_fn` merges its vmapped rows: one
    result tree (top values, top values 2 | None, split index, doc ids,
    hit scores, total count, topk_safe, merged agg states)."""
    total = torch.stack([r[4] for r in results]).sum()
    safe = torch.ones((), dtype=torch.float64, device=dev)
    merged_aggs = _merge_agg_stack([r[6] for r in results])
    if k == 0:  # count/agg-only: no cross-split hit merge
        empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
        return (torch.zeros(0, dtype=torch.float64, device=dev), None,
                empty_i, empty_i, torch.zeros(0, dtype=torch.float32,
                                              device=dev),
                total, safe, merged_aggs)
    kk = results[0][0].shape[0]
    # pad splits offer -inf candidates after the real ones, as their
    # all-invalid rows do in the JAX program
    pad = (n_splits - len(results)) * kk

    def flat(i, fill, dtype):
        parts = [r[i] for r in results]
        if pad:
            parts.append(torch.full((pad,), fill, dtype=dtype, device=dev))
        return torch.cat(parts)

    # split-major [n * kk]: equal keys keep split order, then rank order
    vals = flat(0, topk_ops.NEG_INF, torch.float64)
    width = min(k, vals.shape[0])
    if results[0][1] is None:
        top_vals, pos = topk_ops.exact_topk(vals, width)
        top_vals2 = None
    else:
        top_vals, top_vals2, pos = topk_ops.exact_topk_2key(
            vals, flat(1, topk_ops.NEG_INF, torch.float64), width)
    # a lane's winners span kk positions (the JAX program divides by k,
    # which kk equals unless k exceeds the batch's longest posting list)
    split_idx = torch.div(pos, kk, rounding_mode="floor").to(torch.int32)
    return (top_vals, top_vals2, split_idx, flat(2, 0, torch.int32)[pos],
            flat(3, 0.0, torch.float32)[pos], total, safe, merged_aggs)


def _fused_steps(lanes: list, k: int, width: int) -> dict:
    """The fused kernel's step for every lane whose plan takes it, in
    `score_topk_lanes` launches of at most MAX_LANES lanes: `lanes` holds
    (plan, arrays) per lane; returns lane index → (values, indices). Every
    posting list pads to at least POSTING_PAD = 128 (the absent-term
    stand-in too) and the fused k is at most 64, so each lane's kk is k."""
    if not lanes or not ex._takes_fused_kernel(lanes[0][0], k):
        return {}
    kk = min(k, width)
    fused: dict[int, tuple] = {}
    for lo in range(0, len(lanes), MAX_LANES):
        vals, idx = score_topk_lanes(
            [ex._fused_lane(plan, arrays, plan.scalars, plan.num_docs)
             for plan, arrays in lanes[lo:lo + MAX_LANES]], kk)
        for row in range(vals.shape[0]):
            fused[lo + row] = (vals[row], idx[row])
    return fused


def _run_lane(plan: LoweredPlan, arrays, k: int, dev, fused, width: int):
    fn = ex._program(_LANE_PROGRAMS, plan.signature(k), plan, k, dev)
    return fn(list(arrays), tuple(plan.scalars), int(plan.num_docs), fused,
              width=width)


def batch_fn(batch: SplitBatch, k: int):
    """The batch's device program: fn(lanes, device) → the merged result
    tree, `lanes[i]` being split i's staged arrays in slot order (as
    `stage_device_inputs` returns them). Exposed so measurement harnesses
    can run it on staged inputs; `dispatch_batch` packs and copies its
    output."""
    width = _lane_width(batch)

    def fn(lanes, dev):
        pairs = list(zip(batch.plans, lanes))
        fused = _fused_steps(pairs, k, width)
        results = [_run_lane(plan, arrays, k, dev, fused.get(i), width)
                   for i, (plan, arrays) in enumerate(pairs)]
        return _merge_lanes(results, k, batch.n_splits, dev)

    return fn


def batch_cache_key(batch: SplitBatch, k: int) -> tuple:
    """The JAX package's `_BATCH_JIT_CACHE` key for this batch without a
    mesh, post k-clamp (its last two fields: no mesh, not the exact
    re-run). The port keys its lane programs by each lane's own
    signature; this key names the batch's structure in the JAX package's
    terms."""
    k = min(k, batch.num_docs_padded)
    return (batch.template.signature(k), batch.n_splits,
            batch.num_docs_padded, None, False)


def per_device_bytes(batch: SplitBatch) -> int:
    """The bytes of device memory the batch's inputs take without a mesh:
    every real split's staged arrays (nothing is stacked or padded)."""
    return sum(a.nbytes for p in batch.plans for a in p.arrays)


def release_stack_pin(batch: SplitBatch, budget) -> None:
    """Release the admission pins `stage_device_inputs` took for the
    batch's lanes through a budget (one per split owner): the bytes stay
    RESIDENT in each split's owner for the next query, as the per-split
    route leaves them. Idempotent."""
    pins = vars(batch).pop("_lane_pins", None)
    for owner, admitted in pins or ():
        budget.release(owner, admitted)


def _stage_lanes(plans: list, dev, slots=None) -> list:
    """Stage the given array slots (all when None) of every plan in ONE
    packed non-blocking copy (`leaf._stage`); returns per-plan lists in
    slot order, None at unstaged slots, and the bytes copied."""
    missing: dict[tuple, np.ndarray] = {}
    for i, plan in enumerate(plans):
        for slot, arr in enumerate(plan.arrays):
            if slots is None or slot in slots:
                missing[(i, slot)] = np.ascontiguousarray(arr)
    staged: dict[tuple, torch.Tensor] = {}
    nbytes = sum(a.nbytes for a in missing.values())
    if missing:
        leaf_mod._stage(missing, staged, dev)
    return [[staged.get((i, slot)) for slot in range(len(plan.arrays))]
            for i, plan in enumerate(plans)], nbytes


def _stage_through_budget(batch: SplitBatch, dev, budget, store) -> tuple:
    """(lanes, bytes staged, slots already resident).

    Stages each lane through the per-split route's own warmup, so the
    batch and that route share one resident copy of each split and the
    budget's bytes stay equal to the store's. Each lane's owner is pinned
    first: a lane's admission then cannot evict a later lane's columns.
    A batch whose missing bytes exceed the whole budget would wait on its
    own pins, so it raises ValueError (the service searches it per
    split)."""
    pre_pins = []
    pins = []
    try:
        for plan, reader, split_id in zip(batch.plans, batch.readers,
                                          batch.split_ids):
            owner = leaf_mod._pinned_owner(reader, dev, budget, store,
                                           split_id if store else None)
            pre_pins.append(owner)
        need = missing = 0
        for plan, owner in zip(batch.plans, pre_pins):
            with owner.staging_lock:
                arrays = leaf_mod._missing(plan, owner._device_array_cache)
            need += sum(a.nbytes for a in arrays.values())
            missing += len(arrays)
        if need > budget.budget:
            raise ValueError(
                f"batch needs {need} new bytes against a {budget.budget}-"
                "byte budget (searched per split)")
        lanes, staged = [], 0
        for plan, reader, split_id in zip(batch.plans, batch.readers,
                                          batch.split_ids):
            arrays, admitted, owner = leaf_mod.warmup_device_arrays(
                reader, plan, budget, store=store,
                split_id=split_id if store else None, device=dev)
            pins.append((owner, admitted))
            lanes.append(arrays)
            staged += admitted
        vars(batch)["_lane_pins"] = pins
        return lanes, staged, sum(len(p.arrays) for p in batch.plans) \
            - missing
    except BaseException:
        for owner, admitted in pins:
            budget.release(owner, admitted)
        raise
    finally:
        for owner in pre_pins:
            budget.release(owner, 0, to_resident=False)


def stage_device_inputs(batch: SplitBatch, device=None, budget=None,
                        store=None) -> list:
    """The lanes' device arrays (`[split][slot]`), staged once per device
    and cached on the batch: a repeat of the same batch stages 0 bytes, as
    the JAX package caches `batch._device_inputs` per mesh.

    Without a budget the lanes' arrays cross in ONE packed copy. With the
    node's `HbmBudget` (and its `ResidentColumnStore`, when residency is
    on) each lane stages through `leaf.warmup_device_arrays` under its
    split id, pinned until `release_stack_pin`. Call it on the stream the
    dispatch runs on: the copy is ordered before the programs by that
    stream alone."""
    dev = resolve_device(device)
    cache = vars(batch).setdefault("_device_inputs", {})
    lanes = cache.get(str(dev))
    if lanes is not None:
        with profiled_phase(PHASE_STAGING_CACHE_HIT) as rec:
            if rec is not None:
                rec["bytes"] = 0
                rec["stage"] = "batch"
        flight.emit("staging.resident_hit", attrs={"stage": "batch"})
        return lanes
    resident_slots = 0
    if budget is not None:
        lanes, staged, resident_slots = _stage_through_budget(
            batch, dev, budget, store)
    else:
        with profiled_phase(PHASE_STAGING_UPLOAD) as rec:
            lanes, staged = _stage_lanes(batch.plans, dev)
            if rec is not None:
                rec["bytes"] = staged
                rec["stage"] = "batch"
        STAGING_BYTES_TOTAL.inc(staged)
        profile_add("staging_bytes", staged)
    if staged and flight.recording():
        flight.emit("staging.upload",
                    attrs={"bytes": staged, "resident_slots": resident_slots})
    elif not staged:
        flight.emit("staging.resident_hit", attrs={"stage": "batch"})
    cache[str(dev)] = lanes
    return lanes


class BatchDispatch:
    """A dispatched batch or query group: the host copy of its packed f64
    rows (pinned, filled asynchronously on a card), the event that marks
    the copy done, the rows' unpack spec, and what the decode needs."""

    __slots__ = ("host", "event", "spec", "batches", "k", "valid")

    def __init__(self, host, event, spec, batches, k: int, valid):
        self.host = host
        self.event = event
        self.spec = spec
        self.batches = batches
        self.k = k
        self.valid = valid


def _copy_out(rows: torch.Tensor, dev):
    """(host copy, event): on a card the copy goes to pinned memory on the
    current stream, recorded by an event; nothing synchronizes here."""
    if dev.type != "cuda":
        return rows, None
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


def dispatch_batch(batch: SplitBatch, request: SearchRequest,
                   device=None) -> BatchDispatch:
    """Async half of the batch: stage (or reuse) the lanes' inputs, run
    every split's program and the cross-split merge, and start the copy
    of the packed result; nothing synchronizes. `readback_batch` completes
    it, so the service can shed a deadline-expired query before the wait."""
    # cancelled queries stop HERE, before staging device inputs or paying
    # an enqueue nobody will read (the readback checks again)
    check_cancelled("batch dispatch")
    dev = resolve_device(device)
    # k=0 (count/agg-only): the lanes skip keying and top-k and the merge
    # skips the cross-split top-k
    k = min(request.start_offset + request.max_hits, batch.num_docs_padded)
    if batch.template.threshold_slot >= 0:
        # one dispatch, but each real lane's docs are threshold-masked
        SEARCH_KERNEL_THRESHOLD_TOTAL.inc(
            sum(1 for s in batch.split_ids if s))
    lanes = stage_device_inputs(batch, dev)
    if flight.recording():
        flight.emit("dispatch.launch",
                    attrs={"path": "batch", "splits": batch.n_splits,
                           "mesh": 0})
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    with profiled_phase(PHASE_EXECUTE) as rec:
        if rec is not None:
            rec["stage"] = "dispatch_batch"
        leaves: list[torch.Tensor] = []
        spec = ex._flatten(batch_fn(batch, k)(lanes, dev), leaves)
        packed = torch.cat([leaf.reshape(-1).to(torch.float64)
                            for leaf in leaves])
        host, event = _copy_out(packed, dev)
    return BatchDispatch(host, event, spec, [batch], k, [True])


def _await(dispatched: BatchDispatch, path: str) -> np.ndarray:
    t0 = _clock_monotonic() if flight.recording() else 0.0
    with profiled_phase(PHASE_EXECUTE) as rec:
        if rec is not None:
            rec["stage"] = "readback"
        if dispatched.event is not None:
            dispatched.event.synchronize()
        host = dispatched.host.numpy() if dispatched.host is not None \
            else None
    if flight.recording():
        flight.emit("dispatch.readback", attrs={
            "path": path,
            "dur_ms": round((_clock_monotonic() - t0) * 1000.0, 3)})
    return host


def abandon_dispatch(dispatched: BatchDispatch) -> None:
    """Deadline-shed seam: the dispatch flew but nobody will await its
    readback. A single device holds no collective guard, so nothing waits:
    the programs run out on the stream, and the host copy and the staged
    inputs are freed with their last reference, after the stream's work."""
    dispatched.host = dispatched.event = None


def readback_batch(dispatched: BatchDispatch) -> LeafSearchResponse:
    """Blocking half: await the one packed copy, unpack, host-decode the
    merged hits and aggregations."""
    # the dispatch already flew; a cancel landing in between still saves
    # the device->host wait
    check_cancelled("batch readback")
    host = _await(dispatched, "batch")
    top_vals, top_vals2, split_idx, doc_ids, scores, total, _safe, \
        merged_aggs = ex._unpack_result(host, dispatched.spec)
    return _decode_merged(dispatched.batches[0], dispatched.k, top_vals,
                          top_vals2, split_idx, doc_ids, scores, int(total),
                          merged_aggs)


def _decode_merged(batch: SplitBatch, k: int, top_vals, top_vals2,
                   split_idx, doc_ids, scores, num_hits: int,
                   merged_aggs) -> LeafSearchResponse:
    """Host decode of one merged (cross-split) result into a
    LeafSearchResponse — shared by the single-query batch readback and the
    per-lane unpack of a query-group readback."""
    hits: list[PartialHit] = []
    sort_is_int = _sort_values_are_int(batch.doc_mapper, batch.sort_field)
    sort2_is_int = (_sort_values_are_int(batch.doc_mapper, batch.sort2_field)
                    if batch.sort2_field else False)
    exact_cols: dict[tuple, Any] = {}

    def exact_col(si: int, field: str, is_int: bool):
        if not is_int or batch.readers is None:
            return None
        if (si, field) not in exact_cols:
            exact_cols[(si, field)] = \
                batch.readers[si].column_values(field)[0]
        return exact_cols[(si, field)]

    with profiled_phase(PHASE_TOPK_MERGE) as rec:
        for i in range(min(len(top_vals), num_hits)):
            internal = float(top_vals[i])
            if internal == float("-inf"):
                break
            si = int(split_idx[i])
            split_id = batch.split_ids[si]
            if split_id == "":
                continue
            doc_id = int(doc_ids[i])
            raw = decode_sort_value_exact(
                internal, batch.sort_field, batch.sort_order, sort_is_int,
                scores[i], doc_id,
                exact_col(si, batch.sort_field, sort_is_int))
            internal2, raw2 = 0.0, None
            if batch.sort2_field is not None and top_vals2 is not None:
                internal2 = float(top_vals2[i])
                raw2 = decode_sort_value_exact(
                    internal2, batch.sort2_field, batch.sort2_order,
                    sort2_is_int, scores[i], doc_id,
                    exact_col(si, batch.sort2_field, sort2_is_int))
            hits.append(PartialHit(sort_value=internal, split_id=split_id,
                                   doc_id=doc_id, raw_sort_value=raw,
                                   sort_value2=internal2,
                                   raw_sort_value2=raw2))
        intermediate = _intermediate_aggs(batch.template, list(merged_aggs))
        if rec is not None:
            rec["hits"] = len(hits)
            rec["stage"] = "batch"
    real_splits = sum(1 for s in batch.split_ids if s)
    return LeafSearchResponse(
        num_hits=num_hits,
        partial_hits=hits,
        num_attempted_splits=real_splits,
        num_successful_splits=real_splits,
        intermediate_aggs=intermediate,
    )


def execute_batch(batch: SplitBatch, request: SearchRequest,
                  device=None) -> LeafSearchResponse:
    """Run the batch on `device` (default `cuda`) and return one merged
    LeafSearchResponse covering all its splits."""
    return readback_batch(dispatch_batch(batch, request, device))


# --------------------------------------------------------------------------
# the query group: Q batches over one split set in one dispatch
#
# Each query keeps its own cross-split merge; the fused steps of all Q x n
# lanes share `score_topk_lanes` launches. Column-family slots (packed
# fast-field values, fieldnorms and their zonemaps) depend only on the
# split set, so a lane's slot whose key equals query 0's at that lane is
# served from query 0's staged tensor; every other slot is the query's
# own. A [Q] validity mask drops queries shed after the group formed: they
# run nothing and their rows stay 0 (never written: -inf * 0 is NaN).

_GROUP_SHARED_PREFIXES = ("col.", "norm.")


def group_slot_split(batches: list) -> tuple[tuple[int, ...],
                                             tuple[int, ...]]:
    """(shared_slots, stacked_slots) for a query group, by the JAX rule: a
    slot is shared when every query's template carries the same array key
    at it AND the key is a column-family key."""
    t0 = batches[0].template
    shared, stacked = [], []
    for slot, key in enumerate(t0.array_keys):
        if key.startswith(_GROUP_SHARED_PREFIXES) and all(
                b.template.array_keys[slot] == key for b in batches[1:]):
            shared.append(slot)
        else:
            stacked.append(slot)
    return tuple(shared), tuple(stacked)


def group_cache_key(batches: list, k: int) -> tuple:
    """The JAX package's `_GROUP_JIT_CACHE` key for this group without a
    mesh, post k-clamp. The [Q] validity mask is not part of it."""
    b0 = batches[0]
    k = min(k, b0.num_docs_padded)
    _shared, stacked_slots = group_slot_split(batches)
    return (b0.template.signature(k), len(batches), b0.n_splits,
            b0.num_docs_padded, stacked_slots, None, False)


def _group_lanes(batches: list, valid: list, dev) -> tuple[list, int]:
    """Each live query's lanes (`[query][split][slot]`, None for a masked
    query) and the bytes a sharing query did not stage: query 0's lanes
    through `stage_device_inputs`, every other query's non-shared slots in
    one packed copy per query."""
    b0 = batches[0]
    base = stage_device_inputs(b0, dev)
    out: list = [base if valid[0] else None]
    avoided = 0
    for b, ok in zip(batches[1:], valid[1:]):
        if not ok:
            out.append(None)
            continue
        own = [{slot for slot, key in enumerate(plan.array_keys)
                if not (key.startswith(_GROUP_SHARED_PREFIXES)
                        and key == plan0.array_keys[slot])}
               for plan, plan0 in zip(b.plans, b0.plans)]
        staged, _ = _stage_lanes(b.plans, dev, set().union(*own))
        lanes = []
        for i, plan in enumerate(b.plans):
            lanes.append([staged[i][slot] if slot in own[i] else base[i][slot]
                          for slot in range(len(plan.arrays))])
            avoided += sum(plan.arrays[slot].nbytes
                           for slot in range(len(plan.arrays))
                           if slot not in own[i])
        out.append(lanes)
    return out, avoided


def group_fn(batches: list, k: int):
    """The group's device program: fn(group_lanes, device) → one merged
    result tree per query (None for a masked query), each equal to its
    query's solo `batch_fn` (where -NaN keys meet a cut, ranked over the
    group's widest operand, as the JAX group pads); the fused steps of
    every live lane of every query run in shared `score_topk_lanes`
    launches."""
    # the JAX group pads its stacked operands to the group's longest, so
    # every query's lanes select over one width
    width = max(_lane_width(b) for b in batches)

    def fn(group_lanes, dev):
        flat = [(q, i, plan, lanes[i])
                for q, (b, lanes) in enumerate(zip(batches, group_lanes))
                if lanes is not None for i, plan in enumerate(b.plans)]
        fused = _fused_steps([(plan, arrays) for _, _, plan, arrays in flat],
                             k, width)
        fused_of = {(q, i): fused.get(j)
                    for j, (q, i, _, _) in enumerate(flat)}
        out = []
        for q, (b, lanes) in enumerate(zip(batches, group_lanes)):
            if lanes is None:
                out.append(None)
                continue
            results = [_run_lane(plan, lanes[i], k, dev, fused_of[(q, i)],
                                 width)
                       for i, plan in enumerate(b.plans)]
            out.append(_merge_lanes(results, k, b.n_splits, dev))
        return out

    return fn


def dispatch_query_group(batches: list, request: SearchRequest,
                         device=None, valid=None) -> BatchDispatch:
    """Async half of a query group: Q batches of one template signature
    over ONE split set as one dispatch. `valid[q] = False` masks query q:
    it runs nothing and reads back as None. Returns the dispatch for
    `readback_query_group`."""
    check_cancelled("query-group dispatch")
    b0 = batches[0]
    q = len(batches)
    k = min(request.start_offset + request.max_hits, b0.num_docs_padded)
    for b in batches[1:]:
        if b.split_ids != b0.split_ids:
            raise ValueError("query group spans different split sets")
    sig0 = b0.template.signature(k)
    for b in batches[1:]:
        if b.template.signature(k) != sig0:
            raise ValueError(
                "query group is not shape-compatible (template signatures "
                "differ) — group by LoweredPlan.structure_digest upstream")
    valid = [True] * q if valid is None else [bool(v) for v in valid]
    if len(valid) != q:
        raise ValueError("dispatch_query_group: one validity flag per query")
    dev = resolve_device(device)
    live = sum(valid)
    if live > 1:
        QBATCH_GROUPS_TOTAL.inc()
    QBATCH_QUERIES_PER_DISPATCH.observe(live)
    if q - live:
        QBATCH_MASKED_RIDERS_TOTAL.inc(q - live)
    group_lanes, avoided = _group_lanes(batches, valid, dev)
    if avoided:
        QBATCH_SHARED_BYTES_AVOIDED_TOTAL.inc(avoided)
    if flight.recording():
        flight.emit("dispatch.launch",
                    attrs={"path": "query_group", "lanes": q, "live": live,
                           "mesh": 0})
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    with profiled_phase(PHASE_EXECUTE) as rec:
        if rec is not None:
            rec["stage"] = "dispatch_query_group"
        trees = group_fn(batches, k)(group_lanes, dev)
        rows = out = spec = None
        for row, tree in enumerate(trees):
            if tree is None:
                continue
            leaves: list[torch.Tensor] = []
            spec = ex._flatten(tree, leaves)
            flat = [leaf.reshape(-1).to(torch.float64) for leaf in leaves]
            if out is None:
                out = torch.zeros((q, sum(t.numel() for t in flat)),
                                  dtype=torch.float64, device=dev)
            torch.cat(flat, out=out[row])
        if out is not None:
            rows, event = _copy_out(out, dev)
        else:
            event = None
    return BatchDispatch(rows, event, spec, list(batches), k, valid)


def readback_query_group(dispatched: BatchDispatch) -> list:
    """Blocking half: ONE copy of the [Q, W] rows, then each live query's
    merged decode; a masked query reads back as None."""
    check_cancelled("query-group readback")
    host = _await(dispatched, "query_group")
    results: list = []
    for row, (batch, ok) in enumerate(zip(dispatched.batches,
                                          dispatched.valid)):
        if not ok:
            results.append(None)
            continue
        top_vals, top_vals2, split_idx, doc_ids, scores, total, _safe, \
            merged_aggs = ex._unpack_result(host[row], dispatched.spec)
        results.append(_decode_merged(
            batch, dispatched.k, top_vals, top_vals2, split_idx, doc_ids,
            scores, int(total), merged_aggs))
    return results


def execute_query_group(batches: list, request: SearchRequest,
                        device=None, valid=None) -> list:
    """Run Q shape-compatible queries over one split set as ONE dispatch
    on `device` (default `cuda`); one LeafSearchResponse per query (None
    for queries masked by `valid`)."""
    return readback_query_group(
        dispatch_query_group(batches, request, device, valid=valid))
