"""Plan execution on the device: the leaf program.

Counterpart of the JAX package's `search/executor.py`. `_build` turns a
LoweredPlan into one function over the staged arrays, in one of two forms:

- Posting space (`_build_posting_space`): a single-term plan (root
  `PPostings`, no search_after) runs over the [P] posting arrays instead of
  the [N] dense docs: score, key, select top-k, and count buckets through a
  view that gathers doc-space columns at each posting's doc id. Where the
  JAX program opts into the fused Pallas kernel (`QW_PALLAS=1`), this
  program always takes the fused kernel when its conditions hold: sort by
  score with no second key, a scoring root, k <= 64 and no threshold slot.
  On CUDA tensors that is `ops/kernels/score_topk.py`'s CUDA kernel; on CPU
  tensors the same call runs its plain torch version. Every other
  posting-space plan goes through `score_postings` → `_keyed_for` → the
  threshold and impact block-max masks → `exact_topk`/`exact_topk_2key`.
- Doc space (`_build`): every other plan. The predicate tree
  (`_node_evaluator`) scatters postings into dense masks and scores,
  compares ranges over packed lanes and zonemaps, and combines Bool
  clauses; then the sort keys, the search_after and threshold pushdowns,
  the exact top-k, and the bucket counts over the dense mask.

The whole result tree is concatenated as f64 on the device and read back
with ONE `.cpu()` per query. A stacked query group or a convoy
(`dispatch_plan_stacked` / `dispatch_plan_multi`, the query batcher's
paths) runs its lanes' programs in one dispatch, with one `score_topk_lanes`
launch for the fused step of all its lanes, and reads every lane back in
ONE asynchronous copy. `compute_packed_mask` runs the predicate tree
alone and returns its np.packbits-ordered bitmask (the mask-fill program).

The JAX package's `guided_topk` (an f32 screen that re-dispatches through
`exact_topk` when it cannot certify its answer) is not used: this program
runs `exact_topk`, and `topk_safe` is always 1. A program that selects
hits counts `topk_evals` on the ambient query profile, and
`topk_kernel_evals` where the fused CUDA kernel computed its top-k.

Aggregations (`_eval_aggs`): bucket counts and bucket metrics over
terms, multivalued terms, histogram and date_histogram at any nesting
depth; range buckets (one mask per range, since ranges overlap);
composite buckets (a stable lexicographic sort over the doc space, run
starts, and segment reductions per run); top-level stats, percentiles and
cardinality. Every reduction is in `ops/aggs.py`; none uses f64 atomics,
so a request gives the same bits on every run. On CUDA tensors a node
whose state the one-pass kernel (`ops/kernels/aggs.py`) computes exactly
takes that kernel instead (`_kernel_route`), with the same bits.

Scalars stay on the host (numpy) and enter torch ops as host numbers,
except divisors, which become 0-dim device tensors (`ops.bm25.f32_scalar`):
CUDA divides by a host scalar through its reciprocal, which is not the
correctly rounded quotient.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Any

import numpy as np
import torch

from ..common.clock import monotonic as _clock_monotonic
from ..index.format import ZONEMAP_BLOCK
from ..observability import flight
from ..observability.metrics import SEARCH_KERNEL_LAUNCHES_TOTAL
from ..observability.profile import (
    AGG_EVALS, AGG_KERNEL_EVALS, PHASE_EXECUTE, TOPK_EVALS, TOPK_KERNEL_EVALS,
    note_dispatch, profile_add, profiled_phase)
from ..ops import aggs as agg_ops
from ..ops.kernels import aggs as agg_kernel
from ..ops import masks as mask_ops
from ..ops import topk as topk_ops
from ..ops.bm25 import dequantize_block_bounds, score_postings
from ..ops.kernels.score_topk import (
    MAX_K as FUSED_MAX_K, MAX_LANES, score_topk, score_topk_lanes,
)
from ..ops.masks import widened as _widened
from .plan import (
    PRESENT_FROM_VALUES, BucketAggExec, CompositeAggExec, LoweredPlan,
    MetricAggExec, PBool, PMaskRef, PMatchAll, PMatchNone, PNormPresence,
    PPostings, PPresence, PRange,
)


def _bucket_tree_blocks_posting_space(children) -> bool:
    """True when a nested-bucket subtree needs arrays the _GatherView
    cannot serve (range bounds, multivalued pair arrays, per-ordinal
    hash tables)."""
    stack = list(children)
    while stack:
        child = stack.pop()
        if (child.kind in ("range", "terms_mv")
                or any(m.kind == "cardinality" for m in child.metrics)):
            return True
        stack.extend(child.subs)
    return False


def _posting_space_eligible(plan: LoweredPlan) -> bool:
    """Single-term queries (no boolean structure, no NOT semantics) can
    execute entirely over the [P] posting arrays instead of [N] dense docs.

    Aggregations whose auxiliary arrays are NOT doc-space (range bounds,
    multivalued pair arrays, per-ordinal hash tables) cannot ride the
    _GatherView (it gathers every slot at per-posting doc ids): those
    plans take the dense path."""
    if not (isinstance(plan.root, PPostings)
            and plan.search_after_relation == "none"):
        return False
    if plan.root.impact_ordered and plan.sort.by not in ("score", "doc"):
        # impact-ordered postings (format v3) break posting-index ==
        # doc-order; a field-primary key's lowest-index-wins ties would
        # diverge from the doc-ordered layout
        return False
    for a in plan.aggs:
        if isinstance(a, BucketAggExec):
            if _bucket_tree_blocks_posting_space([a]):
                return False
        elif isinstance(a, CompositeAggExec):
            if _bucket_tree_blocks_posting_space(a.subs):
                return False
        elif isinstance(a, MetricAggExec):
            if a.metric.kind == "cardinality":
                return False
    return True


class _RebaseView:
    """arrays[slot] with FOR-packed slots reconstructed as
    `delta * for_scale + for_min` in the column's integer domain (see
    LoweredPlan.rebase), so value consumers observe full-width values while
    device memory holds the narrow lanes."""

    def __init__(self, arrays, scalars, rebase):
        self.arrays = arrays
        self.scalars = scalars
        self.rebase = rebase

    def __getitem__(self, slot: int):
        return _rebased(self.arrays[slot], self.scalars, self.rebase.get(slot))


class _GatherView:
    """arrays[slot] gathered at per-posting doc ids, so the bucket-agg
    evaluator runs unchanged in posting space. FOR-packed slots rebase
    AFTER the gather: the [P]-sized reconstruction is cheaper than the
    full-width doc-space column."""

    def __init__(self, arrays, safe_ids, scalars=None, rebase=None):
        self.arrays = arrays
        self.safe_ids = safe_ids
        self.scalars = scalars
        self.rebase = rebase or {}

    def __getitem__(self, slot: int):
        return _rebased(_widened(self.arrays[slot], self.safe_ids),
                        self.scalars, self.rebase.get(slot))


def _rebased(arr: torch.Tensor, scalars, rb) -> torch.Tensor:
    """`delta * scale + min` in the scale's dtype (i64 for packed integer
    columns); `arr` unchanged for slots without a rebase entry."""
    if rb is None:
        return arr
    scale, fmin = np.asarray(scalars[rb[0]]), np.asarray(scalars[rb[1]])
    if scale.dtype == np.uint64:
        # torch has no u64 arithmetic: the same bits come out of i64
        # wraparound arithmetic, viewed as u64
        wide = _widened(arr).to(torch.int64)
        return (wide * int(scale.view(np.int64))
                + int(fmin.view(np.int64))).view(torch.uint64)
    return (_widened(arr).to(torch.from_numpy(scale).dtype) * scale.item()
            + fmin.item())


def _where_idx(mask: torch.Tensor, idx: torch.Tensor, sentinel: int):
    return torch.where(mask, idx.to(torch.int32), sentinel)


def _cardinality_hashes(met, arrays):
    """(hashes, present) per doc for a cardinality metric, the hashes as
    u64 bits in i64: text columns gather per-ordinal TERM hashes from the
    plan's host-built table (cross-split identity), numeric columns mix the
    64-bit value pattern on the device. The one derivation: the bucket,
    range and top-level metric paths all call it."""
    if met.hash_slot >= 0:
        ordinals = arrays[met.values_slot]
        present = ordinals >= 0
        table = arrays[met.hash_slot].view(torch.int64)
        hashes = table[torch.clamp(ordinals, min=0).to(torch.int64)]
    else:
        present = arrays[met.present_slot].to(torch.bool)
        hashes = agg_ops._hll_mix64(
            agg_ops.value_bits(arrays[met.values_slot]))
    return hashes, present


def _histogram_index(kind: str, values: torch.Tensor, origin,
                     interval) -> torch.Tensor:
    """int32 bucket index of a (date_)histogram: exact integer floor
    division for dates, f64 floor of the quotient otherwise (the divisor a
    device tensor: CUDA divides by a host scalar through its reciprocal)."""
    if kind == "date_histogram":
        raw = torch.div(values - int(origin), int(interval),
                        rounding_mode="floor")
    else:
        divisor = torch.tensor(np.float64(interval), dtype=torch.float64,
                               device=values.device)
        raw = torch.floor((agg_ops.as_f64(values) - float(origin))
                          / divisor)
    return raw.to(torch.int32)


def _bucket_idx(a: BucketAggExec, arrays, scalars, mask):
    """(idx, in_bucket_mask): per-doc bucket index with the out-of-range
    sentinel `num_buckets` for dropped docs."""
    values = arrays[a.values_slot]
    nb = a.num_buckets
    if a.kind == "terms":
        ordinals = values
        m = mask & (ordinals >= 0)
        return _where_idx(m, ordinals, nb), m
    if a.kind == "terms_mv":
        # multivalued: values are (doc, ordinal) PAIR arrays; gather the
        # doc-level mask at each pair's doc id. Padding pairs carry
        # ordinal -1 (dropped here) with doc 0 (an in-bounds gather)
        pair_docs = arrays[a.present_slot].to(torch.int64)
        m = mask[pair_docs] & (values >= 0)
        return _where_idx(m, values, nb), m
    m = mask & arrays[a.present_slot].to(torch.bool)
    idx = _histogram_index(a.kind, values, scalars[a.origin_slot],
                           scalars[a.interval_slot])
    m = m & (idx >= 0) & (idx < nb)
    return _where_idx(m, idx, nb), m


def _bucket_metrics(metric_slots, arrays, idx, m, nb):
    metrics: dict[str, Any] = {}
    for met in metric_slots:
        if met.kind == "cardinality":
            # per-bucket HLL registers (integer scatter-max)
            hashes, present = _cardinality_hashes(met, arrays)
            ok = m & present
            metrics[met.name] = {"hll": agg_ops.bucket_hll_registers(
                _where_idx(ok, idx, nb), hashes, ok, nb)}
            continue
        mv = agg_ops.as_f64(arrays[met.values_slot])
        mp = arrays[met.present_slot].to(torch.bool)
        # docs with mm == False get the sentinel index, which every bucket
        # reduction drops, so mv needs no extra masking passes
        mm = m & mp
        midx = _where_idx(mm, idx, nb)
        need = met.kind
        if need == "percentiles":
            metrics[met.name] = {
                "sketch": agg_ops.bucket_percentile_sketch(midx, mv, nb)}
            continue
        metrics[met.name] = _metric_state(
            need,
            lambda: agg_ops.bucket_sum(midx, mv, nb),
            lambda: agg_ops.bucket_counts(midx, nb).to(torch.int64),
            lambda: agg_ops.bucket_min(midx, mv, nb),
            lambda: agg_ops.bucket_max(midx, mv, nb),
            lambda: agg_ops.bucket_sum(midx, mv * mv, nb))
    return metrics


def _metric_state(need: str, total, count, low, high, total_sq):
    """The state a metric kind keeps, in the JAX program's key order:
    sum, count, min, max, sum_sq (each reduction run only when needed)."""
    state: dict[str, Any] = {}
    if need in ("sum", "avg", "stats", "extended_stats"):
        state["sum"] = total()
    if need in ("avg", "stats", "extended_stats", "value_count"):
        state["count"] = count()
    if need in ("min", "stats", "extended_stats"):
        state["min"] = low()
    if need in ("max", "stats", "extended_stats"):
        state["max"] = high()
    if need in ("stats", "extended_stats"):
        state["sum_sq"] = total_sq()
    return state


def _eval_range_agg(a: BucketAggExec, arrays, mask):
    """Range buckets may OVERLAP (ES counts a doc in every range it falls
    in), so each range gets its own mask instead of one bucket index. The
    JAX program broadcasts a [docs, ranges] mask that XLA fuses; here one
    [docs] mask per range keeps the memory at one column."""
    nb = a.num_buckets
    values = agg_ops.as_f64(arrays[a.values_slot])
    base = mask & arrays[a.present_slot].to(torch.bool)
    froms, tos = arrays[a.froms_slot], arrays[a.tos_slot]
    operands = []
    for met in a.metrics:
        if met.kind == "cardinality":
            # c_present: the cardinality field's presence, not the range
            # field's
            operands.append(_cardinality_hashes(met, arrays))
        else:
            operands.append((agg_ops.as_f64(arrays[met.values_slot]),
                             arrays[met.present_slot].to(torch.bool)))
    counts = []
    per_range: list[dict[str, list]] = [{} for _ in a.metrics]
    for i in range(nb):
        in_range = base & (values >= froms[i]) & (values < tos[i])
        counts.append(in_range.sum(dtype=torch.int32))
        for met, operand, acc in zip(a.metrics, operands, per_range):
            for key, value in _range_metric(met.kind, operand, in_range,
                                            mask).items():
                acc.setdefault(key, []).append(value)
    metrics = {met.name: {key: torch.stack(v) for key, v in acc.items()}
               for met, acc in zip(a.metrics, per_range)}
    return {"counts": torch.stack(counts), "metrics": metrics}


def _range_metric(need: str, operand, in_range, mask) -> dict[str, Any]:
    """One range's state of one metric."""
    if need == "cardinality":
        hashes, c_present = operand
        return {"hll": agg_ops.hll_registers(hashes, in_range & c_present)}
    mv, mp = operand
    if need == "percentiles":
        return {"sketch": agg_ops.percentile_sketch(mv, mp,
                                                    in_range & mask)}
    mm = in_range & mp
    return _metric_state(
        need,
        lambda: torch.where(mm, mv, 0.0).sum(),
        lambda: mm.sum(dtype=torch.int64),
        lambda: agg_ops.masked_extreme(mv, mm, largest=False),
        lambda: agg_ops.masked_extreme(mv, mm, largest=True),
        lambda: torch.where(mm, mv * mv, 0.0).sum())


def _eval_bucket_agg(a: BucketAggExec, arrays, scalars, mask):
    if a.kind == "range":
        return _eval_range_agg(a, arrays, mask)
    idx, m = _bucket_idx(a, arrays, scalars, mask)
    return _eval_bucket_level(a, arrays, scalars, mask, idx, m,
                              a.num_buckets)


def _eval_bucket_level(a: BucketAggExec, arrays, scalars, mask, idx, m,
                       space: int):
    """One level of a nested bucket tree. `idx`/`m` are the FLATTENED
    bucket index (mixed-radix over all ancestors) and its validity mask;
    `space` is the flattened bucket count. Children extend the radix:
    child_flat = parent_flat * child_nb + child_local."""
    out: dict[str, Any] = {
        "counts": agg_ops.bucket_counts(_where_idx(m, idx, space), space),
        "metrics": _bucket_metrics(a.metrics, arrays, idx, m, space),
    }
    subs = _eval_children(a.subs, arrays, scalars, mask, idx, m, space)
    if subs:
        out["subs"] = subs
    return out


def _eval_children(children, arrays, scalars, mask, idx, m, space: int):
    subs = []
    for child in children:
        nb2 = child.num_buckets
        idx2, m2 = _bucket_idx(child, arrays, scalars, mask)
        both = m & m2
        combined = _where_idx(both, idx * nb2 + idx2, space * nb2)
        subs.append(_eval_bucket_level(child, arrays, scalars, mask,
                                       combined, both, space * nb2))
    return subs


def _lexsort(keys: list) -> torch.Tensor:
    """The permutation that sorts the i32 `keys` lexicographically (first
    key most significant), ties kept in input order. Two keys pack into one
    i64 (the first in the high word, the second offset to unsigned in the
    low word); the packed keys sort by successive stable sorts, least
    significant first. `jax.lax.sort` is not guaranteed stable, so only
    the order inside a run can differ from the JAX program's."""
    packed = []
    for i in range(0, len(keys), 2):
        hi = keys[i].to(torch.int64)
        if i + 1 < len(keys):
            hi = hi * (1 << 32) + (keys[i + 1].to(torch.int64) + (1 << 31))
        packed.append(hi)
    perm = None
    for key in reversed(packed):
        if perm is None:
            perm = torch.argsort(key, stable=True)
        else:
            perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def _eval_composite_agg(a: CompositeAggExec, arrays, scalars, mask):
    """Composite buckets: one lexicographic sort over the doc space,
    run-boundary detection, and the first `size` distinct key tuples with
    exact counts; no dynamic hash tables.

    Per-source i32 keys use the order-preserving encoding documented on
    CompositeSourceExec (missing=0, value=(idx+1)*2, after markers odd)."""
    num = mask.shape[0]
    dev = mask.device
    m = mask
    keys = []
    for s in a.sources:
        if s.kind == "terms_ord":
            ordinals = arrays[s.values_slot]
            present = ordinals >= 0
            key = (ordinals.to(torch.int32) + 1) * 2
        else:
            present = arrays[s.present_slot].to(torch.bool)
            idx = _histogram_index(s.kind, arrays[s.values_slot],
                                   scalars[s.origin_slot],
                                   scalars[s.interval_slot])
            key = (idx + 1) * 2
        if s.missing_bucket:
            key = torch.where(present, key, 0)
        else:
            m = m & present
        keys.append(key)
    if a.has_after:
        # strict lexicographic tuple > after, cascaded per source
        gt = torch.zeros(num, dtype=torch.bool, device=dev)
        eq = torch.ones(num, dtype=torch.bool, device=dev)
        for key, s in zip(keys, a.sources):
            marker = int(scalars[s.after_slot])
            gt = gt | (eq & (key > marker))
            eq = eq & (key == marker)
        m = m & gt
    keys = [torch.where(m, key, 2**31 - 1) for key in keys]
    # the permutation sorts the keys; metric operands and the doc order of
    # each run (for bucket children) follow it
    perm = _lexsort(keys)
    sorted_keys = [key[perm] for key in keys]
    valid_total = m.sum(dtype=torch.int32)
    idxs = torch.arange(num, dtype=torch.int32, device=dev)
    diff = torch.zeros(max(num - 1, 0), dtype=torch.bool, device=dev)
    for sk in sorted_keys:
        diff = diff | (sk[1:] != sk[:-1])
    is_start = torch.cat([torch.ones(min(num, 1), dtype=torch.bool,
                                     device=dev), diff])
    is_start = is_start & (idxs < valid_total)
    start_pos = torch.where(is_start, idxs, num)
    k_runs = min(a.size, num)
    # ascending run starts: the k_runs + 1 smallest start positions
    starts = torch.topk(start_pos, min(k_runs + 1, num), largest=False,
                        sorted=True).values
    if starts.shape[0] < k_runs + 1:
        starts = torch.cat([starts, torch.full(
            (k_runs + 1 - starts.shape[0],), num, dtype=torch.int32,
            device=dev)])
    safe = torch.clamp(starts[:k_runs], 0, num - 1).to(torch.int64)
    run_keys = torch.stack([sk[safe] for sk in sorted_keys])  # [S, k_runs]
    ends = torch.minimum(starts[1:], valid_total)
    counts = torch.where(starts[:k_runs] < valid_total,
                         ends - starts[:k_runs], 0)
    out: dict[str, Any] = {"run_keys": run_keys, "counts": counts}
    # per-position run id = rank of this position's run among the first
    # k_runs (positions past them drop)
    run_id = torch.cumsum(is_start.to(torch.int32), 0,
                          dtype=torch.int32) - 1
    in_range = (idxs < valid_total) & (run_id >= 0) & (run_id < k_runs)
    if a.subs:
        # each doc's run id back at its original position (a permutation:
        # every index written once): bucket children then evaluate with
        # the normal nested machinery, the composite as the outermost
        # radix level
        run_id_doc = torch.empty(num, dtype=torch.int32, device=dev)
        run_id_doc[perm] = torch.where(in_range, run_id, k_runs)
        in_run = run_id_doc < k_runs
        out["subs"] = _eval_children(a.subs, arrays, scalars, mask,
                                     run_id_doc, in_run, k_runs)
    if a.metrics:
        metrics: dict[str, Any] = {}
        for met in a.metrics:
            mv = agg_ops.as_f64(arrays[met.values_slot])[perm]
            mp = (arrays[met.present_slot].to(torch.bool) & m)[perm]
            seg = _where_idx(in_range & mp, run_id, k_runs)
            metrics[met.name] = _metric_state(
                met.kind,
                lambda: agg_ops.bucket_sum(seg, mv, k_runs),
                lambda: agg_ops.bucket_counts(seg, k_runs).to(torch.int64),
                lambda: agg_ops.bucket_min(seg, mv, k_runs),
                lambda: agg_ops.bucket_max(seg, mv, k_runs),
                lambda: agg_ops.bucket_sum(seg, mv * mv, k_runs))
        out["metrics"] = metrics
    return out


def _eval_agg_torch(a, gathered, scalars, valid):
    """One aggregation node's state by the torch reductions of
    `ops/aggs.py`."""
    if isinstance(a, CompositeAggExec):
        return _eval_composite_agg(a, gathered, scalars, valid)
    if isinstance(a, BucketAggExec):
        return _eval_bucket_agg(a, gathered, scalars, valid)
    if isinstance(a, MetricAggExec):
        met = a.metric
        if met.kind == "cardinality":
            hashes, present = _cardinality_hashes(met, gathered)
            return {"hll": agg_ops.hll_registers(hashes, valid & present)}
        mv = gathered[met.values_slot]
        mp = gathered[met.present_slot]
        if met.kind == "percentiles":
            return {"sketch": agg_ops.percentile_sketch(mv, mp, valid)}
        return {"stats": agg_ops.stats_state(mv, mp, valid)}
    raise TypeError(f"unknown agg exec {type(a).__name__}")


# --- the one-pass aggregation kernel ---------------------------------------
#
# On CUDA tensors a doc-space node whose state `ops/kernels/aggs.py`
# computes exactly takes it: one launch over the columns as stored, where
# the torch path runs ~100 eager ops. What decides is what the node and its
# columns show, never a setting: a terms (i32 ordinals) or date_histogram
# bucket agg without children, or a top-level metric, whose metrics are all
# of the kinds below over integer columns with max|value| * docs < 2^53
# (read from the lanes' width and the host-side FOR scalars). Everything
# else takes the torch path: posting space (`_GatherView`), composite,
# range, histogram, terms_mv, nested buckets, cardinality, extended_stats,
# f64 columns, and every node on the CPU. `_kernel_route` reads the node and
# its columns alone, so the CPU tests see how the card routes.

_KERNEL_NEEDS = {
    "value_count": agg_kernel.COUNT,
    "sum": agg_kernel.SUM,
    "avg": agg_kernel.SUM | agg_kernel.COUNT,
    "min": agg_kernel.MIN,
    "max": agg_kernel.MAX,
    "stats": agg_kernel.STATS,
    "percentiles": agg_kernel.SKETCH,
}


def _kernel_ready(t: torch.Tensor, docs: int) -> bool:
    return t.dim() == 1 and t.shape[0] == docs and t.is_contiguous()


def _kernel_metric_column(view, met, squares: bool, docs: int):
    if met.present_slot < 0:
        return None
    lanes = view.arrays[met.values_slot]
    present = view.arrays[met.present_slot]
    if not (_kernel_ready(lanes, docs) and _kernel_ready(present, docs)):
        return None
    rb = view.rebase.get(met.values_slot)
    frame = None if rb is None else (view.scalars[rb[0]],
                                     view.scalars[rb[1]])
    return agg_kernel.exact_column(lanes, present, frame, squares)


def _kernel_bucket(a: BucketAggExec, view, docs: int):
    """The bucket arguments of `agg_kernel.bucket_aggregate` for a terms or
    date_histogram node, or None where the kernel would not index its
    docs as `_bucket_idx` does."""
    lanes = view.arrays[a.values_slot]
    rb = view.rebase.get(a.values_slot)
    if not _kernel_ready(lanes, docs):
        return None
    if a.kind == "terms":
        if lanes.dtype != torch.int32 or rb is not None:
            return None
        return {"kind": "terms", "bucket": agg_kernel.Column(lanes)}
    present = view.arrays[a.present_slot] if a.present_slot >= 0 else None
    if present is None or not _kernel_ready(present, docs) \
            or present.dtype not in agg_kernel.PRESENT_DTYPES:
        return None
    origin = int(np.asarray(view.scalars[a.origin_slot]))
    interval = int(np.asarray(view.scalars[a.interval_slot]))
    rebase = None
    if rb is not None:
        # unsigned lanes of an i64 frame rebase in i64, as the torch path
        # does (a u64 frame rebases to u64 lanes, subtracted otherwise)
        scale = np.asarray(view.scalars[rb[0]])
        frame = agg_kernel.frame_of((scale, view.scalars[rb[1]]))
        if (frame is None or scale.dtype != np.int64 or lanes.dtype
                not in (torch.uint8, torch.uint16, torch.uint32)):
            return None
        rebase = frame[0]
    elif lanes.dtype == torch.int32:
        if not (-2**31 <= origin < 2**31 and interval < 2**31):
            return None
    elif lanes.dtype != torch.int64:
        return None
    if interval <= 0:
        return None
    return {"kind": "date_histogram",
            "bucket": agg_kernel.Column(lanes, present, rebase),
            "origin": origin, "interval": interval}


def _kernel_route(a, view, docs: int):
    """(bucket arguments, buckets, [(metric column, its metrics, needs)],
    the node's metrics) when the kernel computes node `a`, one launch per
    metric column; None where the node takes the torch path."""
    if not isinstance(view, _RebaseView):
        return None
    if isinstance(a, MetricAggExec):
        met = a.metric
        if met.kind not in _KERNEL_NEEDS:
            return None
        needs = (agg_kernel.SKETCH if met.kind == "percentiles"
                 else agg_kernel.STATS)    # `stats_state` for every other
        col = _kernel_metric_column(view, met,
                                    bool(needs & agg_kernel.SUM_SQ), docs)
        if col is None:
            return None
        return {"kind": "none"}, 1, [(col, (met,), needs)], (met,)
    if not (isinstance(a, BucketAggExec)
            and a.kind in ("terms", "date_histogram") and not a.subs
            and 1 <= a.num_buckets <= agg_kernel.MAX_BUCKETS):
        return None
    bucket = _kernel_bucket(a, view, docs)
    if bucket is None:
        return None
    groups: dict[tuple[int, int], list] = {}
    for met in a.metrics:
        if met.kind not in _KERNEL_NEEDS:
            return None
        groups.setdefault((met.values_slot, met.present_slot),
                          []).append(met)
    launches = []
    for mets in groups.values():
        needs = 0
        for met in mets:
            needs |= _KERNEL_NEEDS[met.kind]
        col = _kernel_metric_column(view, mets[0],
                                    bool(needs & agg_kernel.SUM_SQ), docs)
        if col is None:
            return None
        launches.append((col, tuple(mets), needs))
    return bucket, a.num_buckets, launches, a.metrics


def _eval_agg_kernel(route, mask):
    """The node's state, as `_eval_agg_torch` returns it, from the kernel:
    one launch per metric column (the first also counts the buckets)."""
    bucket, nb, launches, metric_order = route
    if bucket["kind"] == "none":
        ((col, _, needs),) = launches
        out = agg_kernel.bucket_aggregate(
            mask, 1, needs, metric=col, stats=needs == agg_kernel.STATS)
        if needs == agg_kernel.SKETCH:
            return {"sketch": out["sketch"].reshape(-1)}
        return out
    counts, per_metric = None, {}
    for col, mets, needs in launches or [(None, (), 0)]:
        if counts is None:
            needs |= agg_kernel.COUNTS
        out = agg_kernel.bucket_aggregate(mask, nb, needs, metric=col,
                                          **bucket)
        if counts is None:
            counts = out["counts"]
        for met in mets:
            per_metric[id(met)] = out
    metrics: dict[str, Any] = {}
    for met in metric_order:     # `_bucket_metrics`' order
        out = per_metric[id(met)]
        if met.kind == "percentiles":
            metrics[met.name] = {"sketch": out["sketch"]}
        else:
            metrics[met.name] = _metric_state(
                met.kind, lambda: out["sum"], lambda: out["count"],
                lambda: out["min"], lambda: out["max"],
                lambda: out["sum_sq"])
    return {"counts": counts, "metrics": metrics}


def _eval_aggs(aggs, gathered, scalars, valid):
    """Every aggregation node's state over the docs in `valid`: on CUDA by
    the one-pass kernel where it computes the node exactly
    (`_kernel_route`), else by the torch reductions. Counts the nodes, and
    those the kernel computed, on the ambient query profile."""
    agg_out = []
    on_kernel = 0
    for a in aggs:
        route = (_kernel_route(a, gathered, valid.shape[0])
                 if valid.is_cuda else None)
        if route is None:
            agg_out.append(_eval_agg_torch(a, gathered, scalars, valid))
        else:
            agg_out.append(_eval_agg_kernel(route, valid))
            on_kernel += 1
    if aggs:
        profile_add(AGG_EVALS, len(aggs))
        profile_add(AGG_KERNEL_EVALS, on_kernel)
    return agg_out


def _negated(key: torch.Tensor) -> torch.Tensor:
    """`-key` (f64) as the CPU and the JAX CPU program negate: the sign bit
    flipped on every value, NaN included. A CUDA negation may return a NaN
    of the other sign, which `lax.top_k`'s total order ranks at the other
    end of an ascending sort."""
    return (key.view(torch.int64) ^ torch.iinfo(torch.int64).min).view(
        torch.float64)


def _keyed_for(by, descending, values_slot, present_slot, view, mask,
               scores, doc_key):
    """Higher-is-better f64 key for one sort part (missing column values get
    the finite bottom sentinel, non-matching docs -inf). `view` is the
    arrays (dense path) or a _GatherView (posting space); `doc_key` is the
    per-element doc id source for "doc" sorts."""
    neg_inf = float("-inf")
    if by == "score":
        key = scores.to(torch.float64)
        if not descending:
            key = _negated(key)
        return torch.where(mask, key, neg_inf)
    if by == "column":
        key = agg_ops.as_f64(view[values_slot])
        if not descending:
            key = _negated(key)
        if present_slot == PRESENT_FROM_VALUES:
            present = view[values_slot] >= 0  # ordinal columns: -1 = missing
        else:
            present = view[present_slot].to(torch.bool)
        has_value = mask & present
        missing = torch.full(mask.shape, topk_ops.MISSING_VALUE_SENTINEL,
                             dtype=torch.float64, device=mask.device)
        return torch.where(has_value, key, missing.masked_fill_(~mask,
                                                                neg_inf))
    # "doc"
    key = doc_key.to(torch.float64)
    return torch.where(mask, key if descending else _negated(key), neg_inf)


def _takes_fused_kernel(plan: LoweredPlan, k: int) -> bool:
    """True when the program's top-k is the fused `score_topk` step: a
    posting-space plan sorted by score alone, with a scoring root, 0 < k <=
    64 and no threshold slot. Every part is in the plan's signature, so the
    lanes of a stacked group all agree."""
    return (_posting_space_eligible(plan) and 0 < k <= FUSED_MAX_K
            and plan.sort.by == "score" and plan.sort.by2 == "none"
            and plan.root.scoring and plan.threshold_slot < 0)


def _fused_lane(plan: LoweredPlan, arrays, scalars, num_docs) -> tuple:
    """The fused step's inputs for one query: (ids, tfs, fieldnorms, idf,
    avg_len, num_docs), as `score_topk` and each lane of
    `score_topk_lanes` take them."""
    root = plan.root
    return (arrays[root.ids_slot], arrays[root.tfs_slot],
            arrays[root.norm_slot], scalars[root.idf_slot],
            scalars[root.avg_len_slot], num_docs)


def _widen(keyed: torch.Tensor, width) -> torch.Tensor:
    """`keyed` extended with -inf lanes to `width`: a multi-split batch
    lane's operand length in the JAX package's stacked program, where every
    lane pads to the batch's longest (parallel/fanout.py). The pads rank
    below every real lane but -NaN, at the highest indices, as the stacked
    program's pad postings and pad docs do. Unchanged when `width` is None
    or not wider."""
    if width is None or width <= keyed.shape[0]:
        return keyed
    return torch.cat([keyed, keyed.new_full((width - keyed.shape[0],),
                                            topk_ops.NEG_INF)])


def _build_posting_space(plan: LoweredPlan, k: int):
    """The posting-space program: fn(arrays, scalars, num_docs, fused=None,
    width=None) → (sort values f64[k], second sort values f64[k] | None,
    doc ids i32[k], hit scores f32[k], count i32, topk_safe f64, agg
    states), the JAX program's result tree. When the plan takes the fused
    kernel (`_takes_fused_kernel`), `fused` may hand in its (values,
    posting indices), computed apart (a stacked group runs the step for all
    its lanes in one `score_topk_lanes` launch); with None the program runs
    `score_topk` itself, first. `width` is a batch lane's posting length in
    the JAX stacked program (`_widen`); the top-k selects over that many
    lanes."""
    root, sort, aggs = plan.root, plan.sort, plan.aggs
    padded = plan.num_docs_padded
    fused_step = _takes_fused_kernel(plan, k)

    def fn(arrays, scalars, num_docs, fused=None, width=None):
        ids = arrays[root.ids_slot]
        tfs = arrays[root.tfs_slot]
        dev = ids.device
        num_postings = ids.shape[0]
        valid = ids < num_docs
        count = valid.sum(dtype=torch.int32)
        safe_ids = torch.clamp(ids, 0, padded - 1).to(torch.int64)
        gathered = _GatherView(arrays, safe_ids, scalars, plan.rebase)
        one = torch.ones((), dtype=torch.float64, device=dev)
        if k == 0:  # count/agg-only: no scoring, no top-k
            agg_out = _eval_aggs(aggs, gathered, scalars, valid)
            return (torch.zeros(0, dtype=torch.float64, device=dev), None,
                    torch.zeros(0, dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.float32, device=dev),
                    count, one, tuple(agg_out))
        kk = min(k, max(num_postings, width or 0))
        profile_add(TOPK_EVALS)
        if fused_step:
            # on CUDA tensors `score_topk` and `score_topk_lanes` launch
            # the kernel; on the CPU they run their plain versions
            if dev.type == "cuda":
                profile_add(TOPK_KERNEL_EVALS)
            # fused scoring + top-k: the [P] scores never materialize; hit
            # scores come straight from the kernel's winners
            if fused is None:
                fused = score_topk(*_fused_lane(plan, arrays, scalars,
                                                num_docs), kk)
            vals_f32, pos = fused
            sort_vals = vals_f32.to(torch.float64)
            doc_ids = ids[pos]
            hit_scores = torch.where(mask_ops.dead_lane_mask(vals_f32),
                                     0.0, vals_f32)
            agg_out = _eval_aggs(aggs, gathered, scalars, valid)
            return (sort_vals, None, doc_ids.to(torch.int32), hit_scores,
                    count, one, tuple(agg_out))
        if root.scoring:
            scores = score_postings(
                tfs, ids, arrays[root.norm_slot],
                scalars[root.avg_len_slot], scalars[root.idf_slot])
        else:
            scores = torch.zeros(num_postings, dtype=torch.float32,
                                 device=dev)
        # "doc" sorts key on the posting's doc id (ascending already)
        keyed = _keyed_for(sort.by, sort.descending, sort.values_slot,
                           sort.present_slot, gathered, valid, scores, ids)
        if plan.threshold_slot >= 0:
            # dynamic pruning pushdown: counts/aggs keep full-query
            # semantics; only top-k eligibility is restricted
            threshold = scalars[plan.threshold_slot]
            keyed = topk_ops.apply_threshold_mask(keyed, threshold)
            if (root.impact_bmax_slot >= 0 and sort.by == "score"
                    and sort.descending):
                # impact block-max early exit (format v3): a no-op for
                # results, since the bound is sound
                bounds = dequantize_block_bounds(
                    arrays[root.impact_bmax_slot],
                    scalars[root.impact_scale_slot])
                keyed = topk_ops.block_max_threshold_mask(keyed, bounds,
                                                          threshold)
        sort_vals2 = None
        if sort.by2 == "none":
            sort_vals, pos = topk_ops.exact_topk(_widen(keyed, width), kk)
        else:
            keyed2 = _keyed_for(sort.by2, sort.descending2, sort.values2_slot,
                                sort.present2_slot, gathered, valid, scores,
                                ids)
            if plan.threshold_slot >= 0:
                keyed2 = mask_ops.propagate_dead_lanes(keyed, keyed2)
            sort_vals, sort_vals2, pos = topk_ops.exact_topk_2key(
                _widen(keyed, width), _widen(keyed2, width), kk)
        if kk > num_postings:
            # widened: a pad lane's hit is -inf, never decoded
            pos = torch.clamp(pos, max=num_postings - 1)
        doc_ids = ids[pos]
        hit_scores = scores[pos]
        agg_out = _eval_aggs(aggs, gathered, scalars, valid)
        return (sort_vals, sort_vals2, doc_ids.to(torch.int32), hit_scores,
                count, one, tuple(agg_out))

    return fn


# --- doc space ----------------------------------------------------------------

def _global_doc_ids(plan: LoweredPlan, scalars, padded: int, device):
    """Per-lane GLOBAL doc ids: the plain iota for whole-split plans; a
    chunk's doc offset (`doc_base_slot`) shifts it for chunked dense
    sub-plans, so doc-keyed comparisons stay in global doc space."""
    docs = torch.arange(padded, dtype=torch.int32, device=device)
    if plan.doc_base_slot >= 0:
        docs = docs + int(np.asarray(scalars[plan.doc_base_slot])
                          .astype(np.int32))
    return docs


def _apply_search_after(plan: LoweredPlan, keyed, keyed2, scalars,
                        padded: int):
    """Restrict top-k eligibility per the search_after marker (counts and
    aggs keep full-query semantics). With a secondary key the comparison is
    lexicographic. Markers are f64 host scalars, compared with the f64
    keys."""
    relation = plan.search_after_relation
    marker = float(scalars[plan.sa_value_slot])

    def doc_after():
        docs = _global_doc_ids(plan, scalars, padded, keyed.device)
        return docs > int(scalars[plan.sa_doc_slot])

    neg_inf = float("-inf")
    if keyed2 is None:
        if relation == "lt":
            eligible = keyed < marker
        elif relation == "le":
            eligible = keyed <= marker
        else:  # "lt_tie"
            eligible = (keyed < marker) | ((keyed == marker) & doc_after())
        return torch.where(eligible, keyed, neg_inf), None
    marker2 = float(scalars[plan.sa_value2_slot])
    lt = (keyed < marker) | ((keyed == marker) & (keyed2 < marker2))
    tie = (keyed == marker) & (keyed2 == marker2)
    if relation == "lt":
        eligible = lt
    elif relation == "le":
        eligible = lt | tie
    else:  # "lt_tie"
        eligible = lt | (tie & doc_after())
    return (torch.where(eligible, keyed, neg_inf),
            torch.where(eligible, keyed2, neg_inf))


def _pack_mask(mask: torch.Tensor, padded: int) -> torch.Tensor:
    """Big-endian bit pack of a [padded] bool mask into [ceil(padded/8)]
    uint8, in np.packbits bit order, so a device-computed mask and a host
    np.packbits of the same booleans are byte-identical."""
    nbytes = (padded + 7) // 8
    bits = torch.zeros(nbytes * 8, dtype=torch.int32, device=mask.device)
    bits[:padded] = mask.to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    return (bits.reshape(nbytes, 8) << shifts).sum(1).to(torch.uint8)


def _unpack_mask(packed: torch.Tensor, padded: int) -> torch.Tensor:
    """Inverse of `_pack_mask`: [nbytes] uint8 -> [padded] bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:padded].to(torch.bool)


def _node_evaluator(padded: int, device):
    """The predicate-tree evaluator, shared by the search program (`_build`)
    and the mask-fill program (`compute_packed_mask`): one implementation,
    so a filled mask equals inline evaluation by construction."""

    def eval_node(node, arrays, scalars):
        """Returns (mask[padded] bool, scores[padded] f32 | None)."""
        if isinstance(node, PMatchAll):
            return torch.ones(padded, dtype=torch.bool, device=device), None
        if isinstance(node, PMatchNone):
            return torch.zeros(padded, dtype=torch.bool, device=device), None
        if isinstance(node, PMaskRef):
            # the whole predicate is a cached packed bitmask
            return _unpack_mask(arrays[node.packed_slot], padded), None
        if isinstance(node, PPostings):
            ids = arrays[node.ids_slot]
            mask = mask_ops.mask_from_postings(ids, padded)
            if not node.scoring:
                return mask, None
            partial = score_postings(
                arrays[node.tfs_slot], ids, arrays[node.norm_slot],
                scalars[node.avg_len_slot], scalars[node.idf_slot])
            return mask, mask_ops.dense_from_postings(ids, partial, padded)
        if isinstance(node, PRange):
            values = arrays[node.values_slot]
            if values.dtype in (torch.uint8, torch.uint16, torch.uint32):
                # FOR-packed lanes compare as scaled deltas in i32
                values = _widened(values).to(torch.int32)
            return mask_ops.range_mask(
                values, arrays[node.present_slot],
                scalars[node.lo_slot] if node.lo_slot >= 0 else None,
                scalars[node.hi_slot] if node.hi_slot >= 0 else None,
                node.lo_incl, node.hi_incl,
                node.lo_slot >= 0, node.hi_slot >= 0,
                zmin=(arrays[node.zmin_slot]
                      if node.zmin_slot >= 0 else None),
                zmax=(arrays[node.zmax_slot]
                      if node.zmax_slot >= 0 else None),
                zonemap_block=ZONEMAP_BLOCK), None
        if isinstance(node, PPresence):
            col = arrays[node.present_slot]
            return ((col >= 0) if node.is_ordinal
                    else col.to(torch.bool)), None
        if isinstance(node, PNormPresence):
            return _widened(arrays[node.norm_slot]) > 0, None
        if isinstance(node, PBool):
            return eval_bool(node, arrays, scalars)
        raise TypeError(f"unknown plan node {type(node).__name__}")

    def eval_bool(node: PBool, arrays, scalars):
        # score parts sum in clause order: must, filter, should
        score_parts = []
        conj = None
        for child in list(node.must) + list(node.filter):
            m, s = eval_node(child, arrays, scalars)
            conj = m if conj is None else (conj & m)
            if s is not None:
                score_parts.append(s)
        should_masks = []
        for child in node.should:
            m, s = eval_node(child, arrays, scalars)
            should_masks.append(m)
            if s is not None:
                score_parts.append(s)
        mask = conj
        if should_masks:
            if node.minimum_should_match:
                msm = mask_ops.minimum_should_match_mask(
                    should_masks, node.minimum_should_match)
                mask = msm if mask is None else (mask & msm)
            elif mask is None:
                mask = mask_ops.or_masks(*should_masks)
            # should with must present: purely optional (scoring only)
        if mask is None:
            mask = torch.ones(padded, dtype=torch.bool, device=device)
        for child in node.must_not:
            m, _ = eval_node(child, arrays, scalars)
            mask = mask & ~m
        scores = None
        if score_parts:
            scores = score_parts[0]
            for s in score_parts[1:]:
                scores = scores + s
        return mask, scores

    return eval_node


def _build(plan: LoweredPlan, k: int, device):
    """The leaf program for `plan`: fn(arrays, scalars, num_docs,
    fused=None, width=None) → (sort values f64[k], sort values 2 f64[k] |
    None, doc ids i32[k], hit scores f32[k], count i32, topk_safe f64, agg
    states), the JAX program's result tree. Posting-space eligible plans
    take `_build_posting_space` (the only form that reads `fused`).
    `width` (a multi-split batch lane's doc count in the JAX stacked
    program, `_widen`) lets k exceed this split's padded doc count. The
    function reads only what `plan.signature(k)` covers from `plan`, so
    plans of one signature share it."""
    if _posting_space_eligible(plan):
        return _build_posting_space(plan, k)
    padded = plan.num_docs_padded
    root, sort, aggs = plan.root, plan.sort, plan.aggs
    eval_node = _node_evaluator(padded, device)

    def fn(arrays, scalars, num_docs, fused=None, width=None):
        # predicates read the raw (possibly packed-delta) arrays; value
        # consumers go through the rebasing view
        view = _RebaseView(arrays, scalars, plan.rebase)
        mask, scores = eval_node(root, arrays, scalars)
        mask = mask & mask_ops.valid_docs_mask(num_docs, padded, device)
        if scores is None:
            scores = torch.zeros(padded, dtype=torch.float32, device=device)
        count = mask.sum(dtype=torch.int32)
        one = torch.ones((), dtype=torch.float64, device=device)
        if k == 0:  # count/agg-only: no keying, no top-k
            agg_out = _eval_aggs(aggs, view, scalars, mask)
            return (torch.zeros(0, dtype=torch.float64, device=device), None,
                    torch.zeros(0, dtype=torch.int32, device=device),
                    torch.zeros(0, dtype=torch.float32, device=device),
                    count, one, tuple(agg_out))
        profile_add(TOPK_EVALS)
        # only "doc" sorts read the doc key (XLA drops it unused; torch
        # would run it)
        doc_key = (_global_doc_ids(plan, scalars, padded, device)
                   if "doc" in (sort.by, sort.by2) else None)
        keyed = _keyed_for(sort.by, sort.descending, sort.values_slot,
                           sort.present_slot, view, mask, scores, doc_key)
        keyed2 = None
        if sort.by2 != "none":
            keyed2 = _keyed_for(sort.by2, sort.descending2, sort.values2_slot,
                                sort.present2_slot, view, mask, scores,
                                doc_key)
        # search_after pushdown: restricts top-k eligibility, NOT
        # counts/aggs (totals and aggregations cover the full query)
        if plan.search_after_relation != "none":
            keyed, keyed2 = _apply_search_after(plan, keyed, keyed2, scalars,
                                                padded)
        if plan.threshold_slot >= 0:
            # dynamic-pruning threshold: same eligibility-only contract
            keyed = topk_ops.apply_threshold_mask(
                keyed, scalars[plan.threshold_slot])
            if keyed2 is not None:
                keyed2 = mask_ops.propagate_dead_lanes(keyed, keyed2)
        sort_vals2 = None
        if keyed2 is None:
            sort_vals, doc_ids = topk_ops.exact_topk(_widen(keyed, width), k)
        else:
            sort_vals, sort_vals2, doc_ids = topk_ops.exact_topk_2key(
                _widen(keyed, width), _widen(keyed2, width), k)
        hit_scores = scores[torch.clamp(doc_ids, 0, padded - 1)]
        agg_out = _eval_aggs(aggs, view, scalars, mask)
        return (sort_vals, sort_vals2, doc_ids.to(torch.int32), hit_scores,
                count, one, tuple(agg_out))

    return fn


# --- packed readback ---------------------------------------------------------
#
# The result tree has O(10) leaves (hits, count, per-agg counts). Every
# leaf is concatenated as f64 on the device and crosses to the host in ONE
# copy; the host unpacks by the (structure, shapes, dtypes) spec. f64
# packing is exact for every output dtype in use: counts are doc-bounded
# (< 2^53), f32 → f64 is exact.

def _flatten(tree, leaves: list):
    """Structure of `tree` with its tensors appended to `leaves`."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("leaf", tuple(tree.shape), tree.dtype)
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        return ("dict", tuple((key, _flatten(v, leaves))
                              for key, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"cannot pack result node {type(tree).__name__}")


def _unflatten(spec, host: np.ndarray, offset: int):
    """(tree, next offset) from the packed host buffer."""
    kind = spec[0]
    if kind == "leaf":
        _, shape, dtype = spec
        size = int(np.prod(shape)) if shape else 1
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        leaf = host[offset: offset + size].astype(np_dtype).reshape(shape)
        return leaf, offset + size
    if kind == "none":
        return None, offset
    if kind == "dict":
        out = {}
        for key, child in spec[1]:
            out[key], offset = _unflatten(child, host, offset)
        return out, offset
    items = []
    for child in spec[1]:
        item, offset = _unflatten(child, host, offset)
        items.append(item)
    return (tuple(items) if kind == "tuple" else items), offset


def _packed_leaves(fn, arrays, scalars, num_docs, fused=None):
    """(the result tree's leaves as flat f64 tensors, the tree's spec)."""
    leaves: list[torch.Tensor] = []
    spec = _flatten(fn(arrays, scalars, num_docs, fused), leaves)
    return [leaf.reshape(-1).to(torch.float64) for leaf in leaves], spec


def _get_packed_executor(plan: LoweredPlan, k: int, device):
    """packed(arrays, scalars, num_docs) → (one f64 device tensor, spec)."""
    fn = _build(plan, k, device)

    def packed(arrays, scalars, num_docs):
        flat, spec = _packed_leaves(fn, arrays, scalars, num_docs)
        return torch.cat(flat), spec

    return packed


def _unpack_result(packed: np.ndarray, spec):
    tree, _ = _unflatten(spec, packed, 0)
    return tree


def _result_dict(host: np.ndarray, spec) -> dict[str, Any]:
    """One query's result dict from its packed host row."""
    sort_vals, sort_vals2, doc_ids, hit_scores, count, _safe, agg_out = \
        _unpack_result(host, spec)
    return {
        "sort_values": sort_vals,
        "sort_values2": sort_vals2,
        "doc_ids": doc_ids,
        "scores": hit_scores,
        "count": int(count),
        "aggs": list(agg_out),
    }


def _readback(copy):
    """`copy()`, the blocking device→host step of a dispatch, in the
    profile's readback stage and, when the flight recorder is on, timed
    into a `dispatch.readback` event (as the JAX package's seam)."""
    t0 = _clock_monotonic() if flight.recording() else 0.0
    with profiled_phase(PHASE_EXECUTE, stage="readback"):
        host = copy()
    if flight.recording():
        flight.emit("dispatch.readback", attrs={
            "dur_ms": round((_clock_monotonic() - t0) * 1000.0, 3)})
    return host


def _note_launch(path: str, lanes: int) -> None:
    if flight.recording():
        flight.emit("dispatch.launch", attrs={"path": path, "lanes": lanes})


def readback_plan_result(packed: torch.Tensor, spec) -> dict[str, Any]:
    """ONE device→host copy for the entire result tree, unpacked by spec;
    the blocking copy absorbs the device's execution time."""
    return _result_dict(_readback(lambda: packed.cpu().numpy()), spec)


def _on_device(device, device_arrays: list, caller: str) -> torch.device:
    """The resolved device, after checking every array lies on it."""
    from .. import resolve_device
    dev = resolve_device(device)
    for arr in device_arrays:
        if arr.device.type != dev.type:
            raise ValueError(f"{caller} on {dev}: array on {arr.device}")
    return dev


def execute_plan(plan: LoweredPlan, k: int, device_arrays: list,
                 device=None) -> dict[str, Any]:
    """Run the plan on the device holding `device_arrays`; returns host
    numpy results. `device` (default `cuda`) must be where the arrays are."""
    dev = _on_device(device, device_arrays, "execute_plan")
    k = max(0, min(k, plan.num_docs_padded))
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    note_dispatch()
    _note_launch("solo", 1)
    with profiled_phase(PHASE_EXECUTE, stage="dispatch"):
        packed, spec = _get_packed_executor(plan, k, dev)(
            list(device_arrays), tuple(plan.scalars), int(plan.num_docs))
    return readback_plan_result(packed, spec)


# --- stacked query groups and convoys -----------------------------------------
#
# A group of Q queries over one split that share a plan STRUCTURE (one
# signature: node kinds, sort spec, agg shape, array shapes and dtypes,
# scalar dtypes, threshold/search_after/rebase presence) runs as ONE
# dispatch: the lanes' programs are enqueued back to back by one host call,
# their packed f64 rows land in one [bucket, W] device tensor, and that
# tensor crosses to the host in ONE asynchronous copy. Where the plans take
# the fused kernel, all the group's lanes share ONE `score_topk_lanes`
# launch, the counterpart of the JAX program's `vmap` over the Pallas call.
#
# The JAX package traces the group into one vmapped XLA program. The port
# has no vmap over its programs: they read host scalars (`_rebased`,
# `ops/masks.py`) and launch the kernel through ctypes. So the group is a
# loop over its live lanes, each lane's operands assembled from its own
# tensors (stacked slots) or lane 0's (shared slots, whose array keys agree
# across the group): no operand is stacked into a [Q, ...] copy, and a warm
# stacked call stages 0 bytes. A lane masked after the group formed
# (`valid[q] = False`) and the surplus lanes of the power-of-two bucket run
# nothing and leave their row 0.
#
# `dispatch_*` does not synchronize: it enqueues the programs and the copy
# into pinned host memory and records a CUDA event; `readback_*` waits on
# that event and unpacks the rows. So the batcher releases its dispatch
# lock before the readback, and the next convoy enqueues while this one's
# copy is in flight (the JAX package's `copy_to_host_async`).
#
# The JAX readback re-dispatches the lanes whose guided top-k could not
# certify its answer (`topk_safe == 0`). The port runs `exact_topk`, whose
# `topk_safe` is always 1, so that branch has no counterpart here.

# program key -> {device: leaf program}; the programs are plain closures,
# kept per key so that a second group of one structure reuses its program
_MULTI_CACHE: dict[tuple, dict[str, Any]] = {}
_STACKED_CACHE: dict[tuple, dict[str, Any]] = {}
# every per-structure program cache, for `executor_cache_size`; the
# fan-out's lane programs register here too
PROGRAM_CACHES: list[dict] = [_MULTI_CACHE, _STACKED_CACHE]


def executor_cache_size() -> int:
    """Leaf programs held in the program caches, one per (structure,
    device): the REST debug route's `jit_cache_entries`."""
    return sum(len(by_device) for cache in PROGRAM_CACHES
               for by_device in cache.values())


def _batch_bucket(n: int) -> int:
    """Round a group size up to the next power of two (the JAX package's
    bucket: one compiled program per bucket there, one program key here);
    surplus lanes run nothing and are dropped at readback."""
    b = 1
    while b < n:
        b *= 2
    return b


def stacked_slot_split(plans) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Partition array slots into (shared, stacked) by per-slot cache-key
    agreement across the group. The port's array keys carry their content
    (a range agg's bounds by their bytes, a phrase's postings with its
    slop), and a group forms over one split only, so key equality at a
    slot means the lanes read the same staged tensor: the slot is served
    from lane 0. A slot whose key differs reads each lane's own tensor."""
    keys0 = plans[0].array_keys
    shared, stacked = [], []
    for slot, key in enumerate(keys0):
        if all(p.array_keys[slot] == key for p in plans[1:]):
            shared.append(slot)
        else:
            stacked.append(slot)
    return tuple(shared), tuple(stacked)


def multi_program_cache_key(plan: LoweredPlan, k: int, batch: int,
                            exact: bool = False) -> tuple:
    """The `_MULTI_CACHE` key (batch already bucketed by the caller), the
    JAX package's key for the same convoy."""
    k = max(0, min(k, plan.num_docs_padded))
    return (plan.signature(k), batch, exact)


def stacked_program_cache_key(plans, k: int, bucket=None,
                              exact: bool = False) -> tuple:
    """The `_STACKED_CACHE` key for a query group, the JAX package's key
    for the same group: (signature, bucket, stacked slots, exact)."""
    base = plans[0]
    k = max(0, min(k, base.num_docs_padded))
    if bucket is None:
        bucket = _batch_bucket(len(plans))
    _, stacked_slots = stacked_slot_split(plans)
    return (base.signature(k), bucket, stacked_slots, exact)


def _program(cache: dict, key: tuple, plan: LoweredPlan, k: int, dev):
    """The group's leaf program, built once per (key, device) from the
    plan's structure alone, so a cached program keeps none of the plan's
    host arrays alive."""
    by_device = cache.setdefault(key, {})
    fn = by_device.get(str(dev))
    if fn is None:
        structure = dc_replace(plan, arrays=[], array_keys=[], scalars=[])
        fn = by_device[str(dev)] = _build(structure, k, dev)
    return fn


class LaneDispatch:
    """A dispatched lane group: the host copy of its packed [bucket, W]
    rows (pinned, filled asynchronously on a card), the event that marks
    the copy done, the rows' unpack spec, and which of the `batch` lanes
    ran."""

    __slots__ = ("host", "event", "spec", "batch", "valid")

    def __init__(self, host, event, spec, batch: int, valid: list):
        self.host = host
        self.event = event
        self.spec = spec
        self.batch = batch
        self.valid = valid


def _dispatch_lanes(base: LoweredPlan, k: int, fn, lanes: list, batch: int,
                    dev) -> LaneDispatch:
    """Enqueue the live lanes' programs (`lanes[q]` = (arrays, scalars,
    num_docs), None for a masked or surplus lane) and the copy of their
    packed rows; no synchronization."""
    live = [q for q, lane in enumerate(lanes) if lane is not None]
    fused: dict[int, tuple] = {}
    if live and _takes_fused_kernel(base, k):
        # the group's fused step: one lane-kernel launch per MAX_LANES lanes
        kk = min(k, int(lanes[live[0]][0][base.root.ids_slot].shape[0]))
        for lo in range(0, len(live), MAX_LANES):
            rows = live[lo:lo + MAX_LANES]
            vals, idx = score_topk_lanes(
                [_fused_lane(base, *lanes[q]) for q in rows], kk)
            for row, q in enumerate(rows):
                fused[q] = (vals[row], idx[row])
    out = spec = None
    for q in live:
        flat, lane_spec = _packed_leaves(fn, *lanes[q], fused.get(q))
        if out is None:
            spec = lane_spec
            # rows of masked and surplus lanes stay 0 (never written: their
            # sort lanes would hold -inf, and -inf * 0 is NaN)
            out = torch.zeros((len(lanes), sum(t.numel() for t in flat)),
                              dtype=torch.float64, device=dev)
        elif lane_spec != spec:
            raise ValueError("stacked lanes differ in result structure")
        torch.cat(flat, out=out[q])
    event = None
    if out is None:
        host = None
    elif dev.type == "cuda":
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    else:
        host = out
    return LaneDispatch(host, event, spec, batch,
                        [lanes[q] is not None for q in range(batch)])


def _readback_lanes(dispatched: LaneDispatch) -> list:
    def copy():
        if dispatched.event is not None:
            dispatched.event.synchronize()
        return (dispatched.host.numpy() if dispatched.host is not None
                else None)

    host = _readback(copy)
    return [_result_dict(host[q], dispatched.spec) if ok else None
            for q, ok in enumerate(dispatched.valid)]


def dispatch_plan_multi(plan: LoweredPlan, k: int, device_arrays: list,
                        scalar_sets: list, device=None) -> LaneDispatch:
    """Dispatch len(scalar_sets) queries of ONE plan structure over the
    SAME arrays (the convoy: riders that differ only in their scalars) as
    one lane group on `device` (default `cuda`). Each element of
    `scalar_sets` is a full per-query scalar tuple (plan.scalars layout)."""
    dev = _on_device(device, device_arrays, "dispatch_plan_multi")
    k = max(0, min(k, plan.num_docs_padded))
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    note_dispatch()
    batch = len(scalar_sets)
    bucket = _batch_bucket(batch)
    fn = _program(_MULTI_CACHE, multi_program_cache_key(plan, k, bucket),
                  plan, k, dev)
    arrays = list(device_arrays)
    lanes = [(arrays, tuple(s), int(plan.num_docs)) for s in scalar_sets]
    _note_launch("multi", batch)
    with profiled_phase(PHASE_EXECUTE, stage="dispatch_multi"):
        return _dispatch_lanes(plan, k, fn,
                               lanes + [None] * (bucket - batch), batch, dev)


def readback_plan_multi(dispatched: LaneDispatch) -> list[dict[str, Any]]:
    """The convoy's one device→host copy, unpacked per lane."""
    return _readback_lanes(dispatched)


def dispatch_plan_stacked(plans, k: int, arrays_list, valid=None,
                          device=None) -> LaneDispatch:
    """Dispatch len(plans) DISTINCT queries of one structure as one lane
    group on `device` (default `cuda`). `plans[q]` and `arrays_list[q]` are
    query q's lowered plan and staged arrays; all plans share
    `signature(k)` (the QueryGroupPlanner guarantees it). `valid[q] =
    False` masks lane q: it runs nothing and reads back as None, and the
    program key does not change. A masked lane's arrays may be None, and
    so may a lane's shared slots: they are served from the first lane that
    has arrays (lane 0 whenever it has them)."""
    base = plans[0]
    k = max(0, min(k, base.num_docs_padded))
    batch = len(plans)
    bucket = _batch_bucket(batch)
    valid = [True] * batch if valid is None else [bool(v) for v in valid]
    if len(valid) != batch or len(arrays_list) != batch:
        raise ValueError("dispatch_plan_stacked: one plan, array list and "
                         "validity flag per lane")
    donor = next(a for a in arrays_list if a is not None)
    dev = _on_device(device, [t for q in range(batch) if valid[q]
                              for t in arrays_list[q] if t is not None],
                     "dispatch_plan_stacked")
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    note_dispatch()
    plans_b = list(plans) + [plans[-1]] * (bucket - batch)
    shared_slots, stacked_slots = stacked_slot_split(plans_b)
    fn = _program(_STACKED_CACHE,
                  (base.signature(k), bucket, stacked_slots, False),
                  base, k, dev)
    lanes: list = [None] * bucket
    for q in range(batch):
        if valid[q]:
            arrays = list(arrays_list[q])
            for slot in shared_slots:
                arrays[slot] = donor[slot]
            lanes[q] = (arrays, tuple(plans[q].scalars),
                        int(plans[q].num_docs))
    _note_launch("stacked", batch)
    with profiled_phase(PHASE_EXECUTE, stage="dispatch_stacked"):
        return _dispatch_lanes(base, k, fn, lanes, batch, dev)


def readback_plan_stacked(dispatched: LaneDispatch) -> list:
    """The group's one device→host copy, unpacked per lane; a masked lane
    reads back as None."""
    return _readback_lanes(dispatched)


# --- predicate-mask fill --------------------------------------------------------

def mask_fill_cache_key(plan: LoweredPlan) -> tuple:
    """The key of this plan's predicate-only program: the predicate tree's
    structure, the array shapes and dtypes, the scalar dtypes and the
    padded doc count (the JAX package's `_MASK_FILL_CACHE` key)."""
    return (plan.root.sig(),
            tuple((a.shape, str(a.dtype)) for a in plan.arrays),
            tuple(str(s.dtype) for s in map(np.asarray, plan.scalars)),
            plan.num_docs_padded)


def compute_packed_mask(plan: LoweredPlan, device_arrays: list,
                        device=None) -> tuple[np.ndarray, torch.Tensor]:
    """Evaluate ONLY the plan's predicate root over already-staged device
    arrays and return `(host_packed, device_packed)`: the uint8 bitmask in
    np.packbits bit order, as the host copy destined for a cache tier and
    as the device original. Runs the same `_node_evaluator` as the search
    program, so the mask equals inline evaluation, and its bytes equal the
    JAX package's for the same plan and split. Callers must gate on
    `plan.count_override is None`: an impact-prefix-truncated plan never
    saw the posting tail, so its mask would be incomplete."""
    dev = _on_device(device, device_arrays, "compute_packed_mask")
    padded = plan.num_docs_padded
    SEARCH_KERNEL_LAUNCHES_TOTAL.inc()
    note_dispatch()
    mask, _ = _node_evaluator(padded, dev)(plan.root, list(device_arrays),
                                           tuple(plan.scalars))
    mask = mask & mask_ops.valid_docs_mask(plan.num_docs, padded, dev)
    packed = _pack_mask(mask, padded)
    return packed.cpu().numpy(), packed
