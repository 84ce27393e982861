"""Plan execution on the device: the posting-space leaf program.

Counterpart of the JAX package's `search/executor.py`, posting-space subset.
A single-term plan (root `PPostings`, no search_after) runs over the [P]
posting arrays instead of the [N] dense docs: score, key, select top-k,
and count buckets through a view that gathers doc-space columns at each
posting's doc id. The whole result tree is concatenated as f64 on the
device and read back with ONE `.cpu()` per query.

Where the JAX program opts into the fused Pallas kernel (`QW_PALLAS=1`),
this program always takes the fused kernel when its conditions hold: sort
by score with no second key, a scoring root, k <= 64 and no threshold slot.
On CUDA tensors that is `ops/kernels/score_topk.py`'s CUDA kernel; on CPU
tensors the same call runs its plain torch version. Every other
posting-space plan (k > 64, field or doc sorts, k = 0) goes through
`score_postings` → `_keyed_for` → `exact_topk`.

Not ported yet, and raising NotImplementedError naming the slice that
will: the doc-space program (Bool/Range roots, search_after), threshold
pushdown, bucket metrics, range/composite aggregations and top-level metric
aggregations.

Scalars stay on the host (numpy) and enter torch ops as host numbers,
except divisors, which become 0-dim device tensors (`ops.bm25.f32_scalar`):
CUDA divides by a host scalar through its reciprocal, which is not the
correctly rounded quotient.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import aggs as agg_ops
from ..ops import masks as mask_ops
from ..ops import topk as topk_ops
from ..ops.bm25 import score_postings
from ..ops.kernels.score_topk import MAX_K as FUSED_MAX_K, score_topk
from .plan import (
    PRESENT_FROM_VALUES, BucketAggExec, CompositeAggExec, LoweredPlan,
    MetricAggExec, PPostings,
)

_DOC_SPACE_SLICE = ("the doc-space executor slice (Bool/Range roots, "
                    "search_after)")
_AGGS_SLICE = ("the remaining-aggregations slice (bucket metrics, range, "
               "composite, top-level metrics, HLL, percentiles)")


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


def _check_ported(plan: LoweredPlan) -> None:
    """Raise for plans this package cannot run yet, before any work."""
    if not _posting_space_eligible(plan):
        raise NotImplementedError(
            f"plan is not posting-space eligible; it needs {_DOC_SPACE_SLICE}")
    if plan.threshold_slot >= 0:
        raise NotImplementedError(
            f"threshold pushdown is not ported; it needs {_DOC_SPACE_SLICE}")
    stack = []
    for a in plan.aggs:
        if not isinstance(a, BucketAggExec) or a.kind == "range":
            raise NotImplementedError(
                f"aggregation {a.name!r} needs {_AGGS_SLICE}")
        stack.append(a)
    while stack:
        a = stack.pop()
        if a.metrics:
            raise NotImplementedError(
                f"bucket metrics under {a.name!r} need {_AGGS_SLICE}")
        stack.extend(a.subs)


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


# FOR-packed u16/u32 lanes: torch's unsigned types beyond u8 lack most
# kernels, so they are read through their signed twins and widened
_UNSIGNED_LANES = {torch.uint16: (torch.int16, torch.int32, 0xFFFF),
                   torch.uint32: (torch.int32, torch.int64, 0xFFFFFFFF)}


def _widened(arr: torch.Tensor, idx=None) -> torch.Tensor:
    """`arr` (gathered at `idx` when given) with u16/u32 lanes widened to
    the next signed type; other dtypes unchanged."""
    lane = _UNSIGNED_LANES.get(arr.dtype)
    if lane is None:
        return arr if idx is None else arr[idx]
    signed, wide, mask = lane
    lanes = arr.view(signed) if idx is None else arr.view(signed)[idx]
    return lanes.to(wide) & mask


def _rebased(arr: torch.Tensor, scalars, rb) -> torch.Tensor:
    """`delta * scale + min` in the scale's dtype (i64 for packed integer
    columns); `arr` unchanged for slots without a rebase entry."""
    if rb is None:
        return arr
    scale = torch.as_tensor(np.asarray(scalars[rb[0]]))
    fmin = np.asarray(scalars[rb[1]])
    return _widened(arr).to(scale.dtype) * scale.item() + fmin.item()


def _where_idx(mask: torch.Tensor, idx: torch.Tensor, sentinel: int):
    return torch.where(mask, idx.to(torch.int32), sentinel)


def _bucket_idx(a: BucketAggExec, arrays, scalars, mask):
    """(idx, in_bucket_mask): per-doc bucket index with the out-of-range
    sentinel `num_buckets` for dropped docs."""
    values = arrays[a.values_slot]
    nb = a.num_buckets
    if a.kind == "terms":
        ordinals = values
        m = mask & (ordinals >= 0)
        return _where_idx(m, ordinals, nb), m
    present = arrays[a.present_slot].to(torch.bool)
    m = mask & present
    origin = scalars[a.origin_slot]
    interval = scalars[a.interval_slot]
    if a.kind == "date_histogram":
        # exact integer math: floor division as in the JAX program
        raw = torch.div(values - int(origin), int(interval),
                        rounding_mode="floor")
    else:
        divisor = torch.tensor(np.float64(interval), dtype=torch.float64,
                               device=values.device)
        raw = torch.floor((values.to(torch.float64) - float(origin))
                          / divisor)
    idx = raw.to(torch.int32)
    m = m & (idx >= 0) & (idx < nb)
    return _where_idx(m, idx, nb), m


def _eval_bucket_agg(a: BucketAggExec, arrays, scalars, mask):
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
        "metrics": {},
    }
    subs = []
    for child in a.subs:
        nb2 = child.num_buckets
        idx2, m2 = _bucket_idx(child, arrays, scalars, mask)
        both = m & m2
        combined = _where_idx(both, idx * nb2 + idx2, space * nb2)
        subs.append(_eval_bucket_level(child, arrays, scalars, mask,
                                       combined, both, space * nb2))
    if subs:
        out["subs"] = subs
    return out


def _eval_aggs(aggs, gathered, scalars, valid):
    return [_eval_bucket_agg(a, gathered, scalars, valid) for a in aggs]


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
            key = -key
        return torch.where(mask, key, neg_inf)
    if by == "column":
        key = view[values_slot].to(torch.float64)
        if not descending:
            key = -key
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
    return torch.where(mask, key if descending else -key, neg_inf)


def _build_posting_space(plan: LoweredPlan, k: int):
    """The posting-space program: fn(arrays, scalars, num_docs) → (sort
    values f64[k], None, doc ids i32[k], hit scores f32[k], count i32,
    topk_safe f64, agg states), the JAX program's result tree."""
    _check_ported(plan)
    root, sort, aggs = plan.root, plan.sort, plan.aggs
    padded = plan.num_docs_padded

    def fn(arrays, scalars, num_docs):
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
        kk = min(k, num_postings)
        if (sort.by == "score" and sort.by2 == "none" and root.scoring
                and k <= FUSED_MAX_K and plan.threshold_slot < 0):
            # fused scoring + top-k: the [P] scores never materialize; hit
            # scores come straight from the kernel's winners
            vals_f32, pos = score_topk(
                ids, tfs, arrays[root.norm_slot], scalars[root.idf_slot],
                scalars[root.avg_len_slot], num_docs, kk)
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
        if sort.by2 != "none":
            raise NotImplementedError(
                f"two-key sorts need {_DOC_SPACE_SLICE} (exact_topk_2key)")
        sort_vals, pos = topk_ops.exact_topk(keyed, kk)
        doc_ids = ids[pos]
        hit_scores = scores[pos]
        agg_out = _eval_aggs(aggs, gathered, scalars, valid)
        return (sort_vals, None, doc_ids.to(torch.int32), hit_scores,
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


def _get_packed_executor(plan: LoweredPlan, k: int):
    """packed(arrays, scalars, num_docs) → (one f64 device tensor, spec)."""
    fn = _build_posting_space(plan, k)

    def packed(arrays, scalars, num_docs):
        leaves: list[torch.Tensor] = []
        spec = _flatten(fn(arrays, scalars, num_docs), leaves)
        flat = [leaf.reshape(-1).to(torch.float64) for leaf in leaves]
        return torch.cat(flat), spec

    return packed


def _unpack_result(packed: np.ndarray, spec):
    tree, _ = _unflatten(spec, packed, 0)
    return tree


def readback_plan_result(packed: torch.Tensor, spec) -> dict[str, Any]:
    """ONE device→host copy for the entire result tree, unpacked by spec."""
    host = packed.cpu().numpy()
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


def execute_plan(plan: LoweredPlan, k: int, device_arrays: list,
                 device=None) -> dict[str, Any]:
    """Run the plan on the device holding `device_arrays`; returns host
    numpy results. `device` (default `cuda`) must be where the arrays are."""
    from .. import resolve_device
    dev = resolve_device(device)
    for arr in device_arrays:
        if arr.device.type != dev.type:
            raise ValueError(f"execute_plan on {dev}: array on {arr.device}")
    k = max(0, min(k, plan.num_docs_padded))
    packed, spec = _get_packed_executor(plan, k)(
        list(device_arrays), tuple(plan.scalars), int(plan.num_docs))
    return readback_plan_result(packed, spec)
