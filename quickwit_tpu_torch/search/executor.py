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
with ONE `.cpu()` per query. `compute_packed_mask` runs the predicate tree
alone and returns its np.packbits-ordered bitmask (the mask-fill program).

The JAX package's `guided_topk` (an f32 screen that re-dispatches through
`exact_topk` when it cannot certify its answer) is not used: this program
runs `exact_topk`, and `topk_safe` is always 1.

Not ported yet, and raising NotImplementedError naming the slice that
will: bucket metrics, range, composite and multivalued-terms aggregations,
and top-level metric aggregations.

Scalars stay on the host (numpy) and enter torch ops as host numbers,
except divisors, which become 0-dim device tensors (`ops.bm25.f32_scalar`):
CUDA divides by a host scalar through its reciprocal, which is not the
correctly rounded quotient.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..index.format import ZONEMAP_BLOCK
from ..ops import aggs as agg_ops
from ..ops import masks as mask_ops
from ..ops import topk as topk_ops
from ..ops.bm25 import dequantize_block_bounds, score_postings
from ..ops.kernels.score_topk import MAX_K as FUSED_MAX_K, score_topk
from ..ops.masks import widened as _widened
from .plan import (
    PRESENT_FROM_VALUES, BucketAggExec, CompositeAggExec, LoweredPlan,
    MetricAggExec, PBool, PMaskRef, PMatchAll, PMatchNone, PNormPresence,
    PPostings, PPresence, PRange,
)

_AGGS_SLICE = ("the remaining-aggregations slice (bucket metrics, range, "
               "composite, multivalued terms, top-level metrics, HLL, "
               "percentiles)")


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
    """Raise for plans this package cannot run yet, before any work: every
    aggregation but bucket counts over terms, histogram and date_histogram
    (nested or not)."""
    stack = []
    for a in plan.aggs:
        if not isinstance(a, BucketAggExec):
            raise NotImplementedError(
                f"aggregation {a.name!r} needs {_AGGS_SLICE}")
        stack.append(a)
    while stack:
        a = stack.pop()
        if a.kind in ("range", "terms_mv"):
            raise NotImplementedError(
                f"aggregation {a.name!r} ({a.kind}) needs {_AGGS_SLICE}")
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
    values f64[k], second sort values f64[k] | None, doc ids i32[k], hit
    scores f32[k], count i32, topk_safe f64, agg states), the JAX
    program's result tree."""
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
            sort_vals, pos = topk_ops.exact_topk(keyed, kk)
        else:
            keyed2 = _keyed_for(sort.by2, sort.descending2, sort.values2_slot,
                                sort.present2_slot, gathered, valid, scores,
                                ids)
            if plan.threshold_slot >= 0:
                keyed2 = mask_ops.propagate_dead_lanes(keyed, keyed2)
            sort_vals, sort_vals2, pos = topk_ops.exact_topk_2key(
                keyed, keyed2, kk)
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
    """The leaf program for `plan`: fn(arrays, scalars, num_docs) → (sort
    values f64[k], sort values 2 f64[k] | None, doc ids i32[k], hit scores
    f32[k], count i32, topk_safe f64, agg states), the JAX program's result
    tree. Posting-space eligible plans take `_build_posting_space`."""
    if _posting_space_eligible(plan):
        return _build_posting_space(plan, k)
    _check_ported(plan)
    padded = plan.num_docs_padded
    root, sort, aggs = plan.root, plan.sort, plan.aggs
    eval_node = _node_evaluator(padded, device)

    def fn(arrays, scalars, num_docs):
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
            sort_vals, doc_ids = topk_ops.exact_topk(keyed, k)
        else:
            sort_vals, sort_vals2, doc_ids = topk_ops.exact_topk_2key(
                keyed, keyed2, k)
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


def _get_packed_executor(plan: LoweredPlan, k: int, device):
    """packed(arrays, scalars, num_docs) → (one f64 device tensor, spec)."""
    fn = _build(plan, k, device)

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
    packed, spec = _get_packed_executor(plan, k, dev)(
        list(device_arrays), tuple(plan.scalars), int(plan.num_docs))
    return readback_plan_result(packed, spec)


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
    mask, _ = _node_evaluator(padded, dev)(plan.root, list(device_arrays),
                                           tuple(plan.scalars))
    mask = mask & mask_ops.valid_docs_mask(plan.num_docs, padded, dev)
    packed = _pack_mask(mask, padded)
    return packed.cpu().numpy(), packed
