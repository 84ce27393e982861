"""Dense doc-set masks: the device replacement for posting-list iteration.

The reference's leaf loop (tantivy posting decode → boolean
intersection/union) walks compressed posting lists with scalar cursors.
Here the doc set of a split is a dense bool vector of length
`num_docs_padded`: term postings scatter into it, boolean operators are
elementwise ops, ranges are vectorized compares on resident columns.

Counterpart of the JAX package's `ops/masks.py`.

Padding convention (see index/writer.py): posting pad slots carry
`doc_id == num_docs_padded` and `tf == 0`. The JAX scatter drops them
(`mode="drop"`); an out-of-range index is a device-side assert on CUDA, so
every scatter here targets `num_docs_padded + 1` lanes, with ids clamped
into the spare last lane, and slices it off.

Range bounds arrive as numpy scalars with the plan's dtype. Each compare
runs in the type the JAX program computes it in (`compare_dtype`): an i64
column against a u64 bound compares in f64 there, which torch would not do
on its own.
"""

from __future__ import annotations

import numpy as np
import torch


def _drop_lane_ids(doc_ids: torch.Tensor, num_docs_padded: int):
    """Posting ids as int64 scatter indices; every id outside
    [0, num_docs_padded) lands in the spare lane `num_docs_padded`."""
    ids = doc_ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_docs_padded), ids,
                       num_docs_padded)


def mask_from_postings(doc_ids: torch.Tensor,
                       num_docs_padded: int) -> torch.Tensor:
    """Presence mask from a (padded) posting id array."""
    mask = torch.zeros(num_docs_padded + 1, dtype=torch.bool,
                       device=doc_ids.device)
    mask[_drop_lane_ids(doc_ids, num_docs_padded)] = True
    return mask[:num_docs_padded]


def dense_from_postings(doc_ids: torch.Tensor, values: torch.Tensor,
                        num_docs_padded: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Scatter-add per-posting values (tf, scores) into a dense per-doc
    array. An add, as in the JAX program: a term's ids are unique, so each
    lane is `0 + v`, exact in any order, and a `-0.0` value lands as +0.0."""
    dense = torch.zeros(num_docs_padded + 1, dtype=dtype,
                        device=doc_ids.device)
    dense.index_add_(0, _drop_lane_ids(doc_ids, num_docs_padded),
                     values.to(dtype))
    return dense[:num_docs_padded]


def valid_docs_mask(num_docs: int, num_docs_padded: int,
                    device=None) -> torch.Tensor:
    """True for real docs, False for the pad tail."""
    return torch.arange(num_docs_padded, dtype=torch.int32,
                        device=device) < num_docs


def and_masks(*ms: torch.Tensor) -> torch.Tensor:
    out = ms[0]
    for m in ms[1:]:
        out = out & m
    return out


def or_masks(*ms: torch.Tensor) -> torch.Tensor:
    out = ms[0]
    for m in ms[1:]:
        out = out | m
    return out


def not_mask(m: torch.Tensor) -> torch.Tensor:
    return ~m


# --- compare types ------------------------------------------------------------

_NP_OF_TORCH = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.uint16: np.uint16,
    torch.uint32: np.uint32, torch.uint64: np.uint64, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64,
}
_TORCH_OF_NP = {np.dtype(v): k for k, v in _NP_OF_TORCH.items()}
_SIGNED_OF_WIDTH = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def compare_dtype(a, b) -> np.dtype:
    """The type JAX computes `a <op> b` in, for two strongly typed numpy
    dtypes (its promotion lattice with 64-bit types enabled): bool below
    everything, unsigned and signed integers joining at the next signed
    width that holds both (u64 with any signed type at f64), every integer
    below every float."""
    a, b = np.dtype(a), np.dtype(b)
    if a == b:
        return a
    if a.kind == "b":
        return b
    if b.kind == "b":
        return a
    if a.kind == "f" or b.kind == "f":
        floats = [d for d in (a, b) if d.kind == "f"]
        return max(floats, key=lambda d: d.itemsize)
    if a.kind == b.kind:
        return max(a, b, key=lambda d: d.itemsize)
    signed, unsigned = (a, b) if a.kind == "i" else (b, a)
    if unsigned.itemsize < signed.itemsize:
        return signed
    if unsigned.itemsize == 8:
        return np.dtype(np.float64)
    return np.dtype(_SIGNED_OF_WIDTH[unsigned.itemsize * 2])


# FOR-packed u16/u32 lanes: torch's unsigned types beyond u8 lack most
# kernels, so they are read through their signed twins and widened
_UNSIGNED_LANES = {torch.uint16: (torch.int16, torch.int32, 0xFFFF),
                   torch.uint32: (torch.int32, torch.int64, 0xFFFFFFFF)}


def widened(arr: torch.Tensor, idx=None) -> torch.Tensor:
    """`arr` (gathered at `idx` when given) with u16/u32 lanes widened to
    the next signed type; other dtypes unchanged."""
    lane = _UNSIGNED_LANES.get(arr.dtype)
    if lane is None:
        return arr if idx is None else arr[idx]
    signed, wide, mask = lane
    lanes = arr.view(signed) if idx is None else arr.view(signed)[idx]
    return lanes.to(wide) & mask


def _u64_ordered(values: torch.Tensor) -> torch.Tensor:
    """u64 lanes as i64 in the same order (sign bit flipped): torch has no
    compare kernels for uint64."""
    return values.view(torch.int64) ^ (-(1 << 63))


def compare(values: torch.Tensor, bound, op: str) -> torch.Tensor:
    """`values <op> bound` (op one of ge, gt, le, lt) in the JAX compare
    type of the column and the numpy scalar `bound`. The bound enters as a
    host number of that type, never as a bare Python float against an
    integer tensor (which torch would compare in f32)."""
    bound = np.asarray(bound)
    ct = compare_dtype(_NP_OF_TORCH[values.dtype], bound.dtype)
    scalar = bound.astype(ct).item()
    values = widened(values).to(_TORCH_OF_NP[ct])
    if ct == np.uint64:
        values = _u64_ordered(values)
        scalar -= 1 << 63
    return getattr(values, op)(scalar)


def range_mask(values: torch.Tensor, present: torch.Tensor,
               lower, upper, lower_incl: bool, upper_incl: bool,
               has_lower: bool, has_upper: bool,
               zmin: torch.Tensor = None, zmax: torch.Tensor = None,
               zonemap_block: int = 512) -> torch.Tensor:
    """Range predicate over a numeric fast column.

    Block-sparse evaluation: with per-block zonemaps (`zmin`/`zmax`, one
    entry per `zonemap_block` doc lanes, in the same domain as `values`),
    the per-doc compare is gated by a block-level prequalification mask: a
    block whose [zmin, zmax] envelope cannot intersect the bounds
    contributes no lanes. Blocks with no present docs carry inverted
    sentinels and never qualify.
    """
    lo_op = "ge" if lower_incl else "gt"
    hi_op = "le" if upper_incl else "lt"
    if zmin is not None:
        blk_ok = torch.ones(zmin.shape, dtype=torch.bool, device=zmin.device)
        if has_lower:
            blk_ok = blk_ok & compare(zmax, lower, lo_op)
        if has_upper:
            blk_ok = blk_ok & compare(zmin, upper, hi_op)
        nb = zmin.shape[0]
        blocked = values.reshape(nb, zonemap_block)
        mask = blk_ok[:, None] & present.reshape(nb, zonemap_block).to(
            torch.bool)
        if has_lower:
            mask = mask & compare(blocked, lower, lo_op)
        if has_upper:
            mask = mask & compare(blocked, upper, hi_op)
        return mask.reshape(-1)
    mask = present.to(torch.bool)
    if has_lower:
        mask = mask & compare(values, lower, lo_op)
    if has_upper:
        mask = mask & compare(values, upper, hi_op)
    return mask


def minimum_should_match_mask(should_masks: list[torch.Tensor],
                              min_count: int) -> torch.Tensor:
    """At least `min_count` of the masks true (bool `should` semantics)."""
    counts = should_masks[0].to(torch.int32)
    for m in should_masks[1:]:
        counts = counts + m.to(torch.int32)
    return counts >= min_count


def dead_lane_mask(keyed: torch.Tensor) -> torch.Tensor:
    """Lanes whose higher-is-better sort key is -inf: non-matching docs,
    threshold-pruned lanes, and search_after-excluded lanes. These never
    surface through top-k, and the hit lists are meaningless past the live
    prefix."""
    return torch.isneginf(keyed)


def propagate_dead_lanes(keyed: torch.Tensor,
                         keyed2: torch.Tensor) -> torch.Tensor:
    """Kill the secondary sort key wherever the primary lane is dead, so
    the lexicographic two-key top-k cannot resurrect a pruned or excluded
    doc on the strength of its tiebreaker alone."""
    return torch.where(dead_lane_mask(keyed), float("-inf"), keyed2)
