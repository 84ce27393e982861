"""Top-K hit collection over per-doc or per-posting key arrays.

Role of the reference's segment top-K collectors
(`quickwit-search/src/top_k_collector.rs`): top-K by a unified
higher-is-better f64 key, ties broken by **ascending index**, which is
`lax.top_k`'s lowest-index-wins rule in the JAX package.

Counterpart of the JAX package's `ops/topk.py`: the constants,
`exact_topk`, `exact_topk_2key`, `apply_threshold_mask`,
`block_max_threshold_mask` and `_pad_to_block`. The JAX package's
`guided_topk` (an f32 screen that re-dispatches through `exact_topk`
whenever it cannot certify the answer) is not carried over; this package
runs exact only. (Its certificate compares `-0.0` and `+0.0` equal, so
where both zeros meet a cut it can answer differently from `exact_topk`.)

The two JAX selections order floats differently, and each is reproduced on
integer keys, which every torch backend sorts the same way:
- `lax.top_k` (single key) ranks by the IEEE total order: +NaN first,
  `+0.0` above `-0.0`, -NaN last.
- `lax.sort` (`exact_topk_2key`, ascending over negated keys) compares
  `-0.0` equal to `+0.0` and every NaN equal to the others, after +inf.
A float sort would not do: torch's CPU sort ranks the zeros equal and
NaN at one end, and a radix sort on the GPU ranks them by their bits.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")

# bottom sentinel for matching-but-missing sort values; MUST be the same
# constant everywhere (executor keying, leaf decode, search_after markers)
MISSING_VALUE_SENTINEL = -1.7976931348623157e308

_BLOCK = 1024  # == index.format.DOC_PAD, so dense doc arrays always divide

_INT_OF_FLOAT = {torch.float64: torch.int64, torch.float32: torch.int32}


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Integer key whose signed order is the IEEE total order of `x`: the
    magnitude bits of negative values are flipped, so -NaN < -inf < ... <
    -0.0 < +0.0 < ... < +inf < +NaN."""
    bits = x.contiguous().view(_INT_OF_FLOAT[x.dtype])
    magnitude = torch.iinfo(bits.dtype).max
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & magnitude)


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """Integer key in `lax.sort`'s float order: the total order after
    every zero becomes +0.0 and every NaN the one canonical NaN."""
    key = _total_order_key(x)
    key = torch.where(x == 0, 0, key)
    return torch.where(torch.isnan(x), torch.iinfo(key.dtype).max, key)


def _desc(keys: torch.Tensor) -> torch.Tensor:
    """Indices of a stable descending sort along the last axis."""
    return torch.sort(keys, dim=-1, descending=True, stable=True)[1]


def _asc(keys: torch.Tensor) -> torch.Tensor:
    """Indices of a stable ascending sort along the last axis."""
    return torch.sort(keys, dim=-1, stable=True)[1]


def _pad_to_block(x: torch.Tensor, k: int):
    """Pad `x` with -inf lanes up to a _BLOCK multiple so the blockwise
    two-stage applies to any operand length.

    Exact: pad lanes hold -inf at the highest indices, so every real lane
    ranks at or above every pad lane and lowest-index-wins ties resolve
    inside the real prefix; with k <= n no pad index can surface in the
    top-k. Returns None when padding wouldn't enable the blockwise path
    (tiny operand or k > _BLOCK)."""
    n = x.shape[0]
    rem = n % _BLOCK
    if rem == 0 or k > _BLOCK or k > n or (n + _BLOCK - rem) // _BLOCK < 2:
        return None
    pad = _BLOCK - rem
    return torch.cat([x, torch.full((pad,), NEG_INF, dtype=x.dtype,
                                    device=x.device)])


def _blockwise(n: int, k: int) -> bool:
    return n % _BLOCK == 0 and k <= _BLOCK and n // _BLOCK >= 2


def _block_base(grid: int, device) -> torch.Tensor:
    return torch.arange(grid, dtype=torch.int64, device=device)[:, None] \
        * _BLOCK


def exact_topk(x: torch.Tensor, k: int):
    """Exact top-k in `lax.top_k`'s order, blockwise two-stage: per-block
    top-k over [G, 1024] blocks, then top-k of the G*k winners. Every
    global winner is a block winner, and the flattened (block, rank) order
    equals index order for equal keys, so the result equals one stable
    sort of the whole operand. Returns (values, int64 positions)."""
    n = x.shape[0]
    if n % _BLOCK != 0:
        padded = _pad_to_block(x, k)
        if padded is not None:
            x = padded
            n = x.shape[0]
    keys = _total_order_key(x)
    if _blockwise(n, k):
        grid = n // _BLOCK
        idx = _desc(keys.reshape(grid, _BLOCK))[:, :k]
        flat_idx = (_block_base(grid, x.device) + idx).reshape(-1)
        pos = flat_idx[_desc(keys[flat_idx])[:k]]
    else:
        pos = _desc(keys)[:k]
    return x[pos], pos


def exact_topk_2key(key1: torch.Tensor, key2: torch.Tensor, k: int):
    """Exact lexicographic top-k by (key1, key2) descending, index-ascending
    tie-break, in the order of the JAX program's `lax.sort` of the negated
    keys: two stable ascending sorts, secondary key first. Blockwise
    two-stage like `exact_topk`: every global winner under a lexicographic
    order is also a block winner.

    Returns (key1_top[k], key2_top[k], int64 positions[k])."""
    n = key1.shape[0]
    if n % _BLOCK != 0:
        p1 = _pad_to_block(key1, k)
        if p1 is not None:
            # pad lanes are (-inf, -inf) at the highest indices: they lose
            # the lexicographic tie-break to every real lane
            key1 = p1
            key2 = torch.cat([key2, torch.full((p1.shape[0] - n,), NEG_INF,
                                               dtype=key2.dtype,
                                               device=key2.device)])
            n = key1.shape[0]
    a, b = _sort_key(-key1), _sort_key(-key2)

    def lexsort(a, b):
        by_b = _asc(b)
        return by_b.gather(-1, _asc(a.gather(-1, by_b)))

    if _blockwise(n, k):
        grid = n // _BLOCK
        idx = lexsort(a.reshape(grid, _BLOCK), b.reshape(grid, _BLOCK))
        flat_idx = (_block_base(grid, key1.device) + idx[:, :k]).reshape(-1)
        pos = flat_idx[lexsort(a[flat_idx], b[flat_idx])[:k]]
    else:
        pos = lexsort(a, b)[:k]
    return key1[pos], key2[pos], pos


def apply_threshold_mask(keyed: torch.Tensor, threshold) -> torch.Tensor:
    """Dynamic top-K pruning mask: lanes whose higher-is-better key is
    STRICTLY below `threshold` (an f64 host scalar, the collector's current
    k-th sort value) become -inf, so top-k never surfaces them.

    `>=` keeps threshold-tying docs: a tie on the primary key can still win
    the (sort_value2, split_id, doc_id) tie-break at the collector."""
    return torch.where(keyed >= float(threshold), keyed, NEG_INF)


def block_max_threshold_mask(keyed: torch.Tensor, block_bounds: torch.Tensor,
                             threshold) -> torch.Tensor:
    """Impact block-max early exit (format v3): mask whole blocks of the
    posting-space key whose quantized score upper bound cannot reach the
    pushed-down threshold. `block_bounds` is the per-block f64 bound from
    `bm25.dequantize_block_bounds`, one entry per `keyed.shape[0] //
    nblocks` lanes; score-descending sorts only (the bound bounds the key
    only when key == score). The bound is sound, so a masked block held no
    lane that `apply_threshold_mask` would keep."""
    nb = block_bounds.shape[0]
    blocks = keyed.reshape(nb, keyed.shape[0] // nb)
    live = (block_bounds >= float(threshold))[:, None]
    return torch.where(live, blocks, NEG_INF).reshape(-1)
