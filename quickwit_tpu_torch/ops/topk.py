"""Top-K hit collection over per-doc or per-posting key arrays.

Role of the reference's segment top-K collectors
(`quickwit-search/src/top_k_collector.rs`): top-K by a unified
higher-is-better f64 key, ties broken by **ascending index**, which is
`lax.top_k`'s lowest-index-wins rule in the JAX package.

Subset of the JAX package's `ops/topk.py`: the constants, `exact_topk` and
`_pad_to_block`. `torch.topk` promises no order among equal keys, so every
selection here is a stable descending sort (equal keys keep ascending
index). The JAX package's `guided_topk` returns what `exact_topk` returns;
this package runs exact only.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")

# bottom sentinel for matching-but-missing sort values; MUST be the same
# constant everywhere (executor keying, leaf decode, search_after markers)
MISSING_VALUE_SENTINEL = -1.7976931348623157e308

_BLOCK = 1024  # == index.format.DOC_PAD, so dense doc arrays always divide


def _stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, equal
    values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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


def exact_topk(x: torch.Tensor, k: int):
    """Exact top-k, blockwise two-stage: per-block top-k over [G, 1024]
    blocks, then top-k of the G*k winners. Every global winner is a block
    winner, and the flattened (block, rank) order equals index order for
    equal keys, so the result equals one stable sort of the whole operand.
    Returns (values, int64 positions)."""
    n = x.shape[0]
    if n % _BLOCK != 0:
        padded = _pad_to_block(x, k)
        if padded is not None:
            x = padded
            n = x.shape[0]
    if n % _BLOCK == 0 and k <= _BLOCK and n // _BLOCK >= 2:
        grid = n // _BLOCK
        vals, idx = _stable_topk(x.reshape(grid, _BLOCK), min(k, _BLOCK))
        base = torch.arange(grid, dtype=torch.int64, device=x.device) * _BLOCK
        flat_idx = (base[:, None] + idx).reshape(-1)
        top_vals, pos = _stable_topk(vals.reshape(-1), k)
        return top_vals, flat_idx[pos]
    return _stable_topk(x, k)
