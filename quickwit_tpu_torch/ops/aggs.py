"""Aggregation states: the device bucket counts and the host-side merge and
finalize helpers.

Role of the reference's aggregation path (tantivy aggregations driven by
`QuickwitAggregations`, `quickwit-search/src/collector.rs:600`, merged as
serialized intermediate results): each aggregation computes a fixed-shape
intermediate state on device that merges by elementwise addition (plus
min/max).

Subset of the JAX package's `ops/aggs.py`. Device half: `bucket_counts`,
the one device aggregation that terms, histogram and date_histogram bucket
counts need. Host half (numpy, what `search/collector.py` and
`search/plan.py` import): `merge_stats_states`, the percentile sketch
constants and `sketch_quantiles`, `hll_hash_bytes` and `hll_estimate`.
Bucket metrics, percentile sketches and HLL registers on device are not
carried over yet.
"""

from __future__ import annotations

import numpy as np
import torch


# Bucket spaces up to this size count by compare-and-reduce over a
# materialized [P, num_buckets] predicate (at most 64 bytes per posting);
# larger ones scatter-add. Scatter-adds into a few buckets serialize on
# atomics to the same address: on the flagship's 8-bucket date_histogram
# and 4-bucket terms agg the scatter took most of the device time (PERF.md).
# The JAX package makes the same choice for the same reason (its
# `_COMPARE_MAX_BUCKETS`).
_COMPARE_MAX_BUCKETS = 64

# Elements of one compare-and-reduce pass's [rows, num_buckets] predicate:
# a dense doc-space pass over a 10M-doc split runs in chunks of rows, so
# the predicate stays at 64 MB.
_COMPARE_MAX_ELEMENTS = 1 << 26


def bucket_counts(idx: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """int32 counts per bucket; `idx` holds an out-of-range sentinel (e.g.
    num_buckets) for dropped docs, and every index outside
    [0, num_buckets) is dropped. Integer counts are exact in any order, and
    neither form needs a device→host sync (`torch.bincount` does)."""
    if num_buckets <= _COMPARE_MAX_BUCKETS:
        buckets = torch.arange(num_buckets, dtype=idx.dtype,
                               device=idx.device)
        rows = max(1, _COMPARE_MAX_ELEMENTS // max(num_buckets, 1))
        counts = (idx[:rows, None] == buckets[None, :]).sum(
            0, dtype=torch.int32)
        for start in range(rows, idx.shape[0], rows):
            counts += (idx[start:start + rows, None] == buckets[None, :]).sum(
                0, dtype=torch.int32)
        return counts
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < num_buckets)
    safe = torch.where(ok, idx, num_buckets)
    ones = torch.ones(1, dtype=torch.int32, device=idx.device).expand(
        safe.shape[0])
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32, device=idx.device)
    return counts.index_add_(0, safe, ones)[:num_buckets]


def merge_stats_states(a, b) -> np.ndarray:
    """Merge two `stats_state` partials ([count, sum, sum_sq, min, max]).

    The first three components add, min/max combine — which is what makes the
    per-split partials a pure fixed-shape reduction (associative and
    commutative), mergeable host-side at the collector or on device under
    `psum`. Operates on host numpy (post-readback partials)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.array([a[0] + b[0], a[1] + b[1], a[2] + b[2],
                     min(a[3], b[3]), max(a[4], b[4])])


# --- percentiles (DDSketch-compatible log buckets) ------------------------

PCTL_ALPHA = 0.01
PCTL_GAMMA = (1.0 + PCTL_ALPHA) / (1.0 - PCTL_ALPHA)
PCTL_K_MIN = -1100   # v ≈ 2.8e-10
PCTL_K_MAX = 1500    # v ≈ 1.1e13
PCTL_NUM_BUCKETS = PCTL_K_MAX - PCTL_K_MIN + 2  # +underflow bucket 0


def sketch_quantiles(counts: np.ndarray, quantiles: list[float]) -> list[float]:
    """Host-side quantile estimation from a (merged) sketch."""
    counts = np.asarray(counts)
    total = counts.sum()
    if total == 0:
        return [float("nan")] * len(quantiles)
    cum = np.cumsum(counts)
    out = []
    for q in quantiles:
        # DDSketch (sketches-ddsketch crate, used by tantivy) rank rule:
        # rank = floor(q·(n-1)), return the first bucket whose cumulative
        # count strictly exceeds it — i.e. the 0-based rank-th item.
        # (p85 of {30,130} → 30's bucket, median of 5 → the 3rd item.)
        rank = int(np.floor(q * (total - 1)))
        target = min(rank + 1, int(total))
        bucket = int(np.searchsorted(cum, target, side="left"))
        bucket = min(bucket, len(counts) - 1)
        if bucket == 0:
            out.append(0.0)
        else:
            k = bucket + PCTL_K_MIN - 1
            out.append(2.0 * PCTL_GAMMA ** k / (PCTL_GAMMA + 1.0))
    return out


# --- cardinality (HyperLogLog) ---------------------------------------------

HLL_NUM_REGISTERS = 256


def hll_hash_bytes(data: bytes) -> int:
    """Host-side hashing of term strings so that identical terms hash
    identically across splits regardless of their ordinals: 64-bit
    FNV-1a + the splitmix64 finalizer. The finalizer is ESSENTIAL —
    HLL's register index is the hash's TOP bits, and raw FNV-1a of
    short, similar terms ("svc0".."svc6") barely diffuses trailing-byte
    differences upward, collapsing every term into one register (a
    cardinality of ~1). The numeric path applies the same finalizer on
    device (`_hll_mix64` in the JAX package)."""
    h = 0xcbf29ce484222325
    for b in data:
        h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    # splitmix64 finalizer (the JAX package's _hll_mix64 applies the same)
    h = ((h ^ (h >> 30)) * 0xbf58476d1ce4e5b9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94d049bb133111eb) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


def hll_estimate(registers: np.ndarray) -> float:
    """Classic HLL estimate with small-range (linear counting) correction."""
    registers = np.asarray(registers, dtype=np.float64)
    m = float(HLL_NUM_REGISTERS)
    alpha = 0.7213 / (1 + 1.079 / m)
    harmonic = np.sum(np.exp2(-registers))
    estimate = alpha * m * m / harmonic
    zeros = float(np.sum(registers == 0))
    if estimate <= 2.5 * m and zeros > 0:
        estimate = m * np.log(m / zeros)
    return float(estimate)
