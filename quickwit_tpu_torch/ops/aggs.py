"""Aggregation states: the device reductions and the host-side merge and
finalize helpers.

Role of the reference's aggregation path (tantivy aggregations driven by
`QuickwitAggregations`, `quickwit-search/src/collector.rs:600`, merged as
serialized intermediate results): each aggregation computes a fixed-shape
intermediate state on device that merges by elementwise addition (plus
min/max).

Counterpart of the JAX package's `ops/aggs.py`. Device half: bucket counts,
sums, minima and maxima, the stats state, the percentile sketches and the
HLL registers. Host half (numpy, what `search/collector.py` and
`search/plan.py` import): `merge_stats_states`, `sketch_quantiles`,
`hll_hash_bytes` and `hll_estimate`.

Every index outside [0, num_buckets) is dropped (the executor passes the
sentinel `num_buckets` for dropped docs). The JAX scatter forms wrap a
negative index instead; the executor never passes one.

Determinism on the card: the same inputs give the same bits on every run.
Integer counts and integer maxima are exact in any order (`index_add_` and
`scatter_reduce_` of ints). f64 sums never go through atomics: a
compare-and-reduce in fixed row chunks up to `_COMPARE_MAX_BUCKETS_METRIC`
buckets, a stable sort by bucket and a segment reduction above it. f64
minima and maxima reduce an order-preserving i64 key, so `-0.0 < +0.0`
whatever the order (the IEEE minimum and maximum, as XLA computes them) and
a NaN wins.
"""

from __future__ import annotations

import numpy as np
import torch


# Bucket spaces up to this size count by compare-and-reduce over a
# materialized [rows, num_buckets] predicate; larger ones scatter-add.
# Scatter-adds into a few buckets serialize on atomics to the same address:
# on the flagship's 8-bucket date_histogram and 4-bucket terms agg the
# scatter took most of the device time (PERF.md). The JAX package makes
# the same choice for the same reason (its `_COMPARE_MAX_BUCKETS`).
_COMPARE_MAX_BUCKETS = 64
# Metric reductions switch at the JAX package's limit.
_COMPARE_MAX_BUCKETS_METRIC = 64

# Bytes of one compare-and-reduce pass's [rows, num_buckets] operand: a
# dense pass over a 10M-doc split runs in chunks of rows, 64 MB each
# whatever the dtype, never the whole [docs, buckets] broadcast that XLA
# fuses away and torch would materialize (5 GB of f64 at 64 buckets).
_COMPARE_MAX_BYTES = 1 << 26

_LOW63 = (1 << 63) - 1      # every bit of an i64 lane but the sign


def _row_chunks(num_rows: int, num_buckets: int, itemsize: int):
    rows = max(1, _COMPARE_MAX_BYTES // (max(num_buckets, 1) * itemsize))
    return [(start, start + rows) for start in range(0, num_rows, rows)]


def _compare_reduce(idx: torch.Tensor, num_buckets: int,
                    operand: torch.Tensor, fill, reduce: str) -> torch.Tensor:
    """`reduce` ("sum", "amax" or "amin") over rows of
    `where(idx[:, None] == arange(num_buckets), operand[:, None], fill)`,
    in row chunks of `_COMPARE_MAX_BYTES`; the chunks combine in order."""
    buckets = torch.arange(num_buckets, dtype=idx.dtype, device=idx.device)
    combine = {"sum": torch.add, "amax": torch.maximum,
               "amin": torch.minimum}[reduce]
    out = None
    for start, stop in _row_chunks(idx.shape[0], num_buckets,
                                   operand.element_size()):
        eq = idx[start:stop, None] == buckets[None, :]
        part = getattr(torch.where(eq, operand[start:stop, None], fill),
                       reduce)(0)
        out = part if out is None else combine(out, part)
    if out is None:
        out = torch.full((num_buckets,), fill, dtype=operand.dtype,
                         device=operand.device)
    return out


def as_f64(values: torch.Tensor) -> torch.Tensor:
    """`values` as f64, rounded to nearest as JAX converts. u64 lanes (a
    packed u64 column rebases to them) convert through i64, since torch
    has no u64 arithmetic on every device: values past 2^63 halve with a
    sticky low bit, convert, and double, which rounds correctly."""
    if values.dtype != torch.uint64:
        return values.to(torch.float64)
    x = values.view(torch.int64)
    halved = ((x >> 1) & _LOW63) | (x & 1)
    return torch.where(x >= 0, x.to(torch.float64),
                       halved.to(torch.float64) * 2.0)


def _safe_index(idx: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """int64 indices with every index outside [0, num_buckets) sent to the
    spare lane `num_buckets` (CUDA asserts on an out-of-range scatter)."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < num_buckets), idx, num_buckets)


def bucket_counts(idx: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """int32 counts per bucket; `idx` holds an out-of-range sentinel (e.g.
    num_buckets) for dropped docs. Integer counts are exact in any order,
    and neither form needs a device→host sync (`torch.bincount` does)."""
    if num_buckets <= _COMPARE_MAX_BUCKETS:
        buckets = torch.arange(num_buckets, dtype=idx.dtype,
                               device=idx.device)
        counts = None
        for start, stop in _row_chunks(idx.shape[0], num_buckets, 1):
            part = (idx[start:stop, None] == buckets[None, :]).sum(
                0, dtype=torch.int32)
            counts = part if counts is None else counts.add_(part)
        if counts is None:
            counts = torch.zeros(num_buckets, dtype=torch.int32,
                                 device=idx.device)
        return counts
    safe = _safe_index(idx, num_buckets)
    ones = torch.ones(1, dtype=torch.int32, device=idx.device).expand(
        safe.shape[0])
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32, device=idx.device)
    return counts.index_add_(0, safe, ones)[:num_buckets]


def bucket_sum(idx: torch.Tensor, values: torch.Tensor,
               num_buckets: int) -> torch.Tensor:
    """Per-bucket f64 sums of `values` (docs with a dropped idx contribute
    0). Above the compare limit: a stable sort by bucket, then one segment
    reduction per bucket (no f64 atomics, so the bits repeat)."""
    values = as_f64(values)
    if num_buckets <= _COMPARE_MAX_BUCKETS_METRIC:
        return _compare_reduce(idx, num_buckets, values, 0.0, "sum")
    safe = _safe_index(idx, num_buckets)
    order = torch.argsort(safe, stable=True)
    lengths = torch.zeros(num_buckets + 1, dtype=torch.int64,
                          device=idx.device).index_add_(
        0, safe, torch.ones_like(safe))
    sums = torch.segment_reduce(values[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)
    return sums[:num_buckets]


# f64 ↔ i64 keys whose integer order is the IEEE total order (-NaN < -inf <
# ... < -0.0 < +0.0 < ... < +inf < +NaN). The NaNs are re-keyed past every
# number so that a reduction returns NaN when one is present: +NaN beyond
# -NaN, so a bucket holding only one sign of NaN gets that NaN back.
_KEY_MAX = _LOW63
_KEY_MIN = -(1 << 63)
_POS_NAN_BITS = 0x7FF8000000000000
_NEG_NAN_BITS = 0xFFF8000000000000 - (1 << 64)


def _order_key(values: torch.Tensor, largest: bool) -> torch.Tensor:
    bits = values.view(torch.int64)
    key = bits ^ ((bits >> 63) & _LOW63)
    neg = bits < 0
    if largest:
        nan_key = torch.where(neg, _KEY_MAX - 1, _KEY_MAX)
    else:
        nan_key = torch.where(neg, _KEY_MIN + 1, _KEY_MIN)
    return torch.where(torch.isnan(values), nan_key, key)


def _from_order_key(key: torch.Tensor) -> torch.Tensor:
    bits = key ^ ((key >> 63) & _LOW63)
    bits = torch.where((key == _KEY_MAX) | (key == _KEY_MIN), _POS_NAN_BITS,
                       bits)
    bits = torch.where((key == _KEY_MAX - 1) | (key == _KEY_MIN + 1),
                       _NEG_NAN_BITS, bits)
    return bits.view(torch.float64)


def _fill_key(value: float) -> int:
    bits = int(np.float64(value).view(np.int64))
    return bits ^ ((bits >> 63) & _LOW63)


_KEY_POS_INF = _fill_key(float("inf"))
_KEY_NEG_INF = _fill_key(float("-inf"))


def _bucket_extreme(idx: torch.Tensor, values: torch.Tensor,
                    num_buckets: int, largest: bool) -> torch.Tensor:
    key = _order_key(as_f64(values), largest)
    fill = _KEY_NEG_INF if largest else _KEY_POS_INF
    if num_buckets <= _COMPARE_MAX_BUCKETS_METRIC:
        out = _compare_reduce(idx, num_buckets, key, fill,
                              "amax" if largest else "amin")
    else:
        safe = _safe_index(idx, num_buckets)
        out = torch.full((num_buckets + 1,), fill, dtype=torch.int64,
                         device=idx.device).scatter_reduce_(
            0, safe, key, "amax" if largest else "amin")[:num_buckets]
    return _from_order_key(out)


def bucket_min(idx: torch.Tensor, values: torch.Tensor,
               num_buckets: int) -> torch.Tensor:
    """Per-bucket f64 minima (+inf for an empty bucket)."""
    return _bucket_extreme(idx, values, num_buckets, largest=False)


def bucket_max(idx: torch.Tensor, values: torch.Tensor,
               num_buckets: int) -> torch.Tensor:
    """Per-bucket f64 maxima (-inf for an empty bucket)."""
    return _bucket_extreme(idx, values, num_buckets, largest=True)


def masked_extreme(values: torch.Tensor, mask: torch.Tensor,
                   largest: bool) -> torch.Tensor:
    """0-dim f64 max (or min) of `values` over `mask`; -inf (or +inf)
    when the mask is empty."""
    key = _order_key(as_f64(values), largest)
    if largest:
        key = torch.where(mask, key, _KEY_NEG_INF).amax()
    else:
        key = torch.where(mask, key, _KEY_POS_INF).amin()
    return _from_order_key(key)


# --- stats -----------------------------------------------------------------

def stats_state(values: torch.Tensor, present: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """[count, sum, sum_sq, min, max] as float64 — elementwise-mergeable
    (first three add; min/max combine)."""
    m = mask & present.to(torch.bool)
    vals = as_f64(values)
    count = m.sum().to(torch.float64)
    s = torch.where(m, vals, 0.0).sum()
    s2 = torch.where(m, vals * vals, 0.0).sum()
    return torch.stack([count, s, s2, masked_extreme(vals, m, False),
                        masked_extreme(vals, m, True)])


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
_PCTL_LN_GAMMA = float(np.log(PCTL_GAMMA))
_F64_TINY = float(np.finfo(np.float64).tiny)     # smallest normal f64


def percentile_sketch(values: torch.Tensor, present: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """DDSketch bucket counts [PCTL_NUM_BUCKETS] int32.

    Positive values (durations, sizes); merge = elementwise add."""
    m = mask & present.to(torch.bool)
    bucket = torch.where(m, _pctl_bucket(values), PCTL_NUM_BUCKETS)
    return bucket_counts(bucket, PCTL_NUM_BUCKETS)


def _pctl_bucket(values: torch.Tensor) -> torch.Tensor:
    """Value → DDSketch bucket index (shared by the global and per-bucket
    sketch builders so their resolution can never drift).

    The JAX program converts `k` to i32 with XLA's saturating conversion
    and adds the offset in wrapping i32 arithmetic, so +inf (k saturates to
    2^31 - 1, the add wraps negative) lands in bucket 1; this does the
    same explicitly. XLA's CPU backend compares with subnormals read as
    zero (DAZ), so a positive subnormal is not positive there: it lands in
    the underflow bucket here too."""
    v = as_f64(values)
    positive = v >= _F64_TINY
    ln_gamma = torch.tensor(_PCTL_LN_GAMMA, dtype=torch.float64,
                            device=v.device)
    k = torch.ceil(torch.log(torch.clamp(v, min=1e-300)) / ln_gamma)
    k = torch.clamp(torch.where(positive, k, 0.0), -2.0**31, 2.0**31 - 1)
    idx = k.to(torch.int64) - PCTL_K_MIN + 1
    idx = ((idx + 2**31) & (2**32 - 1)) - 2**31          # i32 wraparound
    idx = torch.clamp(idx, 1, PCTL_NUM_BUCKETS - 1).to(torch.int32)
    return torch.where(positive, idx, 0)


def bucket_percentile_sketch(idx: torch.Tensor, values: torch.Tensor,
                             num_buckets: int) -> torch.Tensor:
    """Per-bucket sketches [num_buckets, PCTL_NUM_BUCKETS] int32: one
    integer scatter-add into the flattened [nb * PCTL] space."""
    sb = _pctl_bucket(values).to(torch.int64)
    idx = idx.to(torch.int64)
    flat = torch.where((idx >= 0) & (idx < num_buckets),
                       idx * PCTL_NUM_BUCKETS + sb,
                       num_buckets * PCTL_NUM_BUCKETS)
    return bucket_counts(flat, num_buckets * PCTL_NUM_BUCKETS).reshape(
        num_buckets, PCTL_NUM_BUCKETS)


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
_HLL_P = 8


def hll_hash_bytes(data: bytes) -> int:
    """Host-side hashing of term strings so that identical terms hash
    identically across splits regardless of their ordinals: 64-bit
    FNV-1a + the splitmix64 finalizer. The finalizer is ESSENTIAL —
    HLL's register index is the hash's TOP bits, and raw FNV-1a of
    short, similar terms ("svc0".."svc6") barely diffuses trailing-byte
    differences upward, collapsing every term into one register (a
    cardinality of ~1). The numeric path applies the same finalizer on
    device (`_hll_mix64`)."""
    h = 0xcbf29ce484222325
    for b in data:
        h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    # splitmix64 finalizer (keep in lockstep with _hll_mix64)
    h = ((h ^ (h >> 30)) * 0xbf58476d1ce4e5b9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94d049bb133111eb) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


# u64 arithmetic in i64 lanes (torch has no u64 multiply or shift): xor,
# multiply and left shift give the same bits; a right shift is arithmetic,
# so every one is masked to a logical shift.
_MIX1 = 0xbf58476d1ce4e5b9 - (1 << 64)
_MIX2 = 0x94d049bb133111eb - (1 << 64)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in i64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def value_bits(values: torch.Tensor) -> torch.Tensor:
    """The 64-bit value pattern as i64 lanes: an f64 column bitcast, a u64
    column reinterpreted, any other integer column widened to i64 (the JAX
    package's `values.astype(int64).astype(uint64)`)."""
    if values.dtype in (torch.float64, torch.uint64):
        return values.view(torch.int64)
    return values.to(torch.int64)


def _hll_mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on u64 bits held in i64 (keep in lockstep with
    `hll_hash_bytes`)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def _hll_reg_rho(hashes: torch.Tensor, valid: torch.Tensor):
    """(register index, rho) per doc: register = top p hash bits, rho =
    1 + leading zeros of the suffix (capped at 64 - p). Invalid docs get
    rho 0 and the out-of-range register sentinel."""
    reg = _shr(hashes, 64 - _HLL_P).to(torch.int32)
    x = hashes << _HLL_P
    clz = torch.zeros(hashes.shape, dtype=torch.int32, device=hashes.device)
    for shift in (32, 16, 8, 4, 2, 1):       # branchless binary clz
        zero_hi = _shr(x, 64 - shift) == 0
        clz = clz + torch.where(zero_hi, shift, 0).to(torch.int32)
        x = torch.where(zero_hi, x << shift, x)
    rho = torch.clamp(clz + 1, max=64 - _HLL_P).to(torch.int32)
    rho = torch.where(valid, rho, 0)
    reg = torch.where(valid, reg, HLL_NUM_REGISTERS)
    return reg, rho


def hll_registers(hashes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[HLL_NUM_REGISTERS] int32 register vector (max of rho per
    register). `hashes` u64 bits in i64 per doc, `valid` bool per doc. An
    integer scatter-max: exact in any order."""
    reg, rho = _hll_reg_rho(hashes, valid)
    out = torch.zeros(HLL_NUM_REGISTERS + 1, dtype=torch.int32,
                      device=hashes.device)
    return out.scatter_reduce_(0, reg.to(torch.int64), rho,
                               "amax")[:HLL_NUM_REGISTERS]


def bucket_hll_registers(idx: torch.Tensor, hashes: torch.Tensor,
                         valid: torch.Tensor,
                         num_buckets: int) -> torch.Tensor:
    """Per-bucket HLL registers [num_buckets, HLL_NUM_REGISTERS] int32 —
    cardinality as a bucket sub-metric: one scatter-max into the flattened
    [nb * registers] space."""
    reg, rho = _hll_reg_rho(hashes, valid)
    idx = idx.to(torch.int64)
    ok = valid & (idx >= 0) & (idx < num_buckets)
    space = num_buckets * HLL_NUM_REGISTERS
    flat = torch.where(ok, idx * HLL_NUM_REGISTERS + reg, space)
    out = torch.zeros(space + 1, dtype=torch.int32, device=hashes.device)
    return out.scatter_reduce_(0, flat, rho, "amax")[:space].reshape(
        num_buckets, HLL_NUM_REGISTERS)


def hll_from_numeric(values: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """Registers for a numeric column: hash the 64-bit value pattern."""
    return hll_registers(_hll_mix64(value_bits(values)), valid)


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
