"""The port's device aggregation functions (`quickwit_tpu_torch/ops/aggs.py`)
against the JAX package's (`quickwit_tpu/ops/aggs.py`), on seeded numpy
inputs handed to both.

Tolerances:
- exact: every count, minimum and maximum (bit for bit, signed zeros
  included), sketch counter and HLL register, and f64 sums of integer
  values whose exact total is below 2^53;
- `rtol=1e-12`: other f64 sums (XLA's CPU reduction order is not torch's,
  so a sum's last bits may differ once a partial sum is not an integer
  below 2^53).

Bucket counts cover both sides of the compare/scatter limit (64 buckets).
Negative indices drop in the port in both forms; the JAX compare form
drops them too, its scatter form wraps them (numpy indexing), which the
executor never relies on: it sends every dropped doc to the sentinel
`num_buckets`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.ops import aggs as J
from quickwit_tpu_torch.ops import aggs as T

NUM_BUCKETS = [1, 7, 64, 65, 700]
NUM_ROWS = 20_000


def _both(name, *args):
    """(JAX result as numpy, port result as numpy) of one function."""
    want = np.asarray(getattr(J, name)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(T, name)(*[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args]).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    return want, got


def _bits_equal(want, got):
    """Equal bit for bit (signed zeros and NaN included)."""
    assert want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.int64 if want.itemsize == 8
                                            else np.int32),
                                  got.view(np.int64 if got.itemsize == 8
                                           else np.int32))


def _inputs(nb, kind, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, nb + 2, NUM_ROWS).astype(np.int32)   # + sentinels
    if kind == "int":
        values = rng.randint(-10**6, 10**6, NUM_ROWS).astype(np.int64)
    else:
        values = rng.standard_normal(NUM_ROWS) * 1e3
    return idx, values


@pytest.mark.parametrize("kind", ["int", "f64"])
@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_bucket_sum_matches_jax(nb, kind):
    idx, values = _inputs(nb, kind, nb)
    want, got = _both("bucket_sum", idx, values, nb)
    if kind == "int":       # integer totals far below 2^53: exact
        _bits_equal(want, got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fn", ["bucket_min", "bucket_max"])
@pytest.mark.parametrize("kind", ["int", "f64"])
@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_bucket_extremes_match_jax(fn, nb, kind):
    idx, values = _inputs(nb, kind, 1000 + nb)
    _bits_equal(*_both(fn, idx, values, nb))


@pytest.mark.parametrize("fn", ["bucket_sum", "bucket_min", "bucket_max",
                                "bucket_counts"])
@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_negative_and_sentinel_indices_drop(fn, nb):
    """-1, -nb and the sentinels nb and nb + 1 contribute nothing. The JAX
    compare form (nb <= 64) drops them too; the JAX scatter form is held
    on the same input with the negatives sent to the sentinel."""
    idx, values = _inputs(nb, "int", 2000 + nb)
    idx[::5] = -1
    idx[1::7] = -nb
    args = (values, nb) if fn != "bucket_counts" else (nb,)
    got = getattr(T, fn)(torch.from_numpy(idx), *[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args]).numpy()
    j_idx = idx if nb <= 64 else np.where(idx < 0, nb, idx).astype(np.int32)
    want = np.asarray(getattr(J, fn)(jnp.asarray(j_idx), *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    _bits_equal(want, got)


def _zeros_nan_column(n, seed):
    rng = np.random.RandomState(seed)
    values = rng.choice([-0.0, 0.0, 1.5, -2.5], n)
    return values


@pytest.mark.parametrize("fn", ["bucket_min", "bucket_max"])
@pytest.mark.parametrize("nb", [7, 700])
@pytest.mark.parametrize("layout", ["zeros", "zeros_and_nan",
                                    "negative_nan"])
def test_extremes_of_signed_zeros_and_nan_match_jax(fn, nb, layout):
    """XLA takes the IEEE minimum and maximum: -0.0 < +0.0 whatever the
    order, and a NaN wins. Buckets hold only zeros of both signs (in both
    orders), or zeros and one NaN of either sign."""
    n = 4000
    idx = np.random.RandomState(nb).randint(0, nb, n).astype(np.int32)
    values = np.where(np.arange(n) % 2 == 0, -0.0, 0.0)
    values[idx % 2 == 1] = values[idx % 2 == 1][::-1]
    if layout != "zeros":
        nan = -np.nan if layout == "negative_nan" else np.nan
        first = {}
        for row, bucket in enumerate(idx):
            first.setdefault(int(bucket), row)
        for bucket, row in first.items():
            if bucket % 3 == 0:
                values[row] = nan
    _bits_equal(*_both(fn, idx, values, nb))


@pytest.mark.parametrize("layout", ["small_ints", "large_ints", "zeros",
                                    "zeros_and_nan", "negative_nan",
                                    "all_masked"])
def test_stats_state_matches_jax(layout):
    """[count, sum, sum_sq, min, max]: exact, except sum_sq of the large
    integers (~1e18 per square, past 2^53), held to rtol=1e-12."""
    rng = np.random.RandomState(5)
    n = 30_000
    if layout == "small_ints":        # every square and sum below 2^53
        values = rng.randint(-10**5, 10**5, n).astype(np.int64)
    elif layout == "large_ints":
        values = rng.randint(-10**9, 10**9, n).astype(np.int64)
    else:
        values = _zeros_nan_column(n, 6)
        if layout == "zeros_and_nan":
            values[123] = np.nan
        elif layout == "negative_nan":
            values[4567] = -np.nan
        elif layout == "zeros":
            values = np.where(values > 0, 0.0, -0.0)
    present = (rng.rand(n) < 0.9).astype(np.uint8)
    mask = rng.rand(n) < (0.0 if layout == "all_masked" else 0.7)
    want, got = _both("stats_state", values, present, mask)
    if layout == "large_ints":
        np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=0)
        want, got = np.delete(want, 2), np.delete(got, 2)
    _bits_equal(want, got)


def _percentile_edges():
    gamma = J.PCTL_GAMMA
    boundaries = np.round(gamma ** np.arange(0, 1400, 7))
    near = np.concatenate([boundaries - 1, boundaries, boundaries + 1])
    specials = np.array([0.0, -0.0, -1.0, -1e300, 1e-300, 2.8e-10, 1e-12,
                         5e-324, 2.2e-308, 1e13, 1.1e13, 1.2e13, 1e20,
                         1.7976931348623157e308, np.inf, -np.inf, np.nan,
                         1.0, 100.0, 2.0 * gamma ** 5 / (gamma + 1.0)])
    return np.concatenate([specials, near[near > 0]])


@pytest.mark.parametrize("corpus", ["lognormal", "edges", "integers"])
def test_percentile_sketch_matches_jax(corpus):
    """Sketch counters are exact: no value lands in another bucket. The
    edges include the clip at PCTL_K_MAX, +inf (bucket 1: XLA saturates the
    i32 conversion and the offset wraps), a subnormal (XLA reads it as
    zero) and integers next to round(gamma^k)."""
    rng = np.random.RandomState(7)
    if corpus == "lognormal":        # otel span durations, micros
        values = np.exp(rng.normal(9.0, 1.5, 50_000)).astype(np.int64) + 1
    elif corpus == "integers":
        values = rng.randint(-5, 10**7, 50_000).astype(np.int64)
    else:
        values = _percentile_edges()
    present = (rng.rand(values.shape[0]) < 0.95).astype(np.uint8)
    mask = rng.rand(values.shape[0]) < 0.9
    want, got = _both("percentile_sketch", values, present, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T._pctl_bucket(torch.from_numpy(values)).numpy(),
        np.asarray(J._pctl_bucket(jnp.asarray(values))))


@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_bucket_percentile_sketch_matches_jax(nb):
    rng = np.random.RandomState(nb)
    idx = rng.randint(0, nb + 1, NUM_ROWS).astype(np.int32)
    values = np.exp(rng.normal(9.0, 1.5, NUM_ROWS))
    edges = _percentile_edges()
    values[:len(edges)] = edges
    want, got = _both("bucket_percentile_sketch", idx, values, nb)
    np.testing.assert_array_equal(got, want)


def _hashes(n, seed):
    """Random u64 hashes (half with the top bit set), plus all-zero and
    single-bit suffixes."""
    rng = np.random.RandomState(seed)
    hashes = rng.randint(0, 2**63, n, dtype=np.int64).view(np.uint64)
    hashes[::2] |= np.uint64(1 << 63)
    hashes[:64] = np.uint64(0)                  # suffix 0: rho capped at 56
    hashes[64:128] = (np.arange(64, dtype=np.uint64) << np.uint64(56))
    hashes[128:184] = np.uint64(1) << np.arange(56, dtype=np.uint64)
    hashes[184] = np.uint64(2**64 - 1)
    return hashes


def test_hll_mix64_matches_jax_and_the_host_hash():
    bits = _hashes(5000, 1)
    want = np.asarray(J._hll_mix64(jnp.asarray(bits)))
    got = T._hll_mix64(torch.from_numpy(bits.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)
    # the device finalizer is the host hash's: mix64(fnv1a(term))
    for term in (b"svc0", b"svc1", b"", b"\xff" * 9):
        fnv = 0xcbf29ce484222325
        for b in term:
            fnv = ((fnv ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        x = torch.tensor([np.uint64(fnv).view(np.int64)])
        assert (int(T._hll_mix64(x)[0]) & (2**64 - 1)
                == T.hll_hash_bytes(term) == J.hll_hash_bytes(term))


@pytest.mark.parametrize("valid_share", [1.0, 0.6, 0.0])
def test_hll_registers_match_jax(valid_share):
    hashes = _hashes(20_000, 2)
    valid = np.random.RandomState(3).rand(hashes.shape[0]) < valid_share
    want = np.asarray(J.hll_registers(jnp.asarray(hashes),
                                      jnp.asarray(valid)))
    got = T.hll_registers(torch.from_numpy(hashes.view(np.int64)),
                          torch.from_numpy(valid)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if valid_share == 1.0:
        assert got.max() == 56        # the zero suffix, capped


@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_bucket_hll_registers_match_jax(nb):
    hashes = _hashes(NUM_ROWS, nb)
    rng = np.random.RandomState(nb)
    idx = rng.randint(0, nb + 1, NUM_ROWS).astype(np.int32)
    valid = rng.rand(NUM_ROWS) < 0.8
    want = np.asarray(J.bucket_hll_registers(
        jnp.asarray(idx), jnp.asarray(hashes), jnp.asarray(valid), nb))
    got = T.bucket_hll_registers(torch.from_numpy(idx),
                                 torch.from_numpy(hashes.view(np.int64)),
                                 torch.from_numpy(valid), nb).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("column", ["i64", "u64_over_i64", "u64_top_bit",
                                    "f64_zeros_nan", "i32"])
def test_hll_from_numeric_matches_jax(column):
    """The numeric path hashes the 64-bit value pattern: an i64 column (as
    the hdfs split's U64 tenant_id is stored), a u64 column with values
    past 2^63, an f64 column (bitcast; -0.0 and +0.0 differ) and a narrow
    integer column (widened)."""
    rng = np.random.RandomState(9)
    n = 20_000
    values = {
        "i64": rng.randint(-2**62, 2**62, n, dtype=np.int64),
        "u64_over_i64": rng.randint(0, 10, n).astype(np.int64),
        "u64_top_bit": (rng.randint(0, 2**63, n, dtype=np.int64)
                        .view(np.uint64) | np.uint64(1 << 63)),
        "f64_zeros_nan": np.where(rng.rand(n) < 0.5, -0.0, 0.0),
        "i32": rng.randint(-2**31, 2**31 - 1, n).astype(np.int32),
    }[column]
    if column == "f64_zeros_nan":
        values[::101] = np.nan
        values[::7] = rng.standard_normal(len(values[::7]))
    valid = rng.rand(n) < 0.9
    want = np.asarray(J.hll_from_numeric(jnp.asarray(values),
                                         jnp.asarray(valid)))
    got = T.hll_from_numeric(torch.from_numpy(values),
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_compare_reduce_runs_in_byte_sized_chunks(monkeypatch):
    """The compare-and-reduce operand is chunked by bytes: with a tiny
    chunk the results stay the JAX results."""
    monkeypatch.setattr(T, "_COMPARE_MAX_BYTES", 4096)
    idx, values = _inputs(64, "int", 77)
    for fn in ("bucket_sum", "bucket_min", "bucket_max", "bucket_counts"):
        args = (values, 64) if fn != "bucket_counts" else (64,)
        _bits_equal(*_both(fn, idx, *args))
    assert T._row_chunks(10_000, 64, 8)[0] == (0, 8)


def test_u64_to_f64_matches_jax():
    """u64 lanes (a packed u64 column rebases to them) convert to f64 with
    JAX's rounding, ties and values past 2^63 included."""
    rng = np.random.RandomState(12)
    values = np.concatenate([
        np.array([0, 1, 2**53 + 1, 2**63 - 1, 2**63, 2**63 + 1,
                  2**63 + 1024, 2**63 + 1025, 2**63 + 3072, 2**64 - 1,
                  2**64 - 1024, 2**64 - 1025], dtype=np.uint64),
        rng.randint(0, 2**63, 20_000, dtype=np.int64).view(np.uint64)
        | np.uint64(1 << 63)])
    want = np.asarray(jnp.asarray(values).astype(jnp.float64))
    got = T.as_f64(torch.from_numpy(values)).numpy()
    _bits_equal(want, got)
