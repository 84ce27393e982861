"""The fused BM25 score + top-k: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its exact top-k path. The CUDA
kernel is held against the plain version in `test_torch_cuda.py`.

Valid winners (finite values) must agree exactly in f32 value and posting
index; lanes past the number of valid postings must be -inf on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickwit_tpu.ops.bm25 import B, K1

from quickwit_tpu.ops.bm25 import score_postings as j_score_postings
from quickwit_tpu.ops.pallas.score_topk import fused_score_topk
from quickwit_tpu.ops.topk import exact_topk as j_exact_topk

from quickwit_tpu_torch.ops.bm25 import score_postings
from quickwit_tpu_torch.ops.kernels.score_topk import (
    _host_scalars, score_topk, score_topk_reference)

NUM_DOCS = 100_000


def make_case(num_postings, seed, *, all_invalid=False, equal_scores=False,
              ascending=False, invalid_head=0, pad_tail=64):
    """(ids, tfs, dense fieldnorms, idf, avg_len): sorted distinct doc ids,
    a pad tail of sentinel ids with tf 0 (as the split format produces).
    `ascending`: posting i is doc i with tf 1 and a norm that falls as i
    rises, so every posting outscores the one before it (the CUDA kernel's
    worst order). `invalid_head`: the first postings have tf 0, so tied
    winners start mid-list."""
    rng = np.random.RandomState(seed)
    if ascending:
        ids = np.arange(num_postings, dtype=np.int32)
    else:
        ids = np.sort(rng.choice(NUM_DOCS, num_postings,
                                 replace=False)).astype(np.int32)
    tfs = rng.randint(1, 5, num_postings).astype(np.int32)
    norms = rng.randint(1, 50, NUM_DOCS + 1).astype(np.int32)
    pad = min(pad_tail, num_postings - 1)
    if pad > 0:
        tfs[-pad:] = 0
        ids[-pad:] = 2**30
    if equal_scores:
        tfs[tfs > 0] = 1
        norms[:] = 7
    if ascending:
        tfs[tfs > 0] = 1
        norms[:num_postings] = np.arange(num_postings, 0, -1)
    tfs[:invalid_head] = 0
    if all_invalid:
        ids[:] = 2**30
        tfs[:] = 0
    return ids, tfs, norms, np.float32(2.17), np.float32(9.3)


CASES = {
    "1024_k10": (dict(num_postings=1024, seed=1024), 10),
    "4096_k5": (dict(num_postings=4096, seed=4096), 5),
    "5000_k10": (dict(num_postings=5000, seed=5000), 10),
    "all_invalid": (dict(num_postings=1024, seed=1, all_invalid=True), 3),
    "equal_scores": (dict(num_postings=9000, seed=9, equal_scores=True), 10),
    "k64": (dict(num_postings=20000, seed=64), 64),
    "p1": (dict(num_postings=1, seed=2), 1),
    "tile_plus_one": (dict(num_postings=4097, seed=3), 10),
    "ascending_k10": (dict(num_postings=20000, seed=13, ascending=True), 10),
    "ascending_k64": (dict(num_postings=20000, seed=14, ascending=True), 64),
    "ties_invalid_head_k10": (dict(num_postings=20000, seed=11,
                                   equal_scores=True, invalid_head=5001), 10),
    "ties_k64": (dict(num_postings=20000, seed=12, equal_scores=True), 64),
}


def jax_keyed(ids, tfs, norms, idf, avg_len, num_docs):
    safe = np.clip(ids, 0, norms.shape[0] - 1)
    # jitted, as the JAX package runs it: XLA then contracts the BM25
    # denominator into one fma (op-by-op dispatch rounds it twice)
    scores = jax.jit(j_score_postings)(jnp.asarray(tfs), jnp.asarray(safe),
                                       jnp.asarray(norms), jnp.float32(avg_len),
                                       jnp.float32(idf))
    valid = (tfs > 0) & (ids < num_docs)
    return jnp.where(jnp.asarray(valid), scores.astype(jnp.float64), -jnp.inf)


def assert_same_winners(vals, idx, exp_vals, exp_idx, num_valid, k):
    vals = np.asarray(vals, dtype=np.float32)
    exp_vals = np.asarray(exp_vals, dtype=np.float32)
    live = min(num_valid, k)
    assert vals.shape == (k,) and np.asarray(idx).shape == (k,)
    assert np.isfinite(vals[:live]).all()
    np.testing.assert_array_equal(vals[:live], exp_vals[:live])
    np.testing.assert_array_equal(np.asarray(idx)[:live],
                                  np.asarray(exp_idx)[:live])
    assert np.isneginf(vals[live:]).all()
    assert np.isneginf(exp_vals[live:]).all()


def torch_inputs(ids, tfs, norms, device="cpu"):
    return (torch.from_numpy(ids).to(device), torch.from_numpy(tfs).to(device),
            torch.from_numpy(norms).to(device))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_and_exact_topk(case):
    spec, k = CASES[case]
    ids, tfs, norms, idf, avg_len = make_case(**spec)
    num_valid = int(((tfs > 0) & (ids < NUM_DOCS)).sum())
    vals, idx = score_topk_reference(*torch_inputs(ids, tfs, norms), idf,
                                     avg_len, NUM_DOCS, k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64

    gathered = norms[np.clip(ids, 0, norms.shape[0] - 1)]
    p_vals, p_idx = fused_score_topk(
        jnp.asarray(ids), jnp.asarray(tfs), jnp.asarray(gathered),
        jnp.float32(idf), jnp.float32(avg_len), jnp.int32(NUM_DOCS), k=k,
        interpret=True)
    assert_same_winners(vals.numpy(), idx.numpy(), p_vals, p_idx,
                        num_valid, k)

    keyed = jax_keyed(ids, tfs, norms, idf, avg_len, NUM_DOCS)
    if keyed.shape[0] >= k:
        e_vals, e_idx = j_exact_topk(keyed, k)
        assert_same_winners(vals.numpy(), idx.numpy(), e_vals, e_idx,
                            num_valid, k)
    # the CPU wrapper is the plain version
    w_vals, w_idx = score_topk(*torch_inputs(ids, tfs, norms), idf, avg_len,
                               NUM_DOCS, k)
    assert torch.equal(w_vals, vals) and torch.equal(w_idx, idx)


@pytest.mark.parametrize("avg_len,idf", [(9.3, 2.17), (20.123, 0.731),
                                         (1.0, 2.2875657), (0.37, 5.5)])
def test_score_postings_bit_identical_to_jax(avg_len, idf):
    """Every posting's f32 score, not only the winners: the JAX program's
    `tf + K1 * inner` is one fma on the CPU backend, and an unfused port
    differs from it by one ulp on about one posting in eight."""
    rng = np.random.RandomState(17)
    ids = rng.randint(0, 50_000, 200_000).astype(np.int32)
    tfs = rng.randint(0, 3000, 200_000).astype(np.int32)
    norms = rng.randint(1, 6000, 50_000).astype(np.int32)
    want = np.asarray(jax.jit(j_score_postings)(
        jnp.asarray(tfs), jnp.asarray(ids), jnp.asarray(norms),
        jnp.float32(avg_len), jnp.float32(idf)))
    got = score_postings(torch.from_numpy(tfs), torch.from_numpy(ids),
                         torch.from_numpy(norms), np.float32(avg_len),
                         np.float32(idf)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ascending_case_rises_with_the_posting_index():
    """The adversarial order really is one: every valid posting outscores
    the one before it, so the winners are the last valid postings."""
    ids, tfs, norms, idf, avg_len = make_case(20000, 13, ascending=True)
    scores = score_postings(*torch_inputs(tfs, ids, norms), avg_len,
                            idf).numpy()
    live = scores[tfs > 0]
    assert (np.diff(live) > 0).all()
    vals, idx = score_topk_reference(*torch_inputs(ids, tfs, norms), idf,
                                     avg_len, NUM_DOCS, 10)
    last_valid = int(np.flatnonzero(tfs > 0)[-1])
    assert idx.tolist() == list(range(last_valid, last_valid - 10, -1))


def _old_numpy_scalars(idf, avg_len):
    """The wrapper's f32 constants as numpy rounded them before the wrapper
    dropped numpy from its launch path."""
    f32 = np.float32
    weight = (f32(1.0) * f32(idf)) * f32(K1 + 1.0)
    avg = np.maximum(f32(avg_len), f32(1e-9))
    return (float(weight), float(avg), float(f32(K1)), float(f32(B)),
            float(f32(1.0 - B)), float(f32(1e-9)))


def test_host_scalars_round_as_numpy_f32():
    rng = np.random.RandomState(23)
    idfs = np.concatenate([
        rng.uniform(0.0, 25.0, 4000),
        np.exp(rng.uniform(-30.0, 30.0, 4000)),
        rng.randint(1, 2**52, 2000) * 2.0 ** rng.randint(-60, 10, 2000),
        [0.0, -0.0, 1e-45, 1.4e-45, 3e38, 1e39, np.inf, -np.inf, np.nan]])
    avgs = np.concatenate([
        rng.uniform(0.0, 1000.0, 4000),
        np.exp(rng.uniform(-40.0, 30.0, 4000)),
        rng.uniform(0.0, 2e-9, 2000),
        [0.0, -0.0, 1e-9, np.nextafter(1e-9, 0), 5e-10, -3.0, 3.5e38, np.inf,
         np.nan]])
    as_f32 = [np.float32(x) for x in idfs[:100]]   # scalars the planner hands
    with np.errstate(over="ignore"):
        for idf, avg in zip(list(idfs) + as_f32, list(avgs) + list(avgs[:100])):
            got = np.array(_host_scalars(idf, avg), dtype=np.float32)
            want = np.array(_old_numpy_scalars(idf, avg), dtype=np.float32)
            assert got.tobytes() == want.tobytes(), (idf, avg, got, want)


def test_equal_scores_break_ties_by_lowest_posting_index():
    ids, tfs, norms, idf, avg_len = make_case(9000, 9, equal_scores=True)
    vals, idx = score_topk_reference(*torch_inputs(ids, tfs, norms), idf,
                                     avg_len, NUM_DOCS, 10)
    assert torch.unique(vals).numel() == 1
    assert idx.tolist() == list(range(10))


@pytest.mark.parametrize("bad", ["dtype", "k0", "k65", "empty", "noncontig"])
def test_wrapper_rejects_bad_inputs(bad):
    ids, tfs, norms, idf, avg_len = make_case(1024, 5)
    t_ids, t_tfs, t_norms = torch_inputs(ids, tfs, norms)
    k = 10
    if bad == "dtype":
        t_tfs = t_tfs.to(torch.int64)
    elif bad == "k0":
        k = 0
    elif bad == "k65":
        k = 65
    elif bad == "empty":
        t_ids, t_tfs = t_ids[:0], t_tfs[:0]
    else:
        t_ids, t_tfs = t_ids[::2], t_tfs[::2]
    with pytest.raises((TypeError, ValueError)):
        score_topk(t_ids, t_tfs, t_norms, idf, avg_len, NUM_DOCS, k)
