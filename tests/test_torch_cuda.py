"""CUDA-only checks of the port: each kernel against its plain torch version
on the card, the doc-space ops and program on the card against the same
calls on the CPU (exactly), and the leaf search on `cuda` against the same
search on the CPU. Marked `gpu`; they skip where there is no GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda.py` (the repository's conftest.py configures JAX).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER, SO_MAPPER, body_term, synthetic_hdfs_split,
    synthetic_stackoverflow_split)
from quickwit_tpu_torch.ops import masks, topk
from quickwit_tpu_torch.ops.kernels.score_topk import (
    score_topk, score_topk_reference)
from quickwit_tpu_torch.query.ast import (
    Bool, FullText, Range, RangeBound, Term)
from quickwit_tpu_torch.search import executor
from quickwit_tpu_torch.search.executor import _widened
from quickwit_tpu_torch.search.plan import lower_request
from quickwit_tpu_torch.search.leaf import leaf_search_single_split
from quickwit_tpu_torch.search.models import SearchRequest
from quickwit_tpu_torch.storage.ram import RamStorage

NUM_DOCS = 100_000

CASES = {
    "1024_k10": (1024, 10, {}),
    "4096_k5": (4096, 5, {}),
    "5000_k10": (5000, 10, {}),
    "all_invalid": (1024, 3, {"all_invalid": True}),
    "equal_scores": (9000, 10, {"equal_scores": True}),
    "k64": (20000, 64, {}),
    "p1": (1, 1, {}),
    "tile_plus_one": (4097, 10, {}),
    "two_tiles_k64": (8192, 64, {}),
    # ties across every block of the persistent grid; the first valid
    # posting lies mid-tile
    "ties_invalid_head_1M_k10": (1_000_000, 10, {
        "equal_scores": True, "invalid_head": 300_001,
        "num_docs": 2_000_000}),
    "ties_1M_k64": (1_000_000, 64, {"equal_scores": True,
                                    "num_docs": 2_000_000}),
    # every posting beats the threshold
    "ascending_1M_k10": (1_000_000, 10, {"ascending": True,
                                         "num_docs": 2_000_000}),
    "ascending_200k_k64": (200_000, 64, {"ascending": True,
                                         "num_docs": 2_000_000}),
    # views 4 (ids) and 12 (tfs) bytes past a 16-byte boundary
    "misaligned_1M_k10": (1_000_001, 10, {"misaligned": True,
                                          "num_docs": 2_000_000}),
    "misaligned_5001_k33": (5001, 33, {"misaligned": True}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


def make_case(num_postings, seed, all_invalid=False, equal_scores=False,
              ascending=False, invalid_head=0, num_docs=NUM_DOCS):
    """`ascending`: posting i is doc i with tf 1 and a norm that falls as i
    rises, so every posting outscores the one before it. `invalid_head`:
    the first postings have tf 0."""
    rng = np.random.RandomState(seed)
    if ascending:
        ids = np.arange(num_postings, dtype=np.int32)
    else:
        ids = np.sort(rng.choice(num_docs, num_postings,
                                 replace=False)).astype(np.int32)
    tfs = rng.randint(1, 5, num_postings).astype(np.int32)
    norms = rng.randint(1, 50, num_docs + 1).astype(np.int32)
    pad = min(64, num_postings - 1)
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
    return ids, tfs, norms


def misaligned(t, shift):
    """A contiguous copy of `t` that starts `shift` int32 elements past a
    16-byte boundary."""
    base = torch.empty(t.shape[0] + 4, dtype=t.dtype, device=t.device)
    view = base[shift:shift + t.shape[0]]
    view.copy_(t)
    assert view.data_ptr() % 16 == 4 * shift
    return view


def expect_winners(got, want, num_valid, k, num_postings):
    vals, idx = (t.cpu() for t in got)
    want_vals, want_idx = want
    live = min(num_valid, k)
    assert torch.equal(idx[:live], want_idx[:live])
    assert torch.equal(vals[:live], want_vals[:live])
    assert torch.isneginf(vals[live:]).all()
    assert ((idx >= 0) & (idx < num_postings)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_score_topk_kernel_matches_plain_version(cuda_device, case):
    num_postings, k, flags = CASES[case]
    flags = dict(flags)
    shift = flags.pop("misaligned", False)
    num_docs = flags.get("num_docs", NUM_DOCS)
    ids, tfs, norms = make_case(num_postings, num_postings, **flags)
    idf, avg_len = np.float32(2.17), np.float32(9.3)
    num_valid = int(((tfs > 0) & (ids < num_docs)).sum())
    inputs = [torch.from_numpy(a) for a in (ids, tfs, norms)]
    want = score_topk_reference(*inputs, idf, avg_len, num_docs, k)
    d_ids, d_tfs, d_norms = (t.to(cuda_device) for t in inputs)
    if shift:
        d_ids, d_tfs = misaligned(d_ids, 1), misaligned(d_tfs, 3)
    before = score_topk.launches
    got = score_topk(d_ids, d_tfs, d_norms, idf, avg_len, num_docs, k)
    torch.cuda.synchronize()
    assert score_topk.launches == before + 1
    expect_winners(got, want, num_valid, k, num_postings)


@pytest.mark.gpu
def test_score_topk_back_to_back_calls_agree(cuda_device):
    """The kernel's grid state (ticket, candidate count, published k-th
    pair) comes back to 0 after every launch: 200 calls on one stream, none
    waiting for the last, all give the same winners."""
    ids, tfs, norms = make_case(1_000_000, 21, num_docs=2_000_000)
    idf, avg_len = np.float32(2.17), np.float32(9.3)
    num_valid = int(((tfs > 0) & (ids < 2_000_000)).sum())
    inputs = [torch.from_numpy(a) for a in (ids, tfs, norms)]
    want = score_topk_reference(*inputs, idf, avg_len, 2_000_000, 10)
    d_inputs = [t.to(cuda_device) for t in inputs]
    outs = [score_topk(*d_inputs, idf, avg_len, 2_000_000, 10)
            for _ in range(200)]
    torch.cuda.synchronize()
    for got in outs:
        expect_winners(got, want, num_valid, 10, 1_000_000)


@pytest.mark.gpu
def test_score_topk_on_two_streams_at_once(cuda_device):
    """Calls on a second stream run beside calls on the default stream;
    each stream has its own workspace, so neither corrupts the other."""
    idf, avg_len = np.float32(2.17), np.float32(9.3)
    cases = []
    for num_postings, seed, k in ((600_000, 22, 10), (400_000, 23, 64)):
        ids, tfs, norms = make_case(num_postings, seed, num_docs=2_000_000)
        inputs = [torch.from_numpy(a) for a in (ids, tfs, norms)]
        cases.append((
            [t.to(cuda_device) for t in inputs], k, num_postings,
            int(((tfs > 0) & (ids < 2_000_000)).sum()),
            score_topk_reference(*inputs, idf, avg_len, 2_000_000, k)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        with torch.cuda.stream(side):
            b = score_topk(*cases[1][0], idf, avg_len, 2_000_000, cases[1][1])
        a = score_topk(*cases[0][0], idf, avg_len, 2_000_000, cases[0][1])
        outs.append((a, b))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for pair in outs:
        for got, (_, k, num_postings, num_valid, want) in zip(pair, cases):
            expect_winners(got, want, num_valid, k, num_postings)


@pytest.mark.gpu
def test_unsigned_lanes_gather_on_cuda(cuda_device):
    values = np.array([0, 65535, 40000, 7], dtype=np.uint16)
    idx = torch.tensor([2, 1, 3], device=cuda_device)
    lanes = torch.from_numpy(values).to(cuda_device)
    assert _widened(lanes, idx).cpu().tolist() == [40000, 65535, 7]
    wide = torch.from_numpy(np.array([4_000_000_000, 1], dtype=np.uint32))
    assert _widened(wide.to(cuda_device)).cpu().tolist() == [4_000_000_000,
                                                              1]


@pytest.mark.gpu
@pytest.mark.parametrize("num_docs", [30_720, 50_000])
def test_leaf_on_cuda_matches_cpu(cuda_device, num_docs):
    storage = RamStorage(Uri.parse("ram:///cuda"))
    storage.put("s.split", synthetic_hdfs_split(num_docs, seed=7))
    reader = SplitReader(storage, "s.split")
    aggs = {"over_time": {"date_histogram": {"field": "timestamp",
                                             "fixed_interval": "1d"}},
            "severities": {"terms": {"field": "severity_text", "size": 10}}}
    for query, max_hits, request_aggs in [
            (Term("severity_text", "ERROR"), 10, aggs),
            (Term("severity_text", "ERROR"), 0, aggs),
            (Term("body", body_term(3)), 10, {}),
            (Term("body", body_term(3)), 100, aggs)]:
        request = SearchRequest(index_ids=["hdfs-logs"], query_ast=query,
                                max_hits=max_hits, aggs=request_aggs)
        gpu = leaf_search_single_split(request, HDFS_MAPPER, reader, "s",
                                       device=cuda_device)
        cpu = leaf_search_single_split(request, HDFS_MAPPER, reader, "s",
                                       device="cpu")
        assert gpu.num_hits == cpu.num_hits > 0
        assert ([(h.doc_id, h.sort_value) for h in gpu.partial_hits]
                == [(h.doc_id, h.sort_value) for h in cpu.partial_hits])
        assert gpu.intermediate_aggs.keys() == cpu.intermediate_aggs.keys()
        for name, state in cpu.intermediate_aggs.items():
            for key, value in state.items():
                other = gpu.intermediate_aggs[name][key]
                if isinstance(value, np.ndarray):
                    assert value.dtype == other.dtype
                    assert np.array_equal(value, other)
                else:
                    assert value == other


@pytest.mark.gpu
def test_phrase_leaf_on_cuda_matches_cpu(cuda_device):
    """c4 (a scoring precomputed phrase root: one score_topk launch) and c4
    at slop 2 on the same reader, each equal to the CPU run; slop 2 after
    slop 0 equals slop 2 on a fresh reader."""
    data = synthetic_stackoverflow_split(20_000, seed=11)

    def reader():
        storage = RamStorage(Uri.parse("ram:///cuda-so"))
        storage.put("so.split", data)
        return SplitReader(storage, "so.split")

    def request(slop):
        return SearchRequest(index_ids=["so"], max_hits=20, query_ast=FullText(
            "body", "t000010 t000011", mode="phrase", slop=slop))

    def key(resp):
        return resp.num_hits, [(h.doc_id, h.sort_value)
                               for h in resp.partial_hits]

    gpu_reader, cpu_reader = reader(), reader()
    got = {}
    for slop in (0, 2):
        before = score_topk.launches
        gpu = leaf_search_single_split(request(slop), SO_MAPPER, gpu_reader,
                                       "so", device=cuda_device)
        assert score_topk.launches == before + 1
        cpu = leaf_search_single_split(request(slop), SO_MAPPER, cpu_reader,
                                       "so", device="cpu")
        assert key(gpu) == key(cpu) and gpu.num_hits > 0
        got[slop] = key(gpu)
    fresh = leaf_search_single_split(request(2), SO_MAPPER, reader(), "so",
                                     device=cuda_device)
    assert key(fresh) == got[2] != got[0]
    assert (got[0][0], got[2][0]) == (27, 96)


# --- doc space: each op on the card equals the same op on the CPU ------------

@pytest.mark.gpu
@pytest.mark.parametrize("scoring", [False, True])
def test_posting_scatter_drops_pad_ids_on_cuda(cuda_device, scoring):
    """Pad ids (== num_docs_padded) and ids past it drop, with no device
    assert; a -0.0 value lands as +0.0, as the JAX scatter-add does."""
    padded = 4096
    rng = np.random.RandomState(1)
    ids = np.sort(rng.choice(padded, 900, replace=False)).astype(np.int32)
    ids = np.concatenate([ids, [padded] * 40, [padded + 77]]).astype(np.int32)
    values = rng.rand(ids.shape[0]).astype(np.float32)
    values[::7] = -0.0
    cpu_ids, cpu_vals = torch.from_numpy(ids), torch.from_numpy(values)
    if scoring:
        want = masks.dense_from_postings(cpu_ids, cpu_vals, padded)
        got = masks.dense_from_postings(cpu_ids.to(cuda_device),
                                        cpu_vals.to(cuda_device), padded)
        assert not torch.signbit(got).any()
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    else:
        want = masks.mask_from_postings(cpu_ids, padded)
        got = masks.mask_from_postings(cpu_ids.to(cuda_device), padded)
        assert torch.equal(got.cpu(), want)
    torch.cuda.synchronize()


def _zonemaps(values, present, block=512):
    nb = values.shape[0] // block
    v = values.astype(np.int64).reshape(nb, block)
    p = present.reshape(nb, block).astype(bool)
    zmin = np.where(p, v, 2**31 - 1).min(axis=1).astype(np.int32)
    zmax = np.where(p, v, -2**31).max(axis=1).astype(np.int32)
    return zmin, zmax


@pytest.mark.gpu
@pytest.mark.parametrize("lane", [np.uint8, np.uint16, np.uint32])
def test_range_mask_over_packed_lanes_on_cuda(cuda_device, lane):
    """FOR-packed u8/u16/u32 lanes compare as i32 against i32 bounds,
    gated by i32 zonemaps, as the executor evaluates a packed PRange."""
    rng = np.random.RandomState(int(np.iinfo(lane).bits))
    n = 8192
    top = min(int(np.iinfo(lane).max), 2**31 - 2)
    values = rng.randint(0, top, n, dtype=np.int64).astype(lane)
    present = (rng.rand(n) < 0.9).astype(np.uint8)
    present[2048:2560] = 0
    zmin, zmax = _zonemaps(values, present)
    cpu = [torch.from_numpy(a) for a in (values, present, zmin, zmax)]
    gpu = [t.to(cuda_device) for t in cpu]
    for lo, hi in ((top // 4, top // 2), (0, 0), (top // 3, top // 3 + 5)):
        for incl in ((True, True), (False, False)):
            args = (np.int32(lo), np.int32(hi), *incl, True, True)
            want = masks.range_mask(_widened(cpu[0]).to(torch.int32), cpu[1],
                                    *args, cpu[2], cpu[3])
            got = masks.range_mask(_widened(gpu[0]).to(torch.int32), gpu[1],
                                   *args, gpu[2], gpu[3])
            assert torch.equal(got.cpu(), want)


def _special_keys(rng, n):
    keys = rng.choice([-0.0, 0.0, np.nan, -np.nan, -np.inf, np.inf, 1.5,
                       -1.7976931348623157e308], n)
    return np.where(rng.rand(n) < 0.5, rng.randint(-3, 3, n) * 0.5, keys)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 2048, 10 * 1024 + 5, 1_000_000])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_exact_topk_on_cuda_matches_cpu(cuda_device, n, k):
    """Ties, NaN of both signs and signed zeros across block edges: the
    GPU's sorts rank them as the CPU's do (both sort integer keys)."""
    rng = np.random.RandomState(n + k)
    key1 = torch.from_numpy(_special_keys(rng, n))
    key2 = torch.from_numpy(_special_keys(rng, n))
    want = topk.exact_topk(key1, k)
    got = topk.exact_topk(key1.to(cuda_device), k)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int64),
                       want[0].view(torch.int64))
    want2 = topk.exact_topk_2key(key1, key2, k)
    got2 = topk.exact_topk_2key(key1.to(cuda_device), key2.to(cuda_device),
                                k)
    assert torch.equal(got2[2].cpu(), want2[2])
    for g, w in zip(got2[:2], want2[:2]):
        assert torch.equal(g.cpu().view(torch.int64), w.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [13, 4096, 1_000_448])
def test_pack_mask_round_trip_on_cuda(cuda_device, n):
    bools = np.random.RandomState(n).rand(n) < 0.3
    mask = torch.from_numpy(bools).to(cuda_device)
    packed = executor._pack_mask(mask, n)
    assert packed.device.type == "cuda" and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.cpu().numpy(), np.packbits(bools))
    assert torch.equal(executor._unpack_mask(packed, n), mask)


class _DeviceLog(TorchDispatchMode):
    """Records every aten op that returns a tensor off the card, except a
    host scalar being made into a tensor (`lift_fresh` of a 0-dim tensor,
    which the program then copies to the card: its divisors)."""

    def __init__(self):
        super().__init__()
        self.off_card = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.device.type != "cuda"
                    and not (func is torch.ops.aten.lift_fresh.default
                             and t.dim() == 0)):
                self.off_card.add((str(func), tuple(t.shape)))
        return out


@pytest.mark.gpu
def test_doc_space_program_stays_on_cuda(cuda_device):
    """A small doc-space program (Bool root, range filter, two-key sort,
    search_after, threshold, bucket counts) equals its CPU run, and no op
    of it returns a CPU tensor."""
    storage = RamStorage(Uri.parse("ram:///cuda-docspace"))
    storage.put("s.split", synthetic_hdfs_split(50_000, seed=7))
    reader = SplitReader(storage, "s.split")
    t0 = 1_600_000_000 * 1_000_000
    query = Bool(must=(Term("severity_text", "ERROR"),),
                 should=(Term("body", body_term(3)),),
                 filter=(Range("timestamp", lower=RangeBound(t0, True),
                               upper=RangeBound(t0 + 3 * 86400 * 10**6,
                                                False)),))
    from quickwit_tpu_torch.query.aggregations import parse_aggs
    aggs = parse_aggs({"severities": {"terms": {"field": "severity_text"}},
                       "per_day": {"date_histogram": {
                           "field": "timestamp", "fixed_interval": "1d"}}})
    plan = lower_request(query, HDFS_MAPPER, reader, aggs,
                         sort_field="timestamp", sort_order="desc",
                         sort2_field="tenant_id", sort2_order="asc",
                         search_after=(float(t0 + 86400 * 10**6), -3.0,
                                       "lt", 0),
                         sort_value_threshold=float(t0))
    assert not executor._posting_space_eligible(plan)
    cpu_arrays = [torch.from_numpy(np.array(a)) for a in plan.arrays]
    gpu_arrays = [a.to(cuda_device) for a in cpu_arrays]
    fn = executor._build(plan, 100, cuda_device)
    log = _DeviceLog()
    with log:
        out = fn(gpu_arrays, tuple(plan.scalars), plan.num_docs)
    assert not log.off_card, log.off_card
    want = executor.execute_plan(plan, 100, cpu_arrays, device="cpu")
    got = executor.readback_plan_result(*executor._get_packed_executor(
        plan, 100, cuda_device)(gpu_arrays, tuple(plan.scalars),
                                plan.num_docs))
    assert got["count"] == want["count"] == int(out[4].cpu()) > 0
    for key in ("sort_values", "sort_values2", "doc_ids", "scores"):
        np.testing.assert_array_equal(got[key], want[key])
    for g, w in zip(got["aggs"], want["aggs"]):
        np.testing.assert_array_equal(g["counts"], w["counts"])


# --- aggregations: each op and program on the card equals its CPU run --------
#
# Tolerances: exact (bit for bit) for counts, minima, maxima, sketches, HLL
# registers, composite keys and integer sums below 2^53; rtol=1e-12 for
# other f64 sums, whose reduction order differs between the CPU and the
# card. Two calls on the card give the same bits.

def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


def _agg_op_inputs(n, nb, seed):
    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.randint(-1, nb + 2, n).astype(np.int32))
    ints = torch.from_numpy(rng.randint(-10**6, 10**6, n).astype(np.int64))
    floats = torch.from_numpy(np.where(
        rng.rand(n) < 0.1, rng.choice([-0.0, 0.0, np.nan], n),
        rng.standard_normal(n) * 1e3))
    hashes = torch.from_numpy(rng.randint(-2**63, 2**63 - 1, n,
                                          dtype=np.int64))
    valid = torch.from_numpy(rng.rand(n) < 0.8)
    return idx, ints, floats, hashes, valid


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [7, 64, 65, 700])
def test_agg_ops_on_cuda_match_cpu(cuda_device, nb):
    from quickwit_tpu_torch.ops import aggs
    idx, ints, floats, hashes, valid = _agg_op_inputs(2_000_003, nb, nb)
    calls = {
        "counts": lambda i, v, f, h, ok: aggs.bucket_counts(i, nb),
        "sum_int": lambda i, v, f, h, ok: aggs.bucket_sum(i, v, nb),
        "sum_f64": lambda i, v, f, h, ok: aggs.bucket_sum(i, f, nb),
        "min": lambda i, v, f, h, ok: aggs.bucket_min(i, f, nb),
        "max": lambda i, v, f, h, ok: aggs.bucket_max(i, f, nb),
        "sketch": lambda i, v, f, h, ok: aggs.bucket_percentile_sketch(
            i, v.abs(), nb),
        "hll": lambda i, v, f, h, ok: aggs.bucket_hll_registers(
            i, h, ok, nb),
        "stats": lambda i, v, f, h, ok: aggs.stats_state(f, ok, ok),
        "hll_numeric": lambda i, v, f, h, ok: aggs.hll_from_numeric(f, ok),
    }
    cpu_args = (idx, ints, floats, hashes, valid)
    gpu_args = tuple(t.to(cuda_device) for t in cpu_args)
    for name, fn in calls.items():
        want = fn(*cpu_args).numpy()
        first = fn(*gpu_args).cpu().numpy()
        second = fn(*gpu_args).cpu().numpy()
        assert first.dtype == want.dtype and first.shape == want.shape
        np.testing.assert_array_equal(_bits(first), _bits(second),
                                      err_msg=name)
        if name in ("sum_f64", "stats"):
            np.testing.assert_allclose(first, want, rtol=1e-12, atol=0,
                                       err_msg=name)
            if name == "stats":   # count, min, max exact
                np.testing.assert_array_equal(_bits(first[[0, 3, 4]]),
                                              _bits(want[[0, 3, 4]]))
        else:
            np.testing.assert_array_equal(_bits(first), _bits(want),
                                          err_msg=name)


@pytest.mark.gpu
def test_u64_lanes_convert_on_cuda(cuda_device):
    from quickwit_tpu_torch.ops import aggs
    values = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1025, 2**64 - 1],
                      dtype=np.uint64)
    got = aggs.as_f64(torch.from_numpy(values).to(cuda_device)).cpu()
    np.testing.assert_array_equal(got.numpy(), values.astype(np.float64))


def _close_tree(want, got, path="aggs"):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for key in want:
            _close_tree(want[key], got[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _close_tree(w, g, f"{path}[{i}]")
    else:
        want, got = np.asarray(want), np.asarray(got)
        assert want.dtype == got.dtype and want.shape == got.shape, path
        last = path.rsplit(".", 1)[-1]
        if last in ("sum", "sum_sq", "stats"):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                       err_msg=path)
            if last == "stats":
                np.testing.assert_array_equal(_bits(got[[0, 3, 4]]),
                                              _bits(want[[0, 3, 4]]),
                                              err_msg=path)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=path)


def _mv_split():
    """The port's SplitWriter: multivalued raw tags, a FOR-packed u64."""
    from quickwit_tpu_torch.index import SplitWriter
    from quickwit_tpu_torch.models.doc_mapper import (
        DocMapper, FieldMapping, FieldType)
    mapper = DocMapper(field_mappings=[
        FieldMapping("ts", FieldType.DATETIME, fast=True,
                     input_formats=("unix_timestamp",)),
        FieldMapping("tags", FieldType.TEXT, tokenizer="raw", fast=True),
        FieldMapping("bytes", FieldType.U64, fast=True)],
        timestamp_field="ts")
    rng = np.random.RandomState(4)
    writer = SplitWriter(mapper)
    for i in range(5000):
        writer.add_json_doc({
            "ts": 1_600_000_000 + i,
            "tags": list(rng.choice([f"t{j}" for j in range(50)],
                                    rng.randint(1, 5))),
            "bytes": int(2**63 + rng.randint(0, 50_000) * 8)})
    storage = RamStorage(Uri.parse("ram:///cuda-mv"))
    storage.put("s.split", writer.finish())
    return mapper, SplitReader(storage, "s.split")


def _agg_plans():
    """(name, mapper, reader, query, aggs, k) of each aggregation program."""
    from quickwit_tpu_torch.index.synthetic import (
        OTEL_BENCH_MAPPER, synthetic_otel_split)
    from quickwit_tpu_torch.query.ast import MatchAll
    storage = RamStorage(Uri.parse("ram:///cuda-aggs"))
    storage.put("h.split", synthetic_hdfs_split(50_000, seed=7))
    storage.put("o.split", synthetic_otel_split(50_000, seed=7))
    hdfs = SplitReader(storage, "h.split")
    otel = SplitReader(storage, "o.split")
    mv_mapper, mv = _mv_split()
    t0 = 1_600_000_000 * 1_000_000
    day = 86400 * 1_000_000
    c2 = Bool(must=(Term("severity_text", "ERROR"),),
              should=(Term("body", body_term(3)),),
              filter=(Range("timestamp", lower=RangeBound(t0 + day, True),
                            upper=RangeBound(t0 + 4 * day, False)),))
    metrics = {"s": {"stats": {"field": "tenant_id"}},
               "p": {"percentiles": {"field": "tenant_id"}},
               "x": {"extended_stats": {"field": "timestamp"}}}
    duration = "span_duration_micros"
    return [
        ("bucket_metrics_posting_space", HDFS_MAPPER, hdfs,
         Term("severity_text", "ERROR"), {
             "per_day": {"date_histogram": {"field": "timestamp",
                                            "fixed_interval": "1d"},
                         "aggs": metrics},
             "sev": {"terms": {"field": "severity_text"},
                     "aggs": {"m": {"max": {"field": "timestamp"}}}}}, 10),
        ("c2_range_composite_cardinality", HDFS_MAPPER, hdfs, c2, {
            "card": {"cardinality": {"field": "tenant_id"}},
            "r": {"range": {"field": "timestamp", "ranges": [
                {"to": t0 + 3 * day}, {"from": t0 + 2 * day},
                {"from": t0 + day, "to": t0 + 5 * day}]},
                "aggs": {"s": {"sum": {"field": "tenant_id"}},
                         "c": {"cardinality": {"field": "tenant_id"}}}},
            "comp": {"composite": {"size": 20, "sources": [
                {"sev": {"terms": {"field": "severity_text"}}},
                {"day": {"date_histogram": {"field": "timestamp",
                                            "fixed_interval": "1d"}}}]},
                "aggs": {"a": {"avg": {"field": "tenant_id"}},
                         "t": {"terms": {"field": "tenant_id"}}}}}, 100),
        ("otel_latency", OTEL_BENCH_MAPPER, otel, MatchAll(), {
            "p": {"percentiles": {"field": duration,
                                  "percents": [50, 95, 99]}},
            "svc": {"terms": {"field": "service_name"}, "aggs": {
                "p": {"percentiles": {"field": duration}},
                "x": {"extended_stats": {"field": duration}},
                "c": {"cardinality": {"field": duration}}}}}, 0),
        ("mv_tags_packed_u64", mv_mapper, mv,
         Range("bytes", lower=RangeBound(2**63 + 80_000, True)), {
             "tags": {"terms": {"field": "tags", "size": 50}},
             "s": {"stats": {"field": "bytes"}},
             "c": {"cardinality": {"field": "bytes"}},
             "h": {"histogram": {"field": "bytes", "interval": 40_000},
                   "aggs": {"m": {"min": {"field": "bytes"}}}}}, 0),
    ]


@pytest.mark.gpu
def test_agg_programs_on_cuda_match_cpu(cuda_device):
    """Each aggregation program on the card: no op returns a host tensor,
    two calls give byte-equal packed results, and the readback equals the
    CPU run's."""
    from quickwit_tpu_torch.query.aggregations import parse_aggs
    for name, mapper, reader, query, aggs, k in _agg_plans():
        plan = lower_request(query, mapper, reader, parse_aggs(aggs))
        cpu_arrays = [torch.from_numpy(np.array(a)) for a in plan.arrays]
        gpu_arrays = [a.to(cuda_device) for a in cpu_arrays]
        log = _DeviceLog()
        with log:
            executor._build(plan, k, cuda_device)(
                gpu_arrays, tuple(plan.scalars), plan.num_docs)
        assert not log.off_card, (name, log.off_card)
        packed = executor._get_packed_executor(plan, k, cuda_device)
        first, spec = packed(gpu_arrays, tuple(plan.scalars), plan.num_docs)
        second, _ = packed(gpu_arrays, tuple(plan.scalars), plan.num_docs)
        assert torch.equal(first.view(torch.int64), second.view(torch.int64))
        got = executor.readback_plan_result(first, spec)
        want = executor.execute_plan(plan, k, cpu_arrays, device="cpu")
        assert got["count"] == want["count"] > 0, name
        for key in ("sort_values", "doc_ids", "scores"):
            np.testing.assert_array_equal(got[key], want[key])
        _close_tree(want["aggs"], got["aggs"], name)


# --- the node's search service on the card ----------------------------------

def _service_corpus(num_docs=30_720):
    """One hdfs split's bytes under two split ids in a resolver."""
    from quickwit_tpu_torch.common.uri import Protocol
    from quickwit_tpu_torch.search.models import SplitIdAndFooter
    from quickwit_tpu_torch.storage import StorageResolver
    data = synthetic_hdfs_split(num_docs, seed=7)
    storage = RamStorage(Uri.parse("ram:///svc"))
    for split_id in ("a", "b"):
        storage.put(f"{split_id}.split", data)
    resolver = StorageResolver()
    resolver.register(Protocol.RAM, lambda _uri: storage)
    splits = [SplitIdAndFooter(split_id, "ram:///svc", len(data),
                               num_docs=num_docs) for split_id in ("a", "b")]
    return resolver, splits


def _service(resolver, device, **kw):
    from quickwit_tpu_torch.search.service import (
        SearcherContext, SearchService)
    context = SearcherContext(resolver, batch_size=1, prefetch=False,
                              device=device, **kw)
    return SearchService(context), context


def _leaf_request(request, splits):
    from quickwit_tpu_torch.search.models import LeafSearchRequest
    return LeafSearchRequest(search_request=request, index_uid="hdfs:0",
                             doc_mapping=HDFS_MAPPER.to_dict(),
                             splits=list(splits))


def _service_requests():
    from quickwit_tpu_torch.search.models import SortField
    aggs = {"over_time": {"date_histogram": {"field": "timestamp",
                                             "fixed_interval": "1d"}},
            "severities": {"terms": {"field": "severity_text", "size": 10}}}
    t0_us, day_us = 1_600_000_000 * 1_000_000, 86400 * 1_000_000
    c2 = Bool(must=(Term("severity_text", "ERROR"),),
              should=(Term("body", body_term(3)), Term("body", body_term(7))),
              filter=(Range("timestamp",
                            lower=RangeBound(t0_us + day_us, True),
                            upper=RangeBound(t0_us + 4 * day_us, False)),))
    return {
        "flagship": SearchRequest(index_ids=["hdfs-logs"],
                                  query_ast=Term("severity_text", "ERROR"),
                                  max_hits=10, aggs=aggs),
        "c2_bool_range_top100": SearchRequest(index_ids=["hdfs-logs"],
                                              query_ast=c2, max_hits=100),
        "c2_by_timestamp": SearchRequest(
            index_ids=["hdfs-logs"], query_ast=c2, max_hits=100,
            sort_fields=(SortField("timestamp", "desc"),), aggs=aggs),
    }


def _response_key(resp):
    aggs = {name: {k: (v.dtype.str, v.tolist())
                   if isinstance(v, np.ndarray) else v
                   for k, v in state.items()}
            for name, state in resp.intermediate_aggs.items()}
    return (resp.num_hits, [(h.split_id, h.doc_id, h.sort_value,
                             h.raw_sort_value) for h in resp.partial_hits],
            repr(sorted(aggs.items())), resp.failed_splits)


@pytest.mark.gpu
def test_service_on_cuda_matches_cpu(cuda_device):
    """`SearchService.leaf_search` on a cuda context equals a cpu context
    over the same resolver, cold, warm (resident columns, a mask hit) and
    from the leaf cache; the flagship launches score_topk once per split
    per call that runs a program."""
    resolver, splits = _service_corpus()
    gpu, gpu_ctx = _service(resolver, cuda_device)
    cpu, _ = _service(resolver, "cpu")
    import dataclasses
    for name, request in _service_requests().items():
        # cold, warm (resident columns; a mask hit for c2_by_timestamp),
        # and a byte-identical repeat from the leaf cache
        for max_hits, per_split in ((request.max_hits, 1), (7, 1), (7, 0)):
            req = dataclasses.replace(request, max_hits=max_hits)
            before = score_topk.launches
            got = gpu.leaf_search(_leaf_request(req, splits))
            launches = score_topk.launches - before
            want = cpu.leaf_search(_leaf_request(req, splits))
            assert got.num_hits > 0 and not got.failed_splits
            assert _response_key(got) == _response_key(want), name
            want_launches = per_split * len(splits) if name == "flagship" \
                else 0
            assert launches == want_launches, (name, max_hits)
    for cols in gpu_ctx.resident_store._by_split.values():
        for tensor in cols._device_array_cache.values():
            assert tensor.device.type == "cuda"


@pytest.mark.gpu
def test_eviction_lowers_memory_allocated(cuda_device, monkeypatch):
    """Under a budget of 1.5 splits, each eviction frees at least the bytes
    the store held for the evicted split, as the CUDA caching allocator
    counts them (`memory_allocated`, not `memory_reserved`)."""
    from quickwit_tpu_torch.search import residency
    from quickwit_tpu_torch.search.admission import HbmBudget
    resolver, splits = _service_corpus()
    request = _service_requests()["flagship"]
    # every tier off: each call stages the flagship's whole column set
    no_tiers = dict(leaf_cache_bytes=0, enable_mask_cache=False,
                    enable_agg_cache=False)
    probe, probe_ctx = _service(resolver, cuda_device, **no_tiers)
    probe.leaf_search(_leaf_request(request, splits[:1]))
    per_split = probe_ctx.hbm_budget.stats()["resident"]
    assert per_split > 0
    del probe, probe_ctx
    service, context = _service(resolver, cuda_device, **no_tiers)
    context.hbm_budget = HbmBudget(budget_bytes=int(per_split * 1.5))
    drops = []
    clear = residency._NotifyingCache.clear

    def measured_clear(cache):
        held = context.resident_store.stats()["by_split"].get(
            cache._split_id, 0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        clear(cache)
        drops.append((held, before - torch.cuda.memory_allocated()))

    monkeypatch.setattr(residency._NotifyingCache, "clear", measured_clear)
    cpu, _ = _service(resolver, "cpu")
    for _ in range(2):
        for split in splits:
            got = service.leaf_search(_leaf_request(request, [split]))
            want = cpu.leaf_search(_leaf_request(request, [split]))
            assert _response_key(got) == _response_key(want)
    assert len(drops) >= 3
    for held, freed in drops:
        assert held > 0 and freed >= held, drops
