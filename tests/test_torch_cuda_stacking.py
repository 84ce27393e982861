"""CUDA-only checks of query stacking: the lane kernel (`score_topk_lanes`)
against its plain version and against one solo `score_topk` launch per
lane, bit for bit; a stacked dispatch, a convoy and a chunked group scan on
the card against the same calls on the CPU. Marked `gpu`; they skip where
there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
tests/test_torch_cuda_stacking.py` runs both on the card.
"""

import numpy as np
import pytest
import torch

from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER, synthetic_hdfs_split)
from quickwit_tpu_torch.ops.kernels import score_topk as st
from quickwit_tpu_torch.query.ast import Bool, Range, RangeBound, Term
from quickwit_tpu_torch.search import chunkexec, executor
from quickwit_tpu_torch.search.leaf import warmup_device_arrays
from quickwit_tpu_torch.search.plan import lower_request
from quickwit_tpu_torch.storage.ram import RamStorage

NUM_DOCS = 1_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


def _lane(num_postings, seed, device, all_invalid=False, shift=0):
    """One lane's (ids, tfs, norms, idf, avg_len, num_docs) on `device`:
    sorted ids with a pad tail; `shift` (1 or 2) makes ids and tfs views
    `shift` and `4 - shift` int32 elements past a 16-byte boundary."""
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(NUM_DOCS, num_postings,
                             replace=False)).astype(np.int32)
    tfs = rng.randint(1, 5, num_postings).astype(np.int32)
    norms = rng.randint(1, 50, NUM_DOCS + 1).astype(np.int32)
    pad = min(64, num_postings - 1)
    if pad > 0:
        ids[-pad:], tfs[-pad:] = 2**30, 0
    if all_invalid:
        ids[:], tfs[:] = 2**30, 0
    out = []
    for arr, s in ((ids, shift), (tfs, 4 - shift if shift else 0)):
        t = torch.from_numpy(arr).to(device)
        if s:
            base = torch.empty(t.shape[0] + 4, dtype=t.dtype, device=device)
            view = base[s:s + t.shape[0]]
            view.copy_(t)
            assert view.data_ptr() % 16 == 4 * s
            t = view
        out.append(t)
    return (out[0], out[1], torch.from_numpy(norms).to(device),
            np.float32(1.3 + 0.1 * seed % 2), np.float32(9.0 + seed % 3),
            NUM_DOCS)


def _lanes(q, device, seed):
    """q lanes of unequal length, one all invalid, some misaligned."""
    lengths = [5000, 1024, 131_072, 3, 20_000, 4097, 700, 64_000]
    return [_lane(lengths[i % len(lengths)] + i, seed + i, device,
                  all_invalid=(i == 1), shift=(i % 3))
            for i in range(q)]


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 2, 5, 16])
@pytest.mark.parametrize("k", [10, 64])
def test_lane_kernel_equals_solo_launches_and_plain(cuda_device, q, k):
    lanes = _lanes(q, cuda_device, seed=10 * q + k)
    before = st.score_topk_lanes.launches
    vals, idx = st.score_topk_lanes(lanes, k)
    assert st.score_topk_lanes.launches == before + 1
    torch.cuda.synchronize()
    for row, lane in enumerate(lanes):
        s_vals, s_idx = st.score_topk(*lane, k)
        # bit for bit with a solo launch, dead lanes included
        assert torch.equal(vals[row], s_vals) and torch.equal(idx[row], s_idx)
        p_vals, p_idx = st.score_topk_reference(*lane, k)
        ids, tfs = lane[0], lane[1]
        live = min(k, int(((tfs > 0) & (ids < NUM_DOCS)).sum()))
        assert torch.equal(vals[row, :live].cpu(), p_vals[:live].cpu())
        assert torch.equal(idx[row, :live].cpu(), p_idx[:live].cpu())
        assert torch.isneginf(vals[row, live:]).all()
        assert ((idx[row] >= 0) & (idx[row] < ids.shape[0])).all()


@pytest.mark.gpu
def test_lane_kernel_state_resets_between_launches(cuda_device):
    """200 launches back to back on one stream, with the lane count moving
    between 16 and 3: every lane's grid state must be back at 0."""
    lanes = _lanes(16, cuda_device, seed=5)
    want = [tuple(t.cpu() for t in st.score_topk_reference(*lane, 10))
            for lane in lanes]
    outs = [st.score_topk_lanes(lanes if i % 2 else lanes[:3], 10)
            for i in range(200)]
    torch.cuda.synchronize()
    for i, (vals, idx) in enumerate(outs):
        for row in range(vals.shape[0]):
            lane = lanes[row]
            live = min(10, int(((lane[1] > 0) & (lane[0] < NUM_DOCS)).sum()))
            assert torch.equal(vals[row, :live].cpu(), want[row][0][:live])
            assert torch.equal(idx[row, :live].cpu(), want[row][1][:live])


def _hdfs_reader(num_docs=30_720):
    storage = RamStorage(Uri.parse("ram:///cuda-stacking"))
    storage.put("s.split", synthetic_hdfs_split(num_docs, seed=7))
    return SplitReader(storage, "s.split")


def rare_term_group(reader, n, min_len=0):
    """`n` body terms of the padded posting length (at least `min_len`)
    that the most terms share, so that their plans stack."""
    td = reader.term_dict("body")
    lengths, counts = np.unique(td.post_lens, return_counts=True)
    counts[(lengths < min_len) | (counts < n)] = 0
    assert counts.max() > 0
    length = lengths[np.argmax(counts)]
    picks = np.flatnonzero(td.post_lens == length)[:n]
    return [td.blob[td.offsets[i]:td.offsets[i + 1]].decode() for i in picks]


def _stage(reader, query, device, **kw):
    plan = lower_request(query, HDFS_MAPPER, reader, [], **kw)
    arrays, _, _ = warmup_device_arrays(reader, plan, device=device)
    return plan, arrays


def _same(got, want):
    assert int(got["count"]) == int(want["count"])
    for key in ("sort_values", "sort_values2", "doc_ids", "scores"):
        if want[key] is None:
            assert got[key] is None
            continue
        np.testing.assert_array_equal(np.asarray(got[key]).view(np.uint8),
                                      np.asarray(want[key]).view(np.uint8),
                                      err_msg=key)


def _windows(day_us=86400 * 10**6, t0_us=1_600_000_000 * 10**6):
    return [Bool(must=(Term("severity_text", "ERROR"),),
                 filter=(Range("timestamp",
                               lower=RangeBound(t0_us + d * day_us, True),
                               upper=RangeBound(t0_us + (d + 3) * day_us,
                                                False)),))
            for d in range(4)]


@pytest.mark.gpu
def test_stacked_dispatch_on_cuda_matches_cpu(cuda_device):
    """A rare-term group (one lane-kernel launch) and c2's time windows
    (doc space, a masked lane) on the card equal the same dispatches on
    the CPU and each lane's solo call on the card."""
    reader = _hdfs_reader()
    terms = rare_term_group(reader, 8)
    for queries, k, valid, launches in (
            ([Term("body", t) for t in terms], 10, None, 1),
            (_windows(), 100, [True, False, True, True], 0)):
        staged = [_stage(reader, q, cuda_device) for q in queries]
        cpu = [(p, [torch.from_numpy(np.array(a)) for a in p.arrays])
               for p, _ in staged]
        plans = [p for p, _ in staged]
        before = st.score_topk_lanes.launches
        got = executor.readback_plan_stacked(executor.dispatch_plan_stacked(
            plans, k, [a for _, a in staged], valid=valid,
            device=cuda_device))
        assert st.score_topk_lanes.launches - before == launches
        want = executor.readback_plan_stacked(executor.dispatch_plan_stacked(
            plans, k, [a for _, a in cpu], valid=valid, device="cpu"))
        for lane, (g, w) in enumerate(zip(got, want)):
            if valid is not None and not valid[lane]:
                assert g is None and w is None
                continue
            _same(g, w)
            _same(g, executor.execute_plan(plans[lane], k, staged[lane][1],
                                           cuda_device))


@pytest.mark.gpu
def test_convoy_and_chunked_group_on_cuda_match_cpu(cuda_device):
    reader = _hdfs_reader()
    windows = _windows()
    staged = [_stage(reader, q, cuda_device, sort_field="timestamp")
              for q in windows]
    plans = [p for p, _ in staged]
    assert len({tuple(p.array_keys) for p in plans}) == 1
    convoy = executor.readback_plan_multi(executor.dispatch_plan_multi(
        plans[0], 100, staged[0][1], [p.scalars for p in plans],
        device=cuda_device))
    for lane, plan in enumerate(plans):
        _same(convoy[lane], executor.execute_plan(plan, 100, staged[0][1],
                                                  cuda_device))
    # the chunked group scan: dense (the windows, 3+ chunks) and posting
    # (the rare terms: one lane-kernel launch per chunk)
    group = chunkexec.execute_group_chunked(
        plans, 100, [a for _, a in staged], span=8192, device=cuda_device)
    for lane, (plan, arrays) in enumerate(staged):
        _same(group[lane], executor.execute_plan(plan, 100, arrays,
                                                 cuda_device))
    terms = rare_term_group(reader, 8, min_len=3 * 128)
    t_staged = [_stage(reader, Term("body", t), cuda_device) for t in terms]
    mode, total, align = chunkexec.chunk_mode(t_staged[0][0])
    chunks = len(chunkexec.chunk_spans(total, align, align))
    assert mode == "posting" and chunks >= 3
    before = st.score_topk_lanes.launches
    got = chunkexec.execute_group_chunked(
        [p for p, _ in t_staged], 10, [a for _, a in t_staged], span=align,
        device=cuda_device)
    assert st.score_topk_lanes.launches - before == chunks
    for lane, (plan, arrays) in enumerate(t_staged):
        _same(got[lane], executor.execute_plan(plan, 10, arrays,
                                               cuda_device))
