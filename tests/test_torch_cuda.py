"""CUDA-only checks of the port: each kernel against its plain torch version
on the card, and the leaf search on `cuda` against the same search on the
CPU. Marked `gpu`; they skip where there is no GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda.py` (the repository's conftest.py configures JAX).
"""

import numpy as np
import pytest
import torch

from quickwit_tpu_torch.common.uri import Uri
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER, body_term, synthetic_hdfs_split)
from quickwit_tpu_torch.ops.kernels.score_topk import (
    score_topk, score_topk_reference)
from quickwit_tpu_torch.query.ast import Term
from quickwit_tpu_torch.search.executor import _widened
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
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


def make_case(num_postings, seed, all_invalid=False, equal_scores=False):
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(NUM_DOCS, num_postings,
                             replace=False)).astype(np.int32)
    tfs = rng.randint(1, 5, num_postings).astype(np.int32)
    norms = rng.randint(1, 50, NUM_DOCS + 1).astype(np.int32)
    pad = min(64, num_postings - 1)
    if pad > 0:
        tfs[-pad:] = 0
        ids[-pad:] = 2**30
    if equal_scores:
        tfs[tfs > 0] = 1
        norms[:] = 7
    if all_invalid:
        ids[:] = 2**30
        tfs[:] = 0
    return ids, tfs, norms


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_score_topk_kernel_matches_plain_version(cuda_device, case):
    num_postings, k, flags = CASES[case]
    ids, tfs, norms = make_case(num_postings, num_postings, **flags)
    idf, avg_len = np.float32(2.17), np.float32(9.3)
    num_valid = int(((tfs > 0) & (ids < NUM_DOCS)).sum())
    inputs = [torch.from_numpy(a) for a in (ids, tfs, norms)]
    want_vals, want_idx = score_topk_reference(*inputs, idf, avg_len,
                                               NUM_DOCS, k)
    before = score_topk.launches
    vals, idx = score_topk(*(t.to(cuda_device) for t in inputs), idf,
                           avg_len, NUM_DOCS, k)
    torch.cuda.synchronize()
    assert score_topk.launches == before + 2
    vals, idx = vals.cpu(), idx.cpu()
    live = min(num_valid, k)
    assert torch.equal(idx[:live], want_idx[:live])
    assert torch.equal(vals[:live], want_vals[:live])
    assert torch.isneginf(vals[live:]).all()
    assert ((idx >= 0) & (idx < num_postings)).all()


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
