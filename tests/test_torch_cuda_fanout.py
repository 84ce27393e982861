"""CUDA-only checks of the multi-split batch (parallel/fanout.py): a batch
on the card equals the same batch on the CPU, and its fused step launches
`score_topk_lanes` once per at most 16 splits (never a solo `score_topk`);
the service's batch route on the card equals a CPU context's. Marked
`gpu`; they skip where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
tests/test_torch_cuda_stacking.py tests/test_torch_cuda_fanout.py` runs
them on the card.
"""

import pytest
import torch

from quickwit_tpu_torch.common.uri import Protocol, Uri
from quickwit_tpu_torch.index.reader import SplitReader
from quickwit_tpu_torch.index.synthetic import (
    HDFS_MAPPER, synthetic_hdfs_split)
from quickwit_tpu_torch.ops.kernels import score_topk as st
from quickwit_tpu_torch.parallel import fanout
from quickwit_tpu_torch.query.ast import Bool, Range, RangeBound, Term
from quickwit_tpu_torch.search import models, service as svc_mod
from quickwit_tpu_torch.search.models import SearchRequest, SortField
from quickwit_tpu_torch.storage.base import StorageResolver
from quickwit_tpu_torch.storage.ram import RamStorage

NUM_SPLITS = 18          # two lane-kernel launches: 16 + 2 splits
DOCS = 30_720
T0_US = (1_600_000_000 + 86_400) * 1_000_000   # the split's day 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def storage():
    store = RamStorage(Uri.parse("ram:///cuda_fanout"))
    for i in range(NUM_SPLITS):
        store.put(f"s{i:02d}.split", synthetic_hdfs_split(DOCS, seed=300 + i))
    return store


def _readers(storage):
    return [SplitReader(storage, f"s{i:02d}.split")
            for i in range(NUM_SPLITS)]


FLAGSHIP_AGGS = {
    "per_day": {"date_histogram": {"field": "timestamp",
                                   "fixed_interval": "1d"}},
    "sev": {"terms": {"field": "severity_text"}},
}

REQUESTS = {
    "flagship": SearchRequest(
        index_ids=["hdfs"], query_ast=Term("severity_text", "ERROR"),
        max_hits=10, aggs=FLAGSHIP_AGGS),
    "c2_by_timestamp": SearchRequest(
        index_ids=["hdfs"],
        query_ast=Bool(must=(Term("severity_text", "INFO"),),
                       filter=(Range("timestamp",
                                     lower=RangeBound(T0_US, True)),)),
        max_hits=100,
        sort_fields=(SortField("timestamp", "desc"),
                     SortField("tenant_id", "asc"))),
    "dashboard": SearchRequest(
        index_ids=["hdfs"], query_ast=Term("severity_text", "WARN"),
        max_hits=0, aggs=FLAGSHIP_AGGS),
}


def _key(resp):
    return (resp.num_hits,
            [(h.split_id, h.doc_id, h.sort_value, h.raw_sort_value,
              h.sort_value2, h.raw_sort_value2) for h in resp.partial_hits],
            repr(sorted(resp.intermediate_aggs.items())))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(REQUESTS))
def test_batch_on_cuda_equals_cpu(cuda_device, storage, name):
    req = REQUESTS[name]
    ids = [f"s{i:02d}" for i in range(NUM_SPLITS)]
    batch = fanout.build_batch(req, HDFS_MAPPER, _readers(storage), ids)
    solo, lanes = st.score_topk.launches, st.score_topk_lanes.launches
    got = fanout.execute_batch(batch, req, device=cuda_device)
    fused = name == "flagship"
    assert st.score_topk_lanes.launches - lanes == (2 if fused else 0)
    assert st.score_topk.launches - solo == 0
    want = fanout.execute_batch(
        fanout.build_batch(req, HDFS_MAPPER, _readers(storage), ids), req,
        device="cpu")
    assert _key(got) == _key(want)
    assert got.num_hits > 0
    # a repeat on the card reuses the staged lanes and answers alike
    assert _key(fanout.execute_batch(batch, req, device=cuda_device)) == \
        _key(got)


@pytest.mark.gpu
def test_service_batch_route_on_cuda_equals_cpu(cuda_device, storage):
    resolver = StorageResolver()
    resolver.register(Protocol.RAM, lambda _uri: storage)
    splits = [models.SplitIdAndFooter(
        f"s{i:02d}", "ram:///cuda_fanout",
        storage.file_num_bytes(f"s{i:02d}.split"), num_docs=DOCS)
        for i in range(NUM_SPLITS)]

    def run(device, req):
        ctx = svc_mod.SearcherContext(storage_resolver=resolver,
                                      device=device, batch_size=8,
                                      enable_agg_cache=False)
        return svc_mod.SearchService(ctx).leaf_search(
            models.LeafSearchRequest(
                search_request=req, index_uid="hdfs:0",
                doc_mapping=HDFS_MAPPER.to_dict(), splits=splits))

    for name, req in REQUESTS.items():
        lanes = st.score_topk_lanes.launches
        got = run(cuda_device, req)
        assert not got.failed_splits
        if name == "flagship":
            # groups of 8, 8 and 2 splits: one lane launch each
            assert st.score_topk_lanes.launches - lanes == 3
        assert _key(got) == _key(run("cpu", req))
