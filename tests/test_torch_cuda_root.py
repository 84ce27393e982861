"""CUDA-only checks of the root (search/root.py) over nodes on the card: a
three-node root whose contexts are on `cuda` answers every request of
`tests/test_torch_root.py` as the same root on the CPU does, each node's
batch of a score-sorted request launches `score_topk_lanes` once, a
one-split node's scored request launches `score_topk` once (the launches
of `test_torch_root.KERNEL_CALLS`), and the fetched page holds the hits'
documents. Marked
`gpu`; they skip where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu tests/test_torch_cuda_root.py`
runs it on the card.
"""

import pytest
import torch

from quickwit_tpu_torch.ops.kernels import score_topk as st
from test_torch_root import (
    KERNEL_CALLS, REQUESTS, RootEngine, assert_same_search)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engine():
    engine = RootEngine("torch")
    engine.resolver, engine.metastore, _, _ = engine.populate()
    return engine


@pytest.mark.gpu
def test_root_on_cuda_equals_cpu(cuda_device, engine):
    gpu_root, services = engine.cluster(engine.resolver, engine.metastore,
                                        device=cuda_device)
    cpu_root, _ = engine.cluster(engine.resolver, engine.metastore,
                                 device="cpu")
    for name in sorted(REQUESTS):
        spec = dict(REQUESTS[name])
        query = spec.pop("query")
        solo, lanes = st.score_topk.launches, st.score_topk_lanes.launches
        got = gpu_root.search(engine.request(query, **spec))
        assert (st.score_topk.launches - solo,
                st.score_topk_lanes.launches - lanes) == KERNEL_CALLS[name], \
            name
        want = cpu_root.search(engine.request(query, **spec))
        assert_same_search(got, want)
        assert not got.errors, name
        assert len(got.hits) == min(spec.get("max_hits", 10),
                                    max(got.num_hits
                                        - spec.get("start_offset", 0), 0))
    for service in services.values():
        assert service.context.device.type == "cuda"
        assert service.context.hbm_budget.stats()["pinned"] == 0
