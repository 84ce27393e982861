"""CUDA-only check of the external sources' path: phase 14's move at the
small size of `tests/test_torch_sources_path.py` (three indexers plan a
Kafka, a Kinesis and an SQS source, the Kafka task's indexer dies and its
task moves, every source is indexed exactly once), then every search of
that file through a root over a node on the card against a root over a CPU
node on the same metastore and storage. Every response on the card must
equal the CPU root's, and the scored flagship must launch
`score_topk_lanes`. Marked `gpu`; it skips where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda_sources.py` runs it on the card.
"""

import pytest
import torch

from chip_smoke import check_exactly_once_search
from quickwit_tpu_torch.ops.kernels import score_topk as st
from test_torch_root import assert_same_search
from test_torch_sources_path import (SMALL, all_requests, flow_modules,
                                     root_over, run_flow)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sources_searches_on_cuda_equal_cpu(cuda_device):
    m = flow_modules("quickwit_tpu_torch")
    obs, flow = run_flow(m)
    assert obs["exactly_once"]["published_docs"] == {
        kind: SMALL[f"{kind}_docs"] for kind in ("kafka", "kinesis", "sqs")}
    # one node: an index's two splits are one batch (`score_topk_lanes`)
    gpu = root_over(m, flow.resolver, flow.metastore, device=cuda_device,
                    nodes=1)
    cpu = root_over(m, flow.resolver, flow.metastore, nodes=1)
    for kind in ("kafka", "kinesis", "sqs"):
        requests = all_requests(m, f"hdfs-{kind}", SMALL["rare_term"])
        responses = {}
        for name, req in requests.items():
            lanes = st.score_topk_lanes.launches
            responses[name] = gpu.search(req)
            if name == "flagship":
                assert st.score_topk_lanes.launches > lanes
            assert not responses[name].errors
            assert_same_search(responses[name], cpu.search(req))
        check_exactly_once_search(m, flow.docs[kind], SMALL["rare_term"],
                                  responses, kind)
