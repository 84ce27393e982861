"""CUDA-only check of the gRPC plane, the SQL metastore and the offload
pool: `chip_smoke.check_grpc_offload` (phase 16) on the card over a small
phase-12-like setup (8 hdfs splits of 8,192 docs, 24 otel splits of 4,096,
`chip_smoke.phase12_like`), whose flagship and c5 answers come from a root
over a CPU node. Three port nodes on `cuda` with `grpc_port=0` over a
`sqlite://` metastore must give the CPU root's answers through
`GrpcSearchClient`; node M must offload c5's cold tail to two worker
nodes, then to one, then run it all itself, each time with the same
answer; the scored leaf request through the offload must launch
`score_topk_lanes`. Marked `gpu`; it skips where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda_grpc_offload.py` runs it on the card.
"""

import pytest
import torch

from chip_smoke import (check_grpc_offload, grpc_offload_modules,
                        hdfs_requests, phase12_like)
from quickwit_tpu_torch.ops.kernels import score_topk as st


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_grpc_sql_and_offload_on_cuda_equal_cpu(cuda_device):
    m = grpc_offload_modules()
    flagship_aggs = hdfs_requests(m.SearchRequest, m.Term,
                                  m.body_term)["flagship"].aggs
    rooted = phase12_like(m, 8, 8192, 24, 4096, flagship_aggs)
    out = check_grpc_offload(torch, st, m, cuda_device, "cuda", 3, rooted,
                             local_splits=8)
    assert out["launches"]["score_topk_lanes"] >= 2
