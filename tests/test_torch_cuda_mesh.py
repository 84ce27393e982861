"""CUDA-only check of the fan-out's device mesh and the SQL route:
`chip_smoke.check_mesh` (phase 17) on the card over a small phase-12-like
setup (8 hdfs splits of 8,192 docs, 16 otel splits of 4,096,
`chip_smoke.phase12_like`). On grids of the card repeated, every batch
over the mesh must equal the single-device batch with the lane kernel
launched on each row of a scored request, one mesh dispatch and the grid's
rows in the `qw_mesh_*` deltas; the NaN input, the query groups and a
service with `mesh_devices` likewise; and `POST /api/v1/_sql` on a node
on the card must answer as `execute_sql` over a CPU root. Marked `gpu`;
it skips where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu tests/test_torch_cuda_mesh.py`
runs it on the card.
"""

import pytest
import torch

from chip_smoke import check_mesh, hdfs_requests, mesh_modules, phase12_like
from quickwit_tpu_torch.ops.kernels import score_topk as st


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mesh_and_sql_on_cuda_equal_single_device(cuda_device):
    m = mesh_modules()
    flagship_aggs = hdfs_requests(m.SearchRequest, m.Term,
                                  m.body_term)["flagship"].aggs
    rooted = phase12_like(m, 8, 8192, 16, 4096, flagship_aggs)
    out = check_mesh(torch, st, m, cuda_device, "cuda", 3, rooted,
                     otel_index="otel-traces")
    # the flagship's rows on meshes of 2, 4 and 8 rows: 2 + 4 + 8
    assert out["launches"]["score_topk_lanes"] >= 14
    assert out["launches"]["score_topk"] == 0
