"""CUDA-only check of the write path: `tests/test_torch_write_path.py`'s
flow (WAL ingest, one ingest pass into four splits, a delete task and the
janitor, the merge, GC) in the port with the delete planner's probes on
the card, searching after every step through a root over nodes on the
card and a root over CPU nodes over the same metastore and storage. Every
response on the card must equal the CPU root's, the planner must rewrite
one split and fast-forward the three whose probes on the card found no
match, and the roots' scored requests must launch `score_topk_lanes`.
Marked `gpu`; it skips where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda_write_path.py` runs it on the card.
"""

import random

import pytest
import torch

from quickwit_tpu_torch.ops.kernels import score_topk as st
from test_torch_indexing import WriteEngine
from test_torch_root import assert_same_search
from test_torch_write_path import SEED, check_flow, write_path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_write_path_on_cuda_equals_cpu(cuda_device, tmp_path):
    e = WriteEngine("quickwit_tpu_torch")
    lanes = st.score_topk_lanes.launches
    with e.clock.use_clock(e.clock.FakeClock()), \
            e.clock.use_rng(random.Random(SEED)):
        steps = write_path(e, str(tmp_path / "wal"),
                           {"cuda": cuda_device, "cpu": "cpu",
                            "planner": cuda_device})
    assert st.score_topk_lanes.launches > lanes
    check_flow(steps)
    for step, _obs, responses, _files in steps:
        for name, want in responses["cpu"].items():
            assert_same_search(responses["cuda"][name], want)
    janitor = dict(steps[2][1])
    assert (janitor["delete_splits_rewritten"],
            janitor["delete_splits_fast_forwarded"]) == (1, 3)
