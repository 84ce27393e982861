"""CUDA-only checks of log search at the hdfs-logs deployment's split size
(`qwbench/configs/hdfs-logs-4x10m.json`): one split of 10,000,000 docs
drawn and built on the card by `qwbench/corpus/hdfs_logs.py`, at the
deployment's density (its first split's 125,000 s), served by the
benchmark's node (`qwbench/node.py`, the root over the port's search
service on `cuda`); every request kind of `qwbench/traffic/log-explorer.json`
judged against the plain reference (`qwbench/reference/search.py`) on the
card, and the fused kernel counted on the query profiles. Marked `gpu`;
they skip where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu
tests/test_torch_cuda_hdfs_search.py` runs it on the card (~2 min, most
of it the split). `tests/test_torch_hdfs_search.py` holds the same kinds
on the CPU at small sizes.
"""

from types import SimpleNamespace

import pytest
import torch

from qwbench import cells, check, traffic
from qwbench.corpus import hdfs_logs
from qwbench.node import Node
from qwbench.reference import search as reference

SEED = 2**31 + 2024
REQUESTS_PER_KIND = 3


@pytest.fixture(scope="module")
def deployment():
    """One full-size split on the card, its node and the reference's
    view of its raw docs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; tests/test_torch_hdfs_search.py "
                    "runs the kinds on the CPU")
    config = cells.load_config("hdfs-logs-4x10m")
    config["span_seconds"] //= config["splits"]
    config["splits"] = 1
    raw = hdfs_logs.draw(config, SEED, "cuda", split=0)
    data, facts = hdfs_logs.build(config, raw)
    node = Node(config, [("s0000", data, facts)], "cuda")
    del data
    split = reference.Split(
        config, raw, "s0000", "cuda",
        lambda doc_id, raw={k: v.cpu() for k, v in raw.items()}:
        hdfs_logs.document(config, raw, doc_id))
    mix = cells.load_traffic("log-explorer")
    specs = traffic.schedule(traffic.at_rate(mix, 2.0), config, 20.0, SEED,
                             "gpu")[0]
    return SimpleNamespace(config=config, node=node, split=split,
                           specs=specs)


def requests_of(deployment, kind: str) -> list:
    found = [s["request"] for s in deployment.specs if s["kind"] == kind]
    assert len(found) >= REQUESTS_PER_KIND
    return found[:REQUESTS_PER_KIND]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [
    "newest_matching", "top_by_score_1", "top_by_score_2", "top_by_score_3",
    "rare_term_lookup", "tenant_errors"])
def test_every_kind_equals_the_reference_on_the_card(deployment, kind):
    limits = deployment.config["check"]["limits"]
    tally = check.empty_tally()
    for request in requests_of(deployment, kind):
        got = check.program_answer(deployment.node.search(request))
        check.judge(got, reference.answer([deployment.split], request),
                    tally, limits["score_gap"])
    assert tally["count_wrong"] == 0, tally
    assert tally["score_gap"] <= limits["score_gap"], tally


def _counters(profile: dict) -> dict:
    out = dict(profile.get("counters", {}))
    for child in profile.get("leaves", ()):
        for name, value in _counters(child).items():
            out[name] = out.get(name, 0.0) + value
    return out


@pytest.mark.gpu
def test_single_word_searches_take_the_fused_kernel(deployment):
    """A scored single-word search over millions of postings and a rare
    word's: each split program that selected hits is counted, and on the
    card the fused kernel computed their top-k. Seven hits, a page no
    request of the mix asks for: a repeated request would be a leaf-cache
    hit, which runs no program."""
    from quickwit_tpu_torch.ops.kernels.score_topk import score_topk
    launches = score_topk.launches
    for rank in (0, 3, 99_990):
        word = hdfs_logs.term_name(deployment.config, "body", rank)
        response = deployment.node.search(
            {"query": {"match": {"body": word}}, "max_hits": 7},
            profile=True)
        counters = _counters(response.profile)
        assert counters["topk_evals"] == 1
        assert counters["topk_kernel_evals"] == 1
    assert score_topk.launches == launches + 3
