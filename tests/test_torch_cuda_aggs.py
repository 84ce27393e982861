"""CUDA-only checks of the one-pass aggregation kernel
(`quickwit_tpu_torch/ops/kernels/aggs.py`, `csrc/aggs.cu`): on the card,
the state it computes for an aggregation node equals the torch path's
(`executor._eval_agg_torch` over the same CUDA tensors) bit for bit, leaf
by leaf, on 524,288-doc otel-traces splits drawn by
`qwbench/corpus/otel_traces.py` under the dashboard cell's three panels
over 15-minute and 1-hour ranges, and on synthetic columns: empty and full
masks, ordinals and date buckets outside [0, nb), 4, 60 and 1,500 buckets, every
metric kind it takes, and a u64 column at the 2^53 edge, which routes to
the torch path. Marked `gpu`; they skip where there is no GPU.

Like `tests/test_torch_cuda.py` this file imports neither JAX nor the JAX
package: `python -m pytest --noconftest -m gpu tests/test_torch_cuda_aggs.py`
runs it on the card. `tests/test_torch_agg_kernel.py` checks on the CPU
how its synthetic cases route, and that the CPU runs the torch path.
"""

import threading

import numpy as np
import pytest
import torch

from quickwit_tpu_torch.ops.kernels import aggs as ak
from quickwit_tpu_torch.search import executor as ex
from quickwit_tpu_torch.search.plan import (
    BucketAggExec, MetricAggExec, MetricSlots)

GPU_DOCS = 524_288
KINDS = ("percentiles", "avg", "max", "min", "sum", "value_count", "stats")
# the dashboard cell's panels (qwbench/traffic/dashboard-refresh.json)
PANELS = {
    "latency_by_service": {"service": {
        "terms": {"field": "service_name"},
        "aggs": {"latency": {"percentiles": {
            "field": "span_duration_millis", "percents": [50, 95, 99]}}}}},
    "latency_over_time": {"per_minute": {
        "date_histogram": {"field": "span_start_timestamp_nanos",
                           "fixed_interval": "1m"},
        "aggs": {"avg_duration": {"avg": {"field": "span_duration_millis"}},
                 "max_duration": {"max": {
                     "field": "span_duration_millis"}}}}},
    "latency_percentiles": {"latency": {"percentiles": {
        "field": "span_duration_millis", "percents": [50, 95, 99]}}},
}


@pytest.fixture(autouse=True)
def whole_split_programs(monkeypatch):
    """One program per split: the chunked scan's config and sizer are
    process-wide, and the sizer learns from any earlier chunked run."""
    from quickwit_tpu_torch.search import chunkexec
    monkeypatch.setattr(chunkexec, "CHUNKING", chunkexec.ChunkConfig())
    monkeypatch.setattr(chunkexec, "CHUNK_SIZER", chunkexec._ChunkSizer())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the routing's cases run in "
                    "tests/test_torch_agg_kernel.py")
    return torch.device("cuda")


# --- comparing states -----------------------------------------------------

def leaves(tree, path="state"):
    """(path, tensor) of every tensor of an aggregation state, in order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, f"{path}.{key}")
    else:
        for i, value in enumerate(tree):
            yield from leaves(value, f"{path}[{i}]")


def assert_same_state(got, want, label: str = "state") -> None:
    """Equal structure, dtypes and shapes, and every leaf bit for bit (f64
    compared by its bits, so -0.0 is not +0.0)."""
    got, want = list(leaves(got, label)), list(leaves(want, label))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), path


def kernel_and_torch(node, view, mask):
    """(the kernel's state, the torch path's) of one node; the node must
    route to the kernel."""
    route = ex._kernel_route(node, view, mask.shape[0])
    assert route is not None, node
    return (ex._eval_agg_kernel(route, mask),
            ex._eval_agg_torch(node, view, view.scalars, mask))


# --- synthetic columns ----------------------------------------------------

# slots of the synthetic view
(ORDINALS, TS, TS_PRESENT, DURATION, DURATION_PRESENT, EDGE, ALL, SCALED,
 TS_PACKED) = range(9)
(ORIGIN, INTERVAL, SCALE, MIN, EDGE_SCALE, EDGE_MIN, SCALED_SCALE,
 SCALED_MIN, TS_SCALE, TS_MIN, TS_ORIGIN, TS_INTERVAL) = range(12)
TS_BASE_US = 1_700_000_000_000_000


def edge_min(docs: int) -> int:
    """The smallest FOR min of a u8-lane u64 column whose bound, (min +
    255) * docs, reaches 2^53: that column routes to torch, one below does
    not."""
    return 2**53 // docs - 255


def synthetic_view(docs: int, nb: int, device, seed: int = 3,
                   edge: int | None = None):
    """A `_RebaseView` over columns as a split stores them: i32 ordinals
    in [-1, nb + 3) (outside [0, nb) on both sides); a sorted i32 seconds
    column with holes, and the same times as u32 lanes of an i64 micros
    column (FOR scale 10^6), whose minute buckets also fall outside [0,
    nb); u16 lanes of a u64 duration column (FOR min 5) with holes; u8
    lanes of a u64 column with min `edge` (default: one below the 2^53
    edge); u8 lanes of an i64 column (FOR scale 7, min -300: negative
    values)."""
    rng = np.random.RandomState(seed)
    interval = 60
    ts = np.sort(rng.randint(-2 * interval, (nb + 2) * interval, docs))
    arrays = [
        rng.randint(-1, nb + 3, docs).astype(np.int32),
        ts.astype(np.int32),
        (rng.rand(docs) < 0.97).astype(np.uint8),
        np.minimum(np.exp(rng.normal(2.0, 1.5, docs)), 65535).astype(
            np.uint16),
        (rng.rand(docs) < 0.9).astype(np.uint8),
        rng.randint(0, 256, docs).astype(np.uint8),
        np.ones(docs, dtype=np.uint8),
        rng.randint(0, 256, docs).astype(np.uint8),
        (ts + 2 * interval).astype(np.uint32),
    ]
    arrays[DURATION][:7] = (0, 1, 2, 65535, 0, 3, 65534)   # bucket 0, tails
    scalars = [np.asarray(0, np.int32), np.asarray(interval, np.int32),
               np.asarray(1, np.uint64), np.asarray(5, np.uint64),
               np.asarray(1, np.uint64),
               np.asarray(edge_min(docs) - 1 if edge is None else edge,
                          np.uint64),
               np.asarray(7, np.int64), np.asarray(-300, np.int64),
               np.asarray(1_000_000, np.int64),
               np.asarray(TS_BASE_US, np.int64),
               np.asarray(TS_BASE_US + 2 * interval * 1_000_000, np.int64),
               np.asarray(interval * 1_000_000, np.int64)]
    rebase = {DURATION: (SCALE, MIN), EDGE: (EDGE_SCALE, EDGE_MIN),
              SCALED: (SCALED_SCALE, SCALED_MIN),
              TS_PACKED: (TS_SCALE, TS_MIN)}
    return ex._RebaseView([torch.from_numpy(a).to(device) for a in arrays],
                          scalars, rebase)


def synthetic_masks(docs: int, device, seed: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    window = np.zeros(docs, dtype=bool)
    window[docs // 3: docs // 3 + docs // 4] = True   # a time range
    masks = {"empty": np.zeros(docs, dtype=bool),
             "full": np.ones(docs, dtype=bool),
             "random": rng.rand(docs) < 0.25,
             "window": window}
    return {name: torch.from_numpy(m).to(device) for name, m in masks.items()}


def metric(kind: str, values=DURATION, present=DURATION_PRESENT):
    return MetricSlots(f"m_{kind}_{values}", kind, values, present)


def edge_node() -> BucketAggExec:
    return BucketAggExec("e", "terms", ORDINALS, -1, 4,
                         metrics=(metric("avg", EDGE, ALL),))


def synthetic_nodes(nb: int) -> dict:
    """Every node shape the kernel takes, over the synthetic view."""
    metrics = tuple(metric(kind) for kind in KINDS)
    return {
        "terms_counts": BucketAggExec("t", "terms", ORDINALS, -1, nb),
        "terms_metrics": BucketAggExec("t", "terms", ORDINALS, -1, nb,
                                       metrics=metrics),
        "date_histogram_metrics": BucketAggExec(
            "d", "date_histogram", TS, TS_PRESENT, nb, ORIGIN, INTERVAL,
            metrics=metrics),
        "date_histogram_packed_i64": BucketAggExec(
            "d", "date_histogram", TS_PACKED, TS_PRESENT, nb, TS_ORIGIN,
            TS_INTERVAL, metrics=(metric("avg"), metric("percentiles"))),
        "date_histogram_three_columns": BucketAggExec(
            "d", "date_histogram", TS, TS_PRESENT, nb, ORIGIN, INTERVAL,
            metrics=(metric("avg"), metric("max", SCALED, ALL),
                     metric("percentiles"), metric("stats", SCALED, ALL),
                     metric("sum", EDGE, ALL))),
        **{f"top_{kind}": MetricAggExec(f"top_{kind}", metric(kind))
           for kind in KINDS},
        "top_stats_negative": MetricAggExec("n", metric("stats", SCALED,
                                                        ALL)),
        "top_percentiles_negative": MetricAggExec(
            "n", metric("percentiles", SCALED, ALL)),
        "terms_edge_avg": edge_node(),
    }


def run_synthetic(device, docs: int, nb: int):
    """(case, kernel state, torch state) of every synthetic node under
    every synthetic mask."""
    view = synthetic_view(docs, nb, device)
    for mask_name, mask in synthetic_masks(docs, device).items():
        for node_name, node in synthetic_nodes(nb).items():
            got, want = kernel_and_torch(node, view, mask)
            yield f"{node_name}/{mask_name}/nb={nb}", got, want


def edge_routes(device, docs: int) -> tuple:
    """Whether the u64 column routes to the kernel at its 2^53 edge and
    one below."""
    return tuple(ex._kernel_route(edge_node(),
                                  synthetic_view(docs, 4, device, edge=m),
                                  docs) is not None
                 for m in (edge_min(docs), edge_min(docs) - 1))


# --- on the card -------------------------------------------------------------

# 4 and 60 buckets; 1,500 takes the paths past shared memory (the
# per-bucket state and the sketch counted in global memory)
BUCKETS = [4, 60, 1500]


@pytest.mark.gpu
@pytest.mark.parametrize("nb", BUCKETS)
def test_kernel_equals_torch_path_on_synthetic_columns(cuda_device, nb):
    before = ak.bucket_aggregate.launches
    cases = 0
    for case, got, want in run_synthetic(cuda_device, GPU_DOCS, nb):
        assert_same_state(got, want, case)
        cases += 1
    assert cases == 4 * len(synthetic_nodes(nb))
    assert ak.bucket_aggregate.launches > before


@pytest.mark.gpu
def test_u64_column_at_the_2_53_edge_routes_to_torch(cuda_device):
    assert edge_routes(cuda_device, GPU_DOCS) == (False, True)


@pytest.mark.gpu
def test_kernel_repeats_its_bits(cuda_device):
    view = synthetic_view(GPU_DOCS, 60, cuda_device)
    mask = synthetic_masks(GPU_DOCS, cuda_device)["random"]
    node = synthetic_nodes(60)["terms_metrics"]
    route = ex._kernel_route(node, view, GPU_DOCS)
    first = ex._eval_agg_kernel(route, mask)
    for _ in range(3):
        assert_same_state(ex._eval_agg_kernel(route, mask), first)


@pytest.mark.gpu
def test_profile_counts_kernel_nodes_on_the_card(cuda_device):
    """Of three nodes the two the kernel takes count as kernel nodes, and
    launch once each; the extended_stats node takes the torch path."""
    from quickwit_tpu_torch.observability.profile import (
        AGG_EVALS, AGG_KERNEL_EVALS, QueryProfile, profile_scope)
    view = synthetic_view(GPU_DOCS, 60, cuda_device)
    mask = synthetic_masks(GPU_DOCS, cuda_device)["random"]
    nodes = synthetic_nodes(60)
    bypass = BucketAggExec("x", "terms", ORDINALS, -1, 60,
                           metrics=(metric("extended_stats"),))
    aggs = [nodes["top_percentiles"], bypass, nodes["terms_counts"]]
    profile = QueryProfile("q")
    before = ak.bucket_aggregate.launches
    with profile_scope(profile):
        got = ex._eval_aggs(aggs, view, view.scalars, mask)
    assert ak.bucket_aggregate.launches - before == 2
    assert profile.counters()[AGG_EVALS] == 3
    assert profile.counters()[AGG_KERNEL_EVALS] == 2
    assert_same_state(got, [ex._eval_agg_torch(a, view, view.scalars, mask)
                            for a in aggs])


@pytest.mark.gpu
def test_bad_launch_raises_and_does_not_fall_back(cuda_device):
    mask = torch.ones(GPU_DOCS, dtype=torch.bool, device=cuda_device)
    lanes = torch.zeros(GPU_DOCS, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        ak.bucket_aggregate(mask, 1, ak.SKETCH, metric=ak.Column(lanes))


# --- the dashboard cell's splits ------------------------------------------

@pytest.fixture(scope="module")
def otel_split():
    """One 524,288-span split of the dashboard cell's corpus, its config
    and its mapper."""
    from qwbench import cells
    from qwbench.corpus import otel_traces
    from quickwit_tpu_torch.common.uri import Uri
    from quickwit_tpu_torch.index.reader import SplitReader
    from quickwit_tpu_torch.models.doc_mapper import DocMapper
    from quickwit_tpu_torch.storage.ram import RamStorage
    config = cells.load_config("otel-traces-64x512k")
    assert config["docs_per_split"] == GPU_DOCS
    raw = otel_traces.draw(config, 2_147_500_021, "cpu", split=5)
    data, facts = otel_traces.build(config, raw)
    storage = RamStorage(Uri.parse("ram:///cuda_aggs"))
    storage.put("s.split", data)
    return (config, DocMapper.from_dict(config["doc_mapping"]),
            SplitReader(storage, "s.split"), facts)


@pytest.mark.gpu
@pytest.mark.parametrize("range_s", [900, 3600], ids=["15m", "1h"])
@pytest.mark.parametrize("panel", sorted(PANELS))
def test_kernel_equals_torch_path_on_the_cell_panels(cuda_device, otel_split,
                                                     monkeypatch, panel,
                                                     range_s):
    from quickwit_tpu_torch.query.ast import MatchAll
    from quickwit_tpu_torch.search import leaf
    from quickwit_tpu_torch.search.models import SearchRequest
    config, mapper, reader, facts = otel_split
    end_us = (config["start_ts"] + config["span_seconds"]) * 1_000_000
    request = SearchRequest(index_ids=["otel"], query_ast=MatchAll(),
                            max_hits=0, aggs=PANELS[panel],
                            start_timestamp=end_us - range_s * 1_000_000,
                            end_timestamp=end_us)
    seen = []
    evaluate = ex._eval_aggs
    caller = threading.get_ident()

    def compared(aggs, view, scalars, valid):
        # threads that earlier tests of the process left running may
        # search too: only this test's own program is counted
        if threading.get_ident() == caller:
            for node in aggs:
                got, want = kernel_and_torch(node, view, valid)
                assert_same_state(got, want)
                seen.append(int(valid.sum()))
        return evaluate(aggs, view, scalars, valid)

    monkeypatch.setattr(ex, "_eval_aggs", compared)
    before = ak.bucket_aggregate.launches
    plan = leaf.prepare_plan_only(request, mapper, reader, "s")
    arrays, _, _ = leaf.warmup_device_arrays(reader, plan,
                                             device=cuda_device)
    leaf.execute_prepared_split(request, mapper, reader, "s", plan, arrays,
                                cuda_device)
    assert len(seen) == 1 and 0 < seen[0] <= facts["num_docs"]
    assert ak.bucket_aggregate.launches > before
