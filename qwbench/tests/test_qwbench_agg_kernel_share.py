"""The reader of the aggregation kernel's share, on hand-built profiles
(the `None` cases among them) and on the profiles of a small cell's
requests: on the CPU, which takes the torch path for every node, and on
the card, where every node of the cell's panels takes the kernel."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from qwbench import cells, harness
from qwbench.node import Node
from qwbench.tests.test_qwbench_reference import small


def read(done):
    return cells.reader("agg_kernel_share")(SimpleNamespace(done=done))


def outcome(profile):
    return SimpleNamespace(response=SimpleNamespace(profile=profile))


def test_the_metric_has_its_reader():
    (metric,) = [m for m in cells.benchmark()["per_layer"]
                 if m["name"] == "agg_kernel_share"]
    assert metric["layer"] == "aggregations"
    assert metric["moves"] == "device_ms_per_query"


def test_the_share_over_requests_and_their_leaves():
    leaf = {"counters": {"agg_evals": 2.0, "agg_kernel_evals": 1.0}}
    root = {"counters": {"agg_evals": 1.0, "agg_kernel_evals": 1.0},
            "leaves": [leaf]}
    bypassed = {"counters": {"agg_evals": 1.0, "agg_kernel_evals": 0.0}}
    assert read([outcome(root), outcome(bypassed)]) == pytest.approx(50.0)


def test_none_where_no_request_carries_it():
    parent = {"counters": {"device_dispatches": 3.0}, "phases": []}
    assert read([]) is None
    assert read([outcome(None)]) is None
    assert read([outcome(parent), outcome(None)]) is None


def share_of_the_cells_requests(device) -> float:
    """The share over six requests of a small cell on `device`."""
    work, config, mix = small("otel-dashboard-open")
    cell = harness.Cell(work, 2**31 + 2_000_000_021, device, config, mix)
    cell.build_corpus()
    node = Node(cell.config, cell.splits, device)
    done = [outcome(node.search(spec["request"], profile=True).profile)
            for spec in cell.schedule(2.0, "share")[0][:6]]
    return read(done)


def test_the_cells_requests_count_their_nodes_on_the_cpu():
    """The CPU computes every node by the torch path: the profiles carry
    the counters, and the share reads 0."""
    assert share_of_the_cells_requests("cpu") == 0.0


@pytest.mark.gpu
def test_the_cells_panels_all_take_the_kernel(cuda):
    assert share_of_the_cells_requests(cuda.type) == pytest.approx(100.0)
