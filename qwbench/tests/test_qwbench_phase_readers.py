"""The readers of the query profile's execute stages, dispatch count and
origin, on hand-built runs (the `None` cases among them) and on the
profiles of a small cell's requests on the CPU."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from qwbench import cells, harness
from qwbench.node import Node
from qwbench.tests.test_qwbench_reference import small

READERS = ("dispatch_cpu_ms", "dispatch_wait_ms", "readback_wait_ms",
           "dispatches_per_query", "admission_lag_ms")


def outcome(profile, due=100.0):
    return SimpleNamespace(due=due, response=SimpleNamespace(profile=profile))


def execute(stage, duration_ms, cpu_ms=None):
    phase = {"name": "execute", "stage": stage, "start_ms": 0.0,
             "duration_ms": duration_ms}
    if cpu_ms is not None:
        phase["cpu_ms"] = cpu_ms
    return phase


def read(name, done):
    return cells.reader(name)(SimpleNamespace(done=done))


def test_every_new_metric_has_its_reader():
    names = {m["name"] for m in cells.benchmark()["per_layer"]}
    assert set(READERS) <= names
    for name in READERS:
        assert callable(cells.reader(name))


def test_the_readers_on_profiles_that_carry_them():
    a = {"origin_s": 100.004, "counters": {"device_dispatches": 3.0},
         "phases": [execute("dispatch", 5.0, 2.0),
                    execute("dispatch_batch", 1.0, 1.0),
                    execute("readback", 4.0, 0.5),
                    {"name": "plan_build", "start_ms": 0.0,
                     "duration_ms": 9.0, "cpu_ms": 9.0}]}
    # a request its caches answered: no dispatch, no readback
    b = {"origin_s": 100.002, "counters": {}, "phases": []}
    done = [outcome(a), outcome(b)]
    assert read("dispatch_cpu_ms", done) == pytest.approx(1.5)
    assert read("dispatch_wait_ms", done) == pytest.approx(1.5)
    assert read("readback_wait_ms", done) == pytest.approx(2.0)
    assert read("dispatches_per_query", done) == pytest.approx(1.5)
    assert read("admission_lag_ms", done) == pytest.approx(3.0)


def test_a_remote_leafs_profile_counts_with_its_root():
    leaf = {"counters": {"device_dispatches": 2.0},
            "phases": [execute("dispatch", 3.0, 1.0),
                       execute("readback", 2.0, 0.1)]}
    root = {"origin_s": 100.0, "counters": {"device_dispatches": 1.0},
            "phases": [], "leaves": [leaf]}
    done = [outcome(root)]
    assert read("dispatch_cpu_ms", done) == pytest.approx(1.0)
    assert read("dispatch_wait_ms", done) == pytest.approx(2.0)
    assert read("readback_wait_ms", done) == pytest.approx(2.0)
    assert read("dispatches_per_query", done) == pytest.approx(3.0)


@pytest.mark.parametrize("name", READERS)
def test_none_where_no_request_carries_it(name):
    # a program without the fields: stages but no cpu_ms, no counter,
    # no origin, and no readback either
    old = {"counters": {"staging_bytes": 5.0},
           "phases": [execute("dispatch", 5.0)]}
    assert read(name, []) is None
    assert read(name, [outcome(None)]) is None
    assert read(name, [outcome(old), outcome(None)]) is None


def test_readback_reads_a_program_without_cpu_time():
    old = {"counters": {}, "phases": [execute("dispatch", 5.0),
                                      execute("readback", 3.0)]}
    done = [outcome(old)]
    assert read("readback_wait_ms", done) == pytest.approx(3.0)
    assert read("dispatch_cpu_ms", done) is None


def test_the_readers_on_a_small_cells_profiles():
    """A few of the cell's requests, profiled on the CPU: every reader
    reads a number, and each request's splits dispatched."""
    work, config, mix = small("otel-dashboard-open")
    cell = harness.Cell(work, 2**31 + 2_000_000_017, "cpu", config, mix)
    cell.build_corpus()
    node = Node(cell.config, cell.splits, "cpu")
    done = []
    for spec in cell.schedule(2.0, "readers")[0][:4]:
        due = time.perf_counter()
        response = node.search(spec["request"], profile=True)
        done.append(SimpleNamespace(due=due, response=response))
    values = {name: read(name, done) for name in READERS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["dispatches_per_query"] >= 1
