"""The port's query profile inside the `execute` phase: thread CPU time on
every timed phase, the stage of every execute phase from its entry, an
origin on `time.perf_counter`, the `device_dispatches` counter (a shared
dispatch counted once for each rider), `qw.*` ranges in a torch profiler,
and the `phase.*` spans only while the tracer has a processor. An
unprofiled search pays for none of it.

Port only, on the CPU: the corpus and root of `tests/test_torch_root.py`
(six splits of one index), one node on the per-split route.
"""

import time

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from quickwit_tpu_torch import native as t_native
from quickwit_tpu_torch.index import writer as t_writer
from quickwit_tpu_torch.observability.metrics import (
    SEARCH_KERNEL_LAUNCHES_TOTAL,
)
from quickwit_tpu_torch.observability import profile as profile_mod
from quickwit_tpu_torch.observability.profile import (
    DEVICE_DISPATCHES, PHASE_EXECUTE, QueryProfile, profile_scope,
    shared_dispatch,
)
from quickwit_tpu_torch.observability.tracing import TRACER
from quickwit_tpu_torch.search.batcher import QueryBatcher

from test_torch_query_batcher import run_group
from test_torch_query_batching import SEVS, Query, sev, write_split
from test_torch_root import AGGS, NUM_SPLITS, RootEngine

# the phases `QueryProfile.phase` times on an aggregation-only search;
# the others are waits timed elsewhere (`record_phase`)
TIMED = ("plan_build", "staging_upload", "staging_cache_hit", "execute",
         "root_merge", "fetch_docs")
# `round(..., 3)` on each of cpu_ms and duration_ms
ROUNDING_MS = 0.002


@pytest.fixture(scope="module")
def engine():
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_writer, "_native_capable", lambda fm: None)
        mp.setattr(t_native, "_cached", None)
        engine = RootEngine("torch")
        engine.resolver, engine.metastore, _, _ = engine.populate()
    finally:
        mp.undo()
    return engine


def fresh_root(engine):
    """A root over one new node on the per-split route: no cache tier
    holds an answer yet, so every split dispatches."""
    root, _ = engine.cluster(engine.resolver, engine.metastore, num_nodes=1,
                             batch_size=1, prefetch=False)
    return root


def aggs_search(engine, root=None, profile=True):
    root = root or fresh_root(engine)
    return root.search(engine.request("*", max_hits=0, aggs=AGGS,
                                      profile=profile))


def execute_phases(profile):
    return [p for p in profile["phases"] if p["name"] == PHASE_EXECUTE]


def test_timed_phases_carry_thread_cpu_time(engine):
    profile = aggs_search(engine).profile
    timed = [p for p in profile["phases"] if p["name"] in TIMED]
    assert {p["name"] for p in timed} >= {"plan_build", "execute",
                                          "root_merge"}
    for p in timed:
        assert 0.0 <= p["cpu_ms"] <= p["duration_ms"] + ROUNDING_MS, p
    # waits timed elsewhere carry no CPU time
    assert all("cpu_ms" not in p for p in profile["phases"]
               if p["name"] not in TIMED)


def test_every_execute_phase_has_its_stage(engine):
    phases = execute_phases(aggs_search(engine).profile)
    stages = sorted(p["stage"] for p in phases)
    assert stages == ["dispatch"] * NUM_SPLITS + ["readback"] * NUM_SPLITS


def test_origin_is_on_the_callers_perf_counter(engine):
    root = fresh_root(engine)
    before = time.perf_counter()
    profile = aggs_search(engine, root).profile
    after = time.perf_counter()
    assert before <= profile["origin_s"] <= after
    for p in profile["phases"]:
        end = profile["origin_s"] + (p["start_ms"] + p["duration_ms"]) / 1e3
        assert before <= end <= after + ROUNDING_MS / 1e3, p


def test_device_dispatches_count_every_launch(engine):
    """On the per-split route a cold request launches each split's program
    and, as the predicate cache misses, each split's mask fill: the
    profile counts every launch the node's launch counter counts."""
    root = fresh_root(engine)
    launches = SEARCH_KERNEL_LAUNCHES_TOTAL.get()
    profile = aggs_search(engine, root).profile
    launched = SEARCH_KERNEL_LAUNCHES_TOTAL.get() - launches
    assert profile["counters"][DEVICE_DISPATCHES] == launched \
        == 2 * NUM_SPLITS
    dispatches = [p for p in execute_phases(profile)
                  if p["stage"].startswith("dispatch")]
    assert len(dispatches) == NUM_SPLITS


@pytest.fixture(scope="module")
def split():
    return write_split(300, 9, "spans")


@pytest.mark.parametrize("profiled", [(True, True, True),
                                      (False, True, True)],
                         ids=["every_rider", "not_the_first"])
def test_a_shared_dispatch_counts_once_for_each_rider(split, profiled):
    """Three distinct queries stacked into one dispatch: each profiled
    rider's profile counts it once, whether or not the leader is
    profiled; only the leader holds execute phases, on its own
    timeline."""
    queries = [Query(split, sev(s), max_hits=5) for s in SEVS]
    profiles = [QueryProfile(f"q{i}") if on else None
                for i, on in enumerate(profiled)]
    results = run_group(QueryBatcher(), queries, 5, profiles=profiles)
    assert not any(isinstance(r, Exception) for r in results)
    profiles = [p for p in profiles if p is not None]
    assert [p.counters().get(DEVICE_DISPATCHES) for p in profiles] == \
        [1.0] * len(profiles)
    leaders = [p for p in profiles
               if any(ph["name"] == PHASE_EXECUTE for ph in p.phases())]
    if len(profiles) < len(queries) and not leaders:
        return      # the unprofiled rider led
    assert len(leaders) == 1
    stages = sorted(ph["stage"] for ph in leaders[0].phases()
                    if ph["name"] == PHASE_EXECUTE)
    assert stages == ["dispatch_stacked", "readback"]
    now_ms = (time.perf_counter() - leaders[0].origin) * 1e3
    assert all(0.0 <= ph["start_ms"] <= now_ms for ph in leaders[0].phases())


def test_shared_dispatch_with_no_other_rider_profiled_is_a_no_op():
    owner = QueryProfile("owner")
    with profile_scope(owner):
        assert shared_dispatch([owner, None]) is profile_mod._NULL_PHASE
    assert shared_dispatch([None, None]) is profile_mod._NULL_PHASE


def range_names(prof):
    return {e.name for e in prof.events() if e.name.startswith("qw.")}


def cpu_profiler():
    """A CPU profiler of every thread: the fan-out's pool threads record
    the leaf phases."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def test_a_torch_profiler_holds_the_phase_ranges(engine):
    root = fresh_root(engine)
    with cpu_profiler() as prof:
        aggs_search(engine, root)
    names = range_names(prof)
    assert {"qw.execute.dispatch", "qw.execute.readback",
            "qw.plan_build", "qw.root_merge"} <= names, sorted(names)


def test_an_attached_processor_receives_the_phase_spans(engine):
    finished = []
    TRACER.add_processor(finished.append)
    try:
        aggs_search(engine)
    finally:
        TRACER.remove_processor(finished.append)
    names = {s.name for s in finished}
    assert {"root_search", "phase.plan_build", "phase.execute"} <= names


def test_no_processor_builds_no_phase_span(engine, monkeypatch):
    opened = []
    span = TRACER.span

    def counting(name, *args, **kw):
        opened.append(name)
        return span(name, *args, **kw)

    monkeypatch.setattr(TRACER, "span", counting)
    profile = aggs_search(engine).profile
    assert execute_phases(profile)
    assert "root_search" in opened
    assert not [name for name in opened if name.startswith("phase.")]


def test_an_unprofiled_search_records_nothing(engine, monkeypatch):
    """No phase is timed (so no CPU clock is read), no range opens under a
    running torch profiler, no phase span reaches a processor."""
    timed = []
    phase = QueryProfile.phase

    def counting(self, name, **attrs):
        timed.append(name)
        return phase(self, name, **attrs)

    monkeypatch.setattr(QueryProfile, "phase", counting)
    finished = []
    TRACER.add_processor(finished.append)
    root = fresh_root(engine)
    try:
        with cpu_profiler() as prof:
            response = aggs_search(engine, root, profile=False)
    finally:
        TRACER.remove_processor(finished.append)
    assert response.profile is None and response.num_hits > 0
    assert timed == []
    assert range_names(prof) == set()
    assert "root_search" in {s.name for s in finished}
    assert not [s.name for s in finished if s.name.startswith("phase.")]
