"""Chaos suite for the port's resumable chunked leaf scan
(search/chunkexec.py), against the port's `common/faults.py::FaultInjector`.

The counterpart of the JAX package's tests/test_chaos_chunked.py. Two
injection points guard the carried state across chunk boundaries:

- `kernel.chunk_yield` fires at the boundary control point. A fault there
  drops the carried state and re-executes from chunk 0 (counted in
  qw_chunk_restarts_total); a fault storm degrades to the fused program.
- `kernel.preempt_park` fires while the carried state is parked during a
  preemption yield: a fault (a parked-state eviction) also forces a clean
  re-execution.

Both packages read the same split bytes (written by the JAX package) and
run the same fault schedule: the port's result must equal its fused
program's and the JAX scan's, and its fired schedule the JAX injector's.
All faults use `every`/`max_fires` schedules, never probability.
"""

import threading
import time

import numpy as np
import pytest
import torch

from quickwit_tpu.common import faults as j_faults
from quickwit_tpu.common.uri import Uri as JUri
from quickwit_tpu.index.reader import SplitReader as JSplitReader
from quickwit_tpu.index.writer import SplitWriter as JSplitWriter
from quickwit_tpu.models import doc_mapper as jdm
from quickwit_tpu.query import ast as JQ
from quickwit_tpu.search import chunkexec as jc
from quickwit_tpu.search.plan import lower_request as j_lower
from quickwit_tpu.storage.ram import RamStorage as JRamStorage

from quickwit_tpu_torch.common import faults as t_faults
from quickwit_tpu_torch.common.uri import Uri as TUri
from quickwit_tpu_torch.index.format import POSTING_PAD
from quickwit_tpu_torch.index.reader import SplitReader as TSplitReader
from quickwit_tpu_torch.models import doc_mapper as tdm
from quickwit_tpu_torch.observability.metrics import (
    CHUNK_RESTARTS_TOTAL, PREEMPT_PARKED_BYTES, PREEMPT_TOTAL,
)
from quickwit_tpu_torch.query import ast as TQ
from quickwit_tpu_torch.search import chunkexec as tc
from quickwit_tpu_torch.search import executor as t_executor
from quickwit_tpu_torch.search.plan import lower_request as t_lower
from quickwit_tpu_torch.storage.ram import RamStorage as TRamStorage
from quickwit_tpu_torch.tenancy.context import TenantContext, tenant_scope
from quickwit_tpu_torch.tenancy.overload import OVERLOAD

pytestmark = pytest.mark.chaos

NUM_DOCS = 1100  # multi-chunk posting lists at POSTING_PAD spans


def _mapper(dm):
    return dm.DocMapper(
        field_mappings=[
            dm.FieldMapping("ts", dm.FieldType.DATETIME, fast=True,
                            input_formats=("unix_timestamp",)),
            dm.FieldMapping("body", dm.FieldType.TEXT),
        ],
        timestamp_field="ts",
        default_search_fields=("body",),
    )


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan) of Term(body:alpha) over the same bytes."""
    rng = np.random.RandomState(11)
    writer = JSplitWriter(_mapper(jdm))
    for i in range(NUM_DOCS):
        writer.add_json_doc({
            "ts": 1_700_000_000 + i,
            "body": " ".join(["alpha"] * int(rng.randint(1, 3))),
        })
    data = writer.finish()
    js = JRamStorage(JUri.parse("ram:///chaoschunk"))
    js.put("c.split", data)
    ts = TRamStorage(TUri.parse("ram:///chaoschunk"))
    ts.put("c.split", data)
    return (j_lower(JQ.Term("body", "alpha"), _mapper(jdm),
                    JSplitReader(js, "c.split"), []),
            t_lower(TQ.Term("body", "alpha"), _mapper(tdm),
                    TSplitReader(ts, "c.split"), []))


@pytest.fixture(autouse=True)
def fresh_chunking(monkeypatch):
    """Default knobs and an untrained sizer in both packages for each test;
    the overload ladder calmed after it."""
    for mod in (jc, tc):
        monkeypatch.setattr(mod, "CHUNKING", mod.ChunkConfig())
        monkeypatch.setattr(mod, "CHUNK_SIZER", mod._ChunkSizer())
    yield
    OVERLOAD.reset()
    OVERLOAD.configure(enabled=False, target_wait_secs=0.5)


def _injectors(seed, **rule):
    """(JAX injector, port injector) with the same seed and one rule."""
    return (j_faults.FaultInjector(seed=seed,
                                   rules=[j_faults.FaultRule(**rule)]),
            t_faults.FaultInjector(seed=seed,
                                   rules=[t_faults.FaultRule(**rule)]))


def _run(plans, injectors):
    """(JAX chunked, port chunked, port fused) under the two injectors."""
    j_plan, t_plan = plans
    j_inj, t_inj = injectors
    arrays = [torch.from_numpy(np.array(a)) for a in t_plan.arrays]
    fused = t_executor.execute_plan(t_plan, 10, arrays, device="cpu")
    j_result = jc.execute_plan_chunked(j_plan, 10, list(j_plan.arrays),
                                       span=POSTING_PAD,
                                       fault_injector=j_inj)
    t_result = tc.execute_plan_chunked(t_plan, 10, arrays, "cpu",
                                       span=POSTING_PAD,
                                       fault_injector=t_inj)
    return j_result, t_result, fused


def _assert_exact(got, *wants):
    assert got is not None and "partial" not in got
    for want in wants:
        for key in ("sort_values", "doc_ids", "scores"):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), err_msg=key)
        assert int(got["count"]) == int(want["count"])


def test_chunk_yield_fault_restarts_cleanly(plans):
    """One boundary fault: the carried state is dropped, the scan restarts
    from chunk zero, and the result still equals the fused program's."""
    mode, total, align = tc.chunk_mode(plans[1])
    assert mode == "posting"
    assert len(tc.chunk_spans(total, POSTING_PAD, align)) >= 3
    restarts = CHUNK_RESTARTS_TOTAL.get()
    j_result, t_result, fused = _run(plans, _injectors(
        7, operation="kernel.chunk_yield", kind="error", max_fires=1))
    assert CHUNK_RESTARTS_TOTAL.get() == restarts + 1
    _assert_exact(t_result, fused, j_result)


def test_chunk_yield_fault_storm_degrades_to_fused(plans):
    """EVERY boundary faults: after two restarts the scan finishes on the
    fused program — never wedged, still exact."""
    restarts = CHUNK_RESTARTS_TOTAL.get()
    t0 = time.monotonic()
    j_result, t_result, fused = _run(plans, _injectors(
        7, operation="kernel.chunk_yield", kind="error"))
    assert time.monotonic() - t0 < 30.0, "fault storm wedged the scan"
    assert CHUNK_RESTARTS_TOTAL.get() == restarts + 2
    _assert_exact(t_result, fused, j_result)


@pytest.mark.parametrize("seed", [123, 9])
def test_chunk_yield_fault_schedule_is_deterministic(plans, seed):
    """Same seed -> same fired schedule, independent of prior runs, and
    the JAX injector's schedule."""
    def run():
        injectors = _injectors(seed, operation="kernel.chunk_yield",
                               kind="error", every=3, max_fires=2)
        _run(plans, injectors)
        return [inj.schedule() for inj in injectors]

    first = run()
    assert first == run()
    assert first[0] == first[1] and first[1]


def _trip_overload():
    OVERLOAD.configure(enabled=True, target_wait_secs=0.01)
    for _ in range(20):
        OVERLOAD.note_wait(1.0)
    assert OVERLOAD.shed_floor() > 0


def _background_scan_under_interactive(t_plan, injector, release_after):
    """A background chunked scan while an interactive query holds the gate
    under a tripped ladder; the gate clears after `release_after` s."""
    arrays = [torch.from_numpy(np.array(a)) for a in t_plan.arrays]
    _trip_overload()
    release = threading.Event()

    def interactive():
        with tc.PREEMPT_GATE.running(2):
            release.wait(5.0)

    thread = threading.Thread(target=interactive, daemon=True)
    thread.start()
    try:
        while not tc.PREEMPT_GATE.should_yield(0):
            time.sleep(0.005)
        threading.Timer(release_after, release.set).start()
        with tenant_scope(TenantContext.for_class("bg", "background")):
            result = tc.execute_plan_chunked(t_plan, 10, arrays, "cpu",
                                             span=POSTING_PAD,
                                             fault_injector=injector)
    finally:
        release.set()
        thread.join(timeout=5.0)
    assert not thread.is_alive()
    return result, t_executor.execute_plan(t_plan, 10, arrays, device="cpu")


def test_preempt_park_eviction_restarts_from_scratch(plans):
    """A fault while the carried state is parked throws the state away;
    the preempted query re-executes from scratch once the gate clears and
    still returns the exact result."""
    injector = t_faults.FaultInjector(seed=3, rules=[
        t_faults.FaultRule("kernel.preempt_park", "error", max_fires=1)])
    restarts = CHUNK_RESTARTS_TOTAL.get()
    preempts = PREEMPT_TOTAL.get()
    result, fused = _background_scan_under_interactive(plans[1], injector,
                                                       0.15)
    assert PREEMPT_TOTAL.get() > preempts
    assert CHUNK_RESTARTS_TOTAL.get() > restarts
    _assert_exact(result, fused)


def test_parked_bytes_gauge_returns_to_zero(plans):
    """However a scan ends — clean, restarted or evicted — no parked bytes
    leak past it."""
    assert tc.PARKED_STATES.parked_bytes() == 0
    injector = t_faults.FaultInjector(seed=5, rules=[
        t_faults.FaultRule("kernel.preempt_park", "error")])
    result, fused = _background_scan_under_interactive(plans[1], injector,
                                                       0.1)
    _assert_exact(result, fused)
    assert tc.PARKED_STATES.parked_bytes() == 0
    assert PREEMPT_PARKED_BYTES.get() == 0.0
