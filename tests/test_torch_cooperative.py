"""The port's cooperative indexing cycle against the JAX package's.

`tests/test_cooperative.py`'s six scenarios that need no `serve.Node`
(phase spreading, the ideal period, the sleep nudges, overlong work, the
concurrency semaphore, the initial sleep) run in both packages
(`indexing/cooperative.py`), and a seeded run of many cycles on one
virtual clock must give the same phases, sleeps and pipeline metrics in
both, exactly.
"""

import importlib
import random
import threading
from types import SimpleNamespace

import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def load(root):
    coop = importlib.import_module(f"{root}.indexing.cooperative")
    return SimpleNamespace(root=root, coop=coop,
                           Cycle=coop.CooperativeIndexingCycle,
                           NUDGE=coop.NUDGE_TOLERANCE_SECS)


@pytest.fixture(params=PACKAGES)
def q(request):
    return load(request.param)


class VirtualClock:
    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now


def cycle(q, pipeline_id="p1", commit_timeout=60.0, permits=None,
          clock=None):
    return q.Cycle(pipeline_id, commit_timeout,
                   permits if permits is not None else threading.Semaphore(3),
                   clock=clock or VirtualClock())


def test_target_phase_spreads_uniformly(q):
    phases = [cycle(q, f"pipeline-{i}").target_phase for i in range(100)]
    assert all(0 <= p < 60.0 for p in phases)
    assert {int(p // 15) for p in phases} == {0, 1, 2, 3}
    assert cycle(q, "a").target_phase == cycle(q, "a").target_phase
    assert cycle(q, "a").target_phase != cycle(q, "b").target_phase


def test_ideal_cycle_period_is_commit_timeout(q):
    clock = VirtualClock()
    c = cycle(q, clock=clock)
    clock.now = (c.target_phase - 10.0) % 60.0
    period = c.begin_period()
    clock.now += 10.0
    sleep, metrics = period.end_of_work(50_000_000)
    assert sleep == pytest.approx(50.0, abs=0.01)
    assert 0 < metrics.cpu_load_mcpu <= 4000
    assert metrics.throughput_mb_per_sec > 0


def test_sleep_nudges_toward_target_phase(q):
    clock = VirtualClock()
    c = cycle(q, clock=clock)
    clock.now = c.target_phase + 20.0
    period = c.begin_period()
    clock.now += 1.0
    sleep, _ = period.end_of_work(0)
    assert sleep == pytest.approx(60.0 - 1.0 - q.NUDGE, abs=0.01)
    clock.now = c.target_phase + 60.0 - 20.0
    period = c.begin_period()
    clock.now += 1.0
    sleep, _ = period.end_of_work(0)
    assert sleep == pytest.approx(60.0 - 1.0 + q.NUDGE, abs=0.01)


def test_overlong_work_never_sleeps_negative(q):
    clock = VirtualClock()
    c = cycle(q, clock=clock)
    period = c.begin_period()
    clock.now += 75.0
    sleep, metrics = period.end_of_work(0)
    assert sleep == 0.0
    assert metrics.cpu_load_mcpu == 4000
    with pytest.raises(RuntimeError, match="twice"):
        period.end_of_work(0)


def test_semaphore_bounds_concurrent_periods(q):
    permits = threading.Semaphore(2)
    clock = VirtualClock()
    cycles = [cycle(q, f"p{i}", permits=permits, clock=clock)
              for i in range(3)]
    p1 = cycles[0].begin_period(timeout=0.001)
    p2 = cycles[1].begin_period(timeout=0.001)
    assert p1 is not None and p2 is not None
    assert cycles[2].begin_period(timeout=0.001) is None
    p1.end_of_work(0)
    assert cycles[2].begin_period(timeout=0.001) is not None


def test_initial_sleep_lands_on_phase(q):
    clock = VirtualClock(start=7.0)
    c = cycle(q, clock=clock)
    sleep = c.initial_sleep_duration()
    landed = (clock.now + sleep) % 60.0
    assert (abs(landed - c.target_phase) < 0.01) or sleep == 0.0


def seeded_cycles(q, seed):
    """Six pipelines sharing two permits on one virtual clock, driven the
    way `Node._cooperative_drain` drives them: wake, try a period, work,
    sleep as told. The whole schedule of turns."""
    rng = random.Random(seed)
    clock = VirtualClock(start=rng.uniform(0, 1000))
    permits = threading.Semaphore(2)
    cycles = {f"idx-{i}:01": q.Cycle(f"idx-{i}:01", rng.choice([30, 60]),
                                     permits, clock=clock)
              for i in range(6)}
    wake = {uid: clock.now + c.initial_sleep_duration()
            for uid, c in cycles.items()}
    out = [sorted((uid, c.target_phase) for uid, c in cycles.items())]
    busy = []
    for _ in range(400):
        clock.now += rng.uniform(0.1, 3.0)
        for period, uid, until in list(busy):
            if clock.now >= until:
                busy.remove((period, uid, until))
                sleep, metrics = period.end_of_work(
                    rng.randint(0, 80_000_000))
                wake[uid] = clock.now + sleep
                out.append(("end", uid, sleep, metrics.cpu_load_mcpu,
                            metrics.throughput_mb_per_sec))
        for uid in sorted(cycles):
            if clock.now < wake[uid] or any(b[1] == uid for b in busy):
                continue
            period = cycles[uid].begin_period(timeout=0.0001)
            if period is None:
                out.append(("full", uid))
                continue
            busy.append((period, uid, clock.now + rng.uniform(0.5, 40.0)))
            out.append(("begin", uid, clock.now))
    for period, _uid, _until in busy:
        period.end_of_work(0)
    return out


def test_seeded_cycles_match_jax():
    want, got = (seeded_cycles(load(root), seed=3) for root in PACKAGES)
    assert got == want
    kinds = {entry[0] for entry in got[1:]}
    assert kinds == {"begin", "end", "full"}
