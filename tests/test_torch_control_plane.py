"""The port's control plane against the JAX package's.

`tests/test_control_plane.py`'s 22 scenarios that need no `serve.Node`
(the solver, the scheduler, the arbiter, its permits and the rate
tracker) run in both packages (`control_plane/{solver,scheduler,
arbiter}.py`). On top of those, seeded churns must give equal results in
the two packages, exactly: 200 `IndexingScheduler.schedule` calls while
indexers join and leave and the task set changes (every plan and every
`counts` matrix the solver returns), 300 direct `solve` calls over random
problems and previous matrices, and the arbiter's, the permits' and the
rate tracker's decisions over a seeded rate trace.
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("quickwit_tpu", "quickwit_tpu_torch")


def load(root):
    cp = importlib.import_module(f"{root}.control_plane")
    return SimpleNamespace(
        root=root, cp=cp,
        scheduler=importlib.import_module(f"{root}.control_plane.scheduler"),
        solver=importlib.import_module(f"{root}.control_plane.solver"),
        **{name: getattr(cp, name) for name in cp.__all__})


@pytest.fixture(params=PACKAGES)
def q(request):
    return load(request.param)


def problem(q, num_shards, load_per_shard, capacities, affinities=None):
    return q.SchedulingProblem(
        num_shards=np.array(num_shards, dtype=np.int64),
        load_per_shard=np.array(load_per_shard, dtype=np.int64),
        capacities=np.array(capacities, dtype=np.int64),
        affinities=affinities or {})


def test_exports_match_jax():
    jax_cp, port_cp = (load(root).cp for root in PACKAGES)
    assert port_cp.__all__ == jax_cp.__all__
    assert load("quickwit_tpu_torch").scheduler.MILLICPU_PER_WEIGHT == \
        load("quickwit_tpu").scheduler.MILLICPU_PER_WEIGHT


# --- the solver ------------------------------------------------------------

def test_solver_places_everything(q):
    counts = q.solve(problem(q, [4, 2], [1000, 500], [4000, 4000, 4000]))
    assert counts.sum(axis=0).tolist() == [4, 2]


def test_solver_balances_load(q):
    p = problem(q, [8], [1000], [8000, 8000])
    loads = q.solve(p) @ p.load_per_shard
    assert abs(int(loads[0]) - int(loads[1])) <= 1000


def test_solver_stability_idempotent(q):
    p = problem(q, [5, 3], [700, 300], [4000, 4000])
    first = q.solve(p)
    assert np.array_equal(first, q.solve(p, first))


def test_solver_remove_extraneous_keeps_rest(q):
    p = problem(q, [2], [500], [4000, 4000])
    counts = q.solve(p, np.array([[3], [1]], dtype=np.int64))
    assert counts.sum() == 2
    assert counts[0, 0] >= counts[1, 0]


def test_solver_affinity_pull(q):
    p = problem(q, [2], [500], [4000, 4000, 4000], affinities={0: {2: 10}})
    assert q.solve(p)[2, 0] == 2


def test_solver_capacity_inflation_when_overloaded(q):
    assert q.solve(problem(q, [6], [1000], [2000, 2000])).sum() == 6


def test_solver_no_indexers(q):
    with pytest.raises(q.NotEnoughCapacity):
        q.solve(problem(q, [1], [100], []))


def test_solver_prefers_few_nodes_per_source(q):
    counts = q.solve(problem(q, [2, 2], [100, 100],
                             [4000, 4000, 4000, 4000]))
    for s in range(2):
        assert np.count_nonzero(counts[:, s]) == 1


# --- the scheduler ---------------------------------------------------------

def test_scheduler_shard_stickiness(q):
    scheduler = q.IndexingScheduler()
    tasks = [q.IndexingTask("idx:01", "src", shard_id=f"s{i}")
             for i in range(4)]
    plan1 = scheduler.schedule(tasks, ["n1", "n2"])
    assert plan1.num_tasks == 4
    plan2 = scheduler.schedule(tasks, ["n1", "n2"])
    for t in tasks:
        assert plan2.node_of(t) == plan1.node_of(t)


def test_scheduler_explicit_affinity(q):
    scheduler = q.IndexingScheduler()
    tasks = [q.IndexingTask("idx:01", "ingest", shard_id=f"s{i}")
             for i in range(2)]
    plan = scheduler.schedule(tasks, ["n1", "n2", "n3"],
                              affinities={("idx:01", "ingest", 1):
                                          {"n3": 5}})
    assert all(plan.node_of(t) == "n3" for t in tasks)


def test_scheduler_weight_capacity(q):
    scheduler = q.IndexingScheduler(indexer_millicpu=1000)
    heavy = [q.IndexingTask("big:01", "src", shard_id=f"h{i}", weight=4)
             for i in range(2)]
    light = [q.IndexingTask("small:01", "src", shard_id=f"l{i}")
             for i in range(2)]
    plan = scheduler.schedule(heavy + light, ["n1", "n2"])
    assert plan.num_tasks == 4
    for n in ("n1", "n2"):
        assert sum(t.weight for t in plan.tasks_for(n)) <= 6


# --- the arbiter -----------------------------------------------------------

def test_arbiter_scale_up_on_short_term(q):
    arbiter = q.ScalingArbiter(max_shard_throughput_mib=10.0,
                               scale_up_factor=1.01)
    assert arbiter.should_scale(q.ShardStats(
        num_open_shards=2, avg_short_term_rate_mib=9.0,
        avg_long_term_rate_mib=8.0)) == q.ScaleUp(1)


def test_arbiter_long_term_floor_blocks_spike(q):
    arbiter = q.ScalingArbiter(max_shard_throughput_mib=10.0,
                               scale_up_factor=2.0)
    assert arbiter.should_scale(q.ShardStats(
        num_open_shards=2, avg_short_term_rate_mib=9.0,
        avg_long_term_rate_mib=3.0)) is None


def test_arbiter_scale_down_long_term_only(q):
    arbiter = q.ScalingArbiter(max_shard_throughput_mib=10.0)
    assert isinstance(arbiter.should_scale(q.ShardStats(
        num_open_shards=3, avg_short_term_rate_mib=0.5,
        avg_long_term_rate_mib=1.0)), q.ScaleDown)
    assert arbiter.should_scale(q.ShardStats(
        num_open_shards=3, avg_short_term_rate_mib=0.5,
        avg_long_term_rate_mib=5.0)) is None


def test_arbiter_respects_min_shards(q):
    arbiter = q.ScalingArbiter(max_shard_throughput_mib=10.0)
    assert arbiter.should_scale(q.ShardStats(
        num_open_shards=1, avg_short_term_rate_mib=1.0,
        avg_long_term_rate_mib=1.0), min_shards=3) == q.ScaleUp(2)
    assert arbiter.should_scale(q.ShardStats(
        num_open_shards=3, avg_short_term_rate_mib=0.1,
        avg_long_term_rate_mib=0.1), min_shards=3) is None


def test_arbiter_idle_source_no_action(q):
    arbiter = q.ScalingArbiter()
    assert arbiter.should_scale(q.ShardStats(0, 0.0, 0.0)) is None
    assert arbiter.should_scale(q.ShardStats(2, 0.0, 0.0)) is None


# --- the permits -----------------------------------------------------------

def test_scaling_permits_rate_limit(q):
    now = [0.0]
    permits = q.ScalingPermits(clock=lambda: now[0])
    for _ in range(5):
        assert permits.acquire("src", q.ScaleUp(1))
    assert not permits.acquire("src", q.ScaleUp(1))
    now[0] += 12.0
    assert permits.acquire("src", q.ScaleUp(1))
    assert permits.acquire("src", q.ScaleDown())
    assert not permits.acquire("src", q.ScaleDown())
    now[0] += 60.0
    assert permits.acquire("src", q.ScaleDown())


def test_scaling_permits_partial_grant(q):
    now = [0.0]
    permits = q.ScalingPermits(clock=lambda: now[0])
    assert permits.acquire("src", q.ScaleUp(8)) == 5
    assert permits.acquire("src", q.ScaleUp(8)) == 0
    now[0] += 24.0
    assert permits.acquire("src", q.ScaleUp(8)) == 2


def test_rate_tracker_retain(q):
    tracker = q.ShardRateTracker()
    tracker.observe("a", 100)
    tracker.observe("b", 100)
    tracker.retain(["a"])
    assert tracker.rates("b") == (0.0, 0.0)
    assert "b" not in tracker._state and "a" in tracker._state


def test_scaling_permits_release_on_failure(q):
    now = [0.0]
    permits = q.ScalingPermits(clock=lambda: now[0])
    assert permits.acquire("src", q.ScaleDown())
    permits.release("src", q.ScaleDown())
    assert permits.acquire("src", q.ScaleDown())


def test_find_scale_down_candidate(q):
    assert q.find_scale_down_candidate({}) is None
    leader, shard = q.find_scale_down_candidate(
        {"s1": "nodeA", "s2": "nodeB", "s3": "nodeB"})
    assert leader == "nodeB" and shard == "s2"


# --- the rate tracker ------------------------------------------------------

def test_rate_tracker_ema(q):
    now = [0.0]
    tracker = q.ShardRateTracker(short_tau_secs=1.0, long_tau_secs=100.0,
                                 clock=lambda: now[0])
    tracker.observe("q", 0)
    for _ in range(20):
        now[0] += 1.0
        tracker.observe("q", int(now[0]) * (1 << 20))
    short, long_ = tracker.rates("q")
    assert 0.9 < short < 1.1
    assert 0.0 < long_ < short + 0.01
    stats = tracker.source_stats(["q", "missing"])
    assert stats.num_open_shards == 2
    assert stats.avg_short_term_rate_mib == pytest.approx(short / 2)


# --- seeded churns: the same results in both packages ----------------------

def plan_keys(plan):
    return {node: [t.key + (t.weight,) for t in tasks]
            for node, tasks in plan.assignments.items()}


def schedule_churn(q, seed, calls=200, monkeypatch=None):
    """`calls` schedules over a changing cluster: indexers join and leave,
    sources gain and lose shards, weights and affinities change. Returns
    every plan, every counts matrix the solver returned and every drift
    verdict."""
    rng = random.Random(seed)
    matrices = []
    real_solve = q.scheduler.solve

    def recording_solve(problem, previous=None, **kw):
        counts = real_solve(problem, previous, **kw)
        matrices.append(counts.tolist())
        return counts

    monkeypatch.setattr(q.scheduler, "solve", recording_solve)
    scheduler = q.IndexingScheduler(
        indexer_millicpu=rng.choice([1000, 2000, 4000]))
    pool = [f"indexer-{i}" for i in range(8)]
    live = set(pool[:3])
    shards = {("logs:01", "kafka"): 4, ("otel:01", "ingest"): 2,
              ("hdfs:01", "sqs"): 1}
    weights = {key: 1 for key in shards}
    plans = []
    for call in range(calls):
        event = rng.random()
        if event < 0.2 and len(live) < len(pool):
            live.add(rng.choice(sorted(set(pool) - live)))
        elif event < 0.35 and len(live) > 1:
            live.discard(rng.choice(sorted(live)))
        elif event < 0.6:
            key = rng.choice(sorted(shards))
            shards[key] = max(0, shards[key] + rng.choice([-2, -1, 1, 3]))
        elif event < 0.7:
            key = (f"idx{call}:01", rng.choice(["kafka", "kinesis"]))
            shards[key] = rng.randint(1, 5)
            weights[key] = 1
        elif event < 0.8:
            key = rng.choice(sorted(shards))
            weights[key] = rng.choice([1, 2, 4, 8])
        tasks = [q.IndexingTask(uid, src, shard_id=f"s{i}",
                                weight=weights[(uid, src)])
                 for (uid, src), n in sorted(shards.items())
                 for i in range(n)]
        affinities = None
        if rng.random() < 0.2 and shards:
            uid, src = rng.choice(sorted(shards))
            affinities = {(uid, src, weights[(uid, src)]):
                          {rng.choice(pool): rng.randint(1, 10)}}
        if rng.random() < 0.05:
            nodes = []
        else:
            nodes = sorted(live)
        plan = scheduler.schedule(tasks, nodes, affinities=affinities)
        assert plan.num_tasks == (len(tasks) if nodes else 0)
        running = dict(plan.assignments)
        if running and rng.random() < 0.3:
            node = rng.choice(sorted(running))
            running[node] = running[node][1:]
        plans.append((sorted(nodes), plan_keys(plan),
                      scheduler.plan_drift(running)))
    return plans, matrices


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_churn_matches_jax(seed, monkeypatch):
    want, got = (schedule_churn(load(root), seed, monkeypatch=monkeypatch)
                 for root in PACKAGES)
    assert len(got[0]) == 200 and len(got[1]) > 150
    assert got[1] == want[1]    # every counts matrix
    assert got[0] == want[0]    # every plan and drift verdict


def solve_churn(q, seed, calls=300):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(calls):
        num_sources = rng.randint(1, 6)
        num_nodes = rng.randint(0, 6)
        affinities = {}
        for s in range(num_sources):
            if num_nodes and rng.rand() < 0.3:
                affinities[s] = {int(rng.randint(num_nodes)):
                                 int(rng.randint(1, 10))}
        p = problem(q, rng.randint(0, 8, num_sources),
                    rng.choice([50, 250, 1000, 3000], num_sources),
                    rng.choice([1000, 2000, 4000], num_nodes), affinities)
        previous = (rng.randint(0, 4, (num_nodes, num_sources))
                    if rng.rand() < 0.6 else None)
        headroom = float(rng.choice([1.0, 1.2, 1.5]))
        try:
            counts = q.solve(p, previous, headroom=headroom)
            out.append(("ok", counts.dtype.str, counts.tolist()))
        except q.NotEnoughCapacity as exc:
            out.append(("not_enough_capacity", str(exc)))
    return out


def test_solve_churn_matches_jax():
    want, got = (solve_churn(load(root), seed=5) for root in PACKAGES)
    assert got == want
    assert {o[0] for o in got} == {"ok", "not_enough_capacity"}


def autoscale_trace(q, seed, steps=400):
    """A seeded per-shard byte trace through the rate tracker, the arbiter
    and the permits on one virtual clock, as the node's autoscaler wires
    them: every observation's rates and every decision and grant."""
    rng = random.Random(seed)
    now = [0.0]
    tracker = q.ShardRateTracker(short_tau_secs=5.0, long_tau_secs=60.0,
                                 clock=lambda: now[0])
    arbiter = q.ScalingArbiter(max_shard_throughput_mib=2.0,
                               scale_up_factor=1.5)
    permits = q.ScalingPermits(clock=lambda: now[0])
    shards = {"src-a": ["a-0"], "src-b": ["b-0", "b-1"]}
    totals = {}
    out = []
    for step in range(steps):
        dt = rng.choice([0.5, 1.0, 2.0, 15.0])
        now[0] += dt
        phase = (step // 100) % 4
        for source, ids in shards.items():
            for shard in ids:
                mib = {0: 0.2, 1: 3.5, 2: 1.0, 3: 0.01}[phase]
                totals[shard] = totals.get(shard, 0) + int(
                    rng.uniform(0.5, 1.5) * mib * dt * (1 << 20))
                tracker.observe(shard, totals[shard])
            stats = tracker.source_stats(ids)
            decision = arbiter.should_scale(stats, min_shards=1)
            granted = (permits.acquire(source, decision)
                       if decision is not None else None)
            if decision is not None and granted and rng.random() < 0.1:
                permits.release(source, decision, granted=granted)
                granted = "released"
            elif isinstance(decision, q.ScaleUp) and granted:
                ids.extend(f"{source}-{len(ids) + i}"
                           for i in range(int(granted)))
            elif isinstance(decision, q.ScaleDown) and granted:
                leader, victim = q.find_scale_down_candidate(
                    {s: f"node-{i % 2}" for i, s in enumerate(ids)})
                ids.remove(victim)
                tracker.forget(victim)
                out.append(("closed", leader, victim))
            out.append((step, source, stats.num_open_shards,
                        stats.avg_short_term_rate_mib,
                        stats.avg_long_term_rate_mib, repr(decision),
                        granted))
        tracker.retain([s for ids in shards.values() for s in ids])
    return out


def test_autoscale_trace_matches_jax():
    want, got = (autoscale_trace(load(root), seed=9) for root in PACKAGES)
    assert got == want
    decisions = {row[5].split("(")[0] for row in got if len(row) == 7}
    assert {"ScaleUp", "ScaleDown", "None"} <= decisions
