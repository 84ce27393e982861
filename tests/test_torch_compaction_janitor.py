"""The port's compactor and janitor against the JAX package's.

Compaction (`tests/test_compaction.py`'s scenarios that need no node):
the planner's claims, their timeout and release, the supervisor's
synchronous and threaded execution with its report, slots, drain while a
merge is in flight, stale inputs, and one compaction pass composed as
`Node.run_compaction_pass` composes it (planner, then the supervisor's
free slots). The janitor (`tests/test_janitor_planner.py`'s planner, GC
and `run_delete_planner` scenarios): the delete planner's rewrite of a
matching split and fast-forward of a clean one, convergence, a failed
probe counted as a match, the orphan scan, GC past its grace periods,
retention, and one janitor pass composed as `Node.run_janitor` composes it
(GC, retention, then the delete planner). Each runs in both packages under
the harness's clock and RNG; observations, metastore files and split
files must be equal. The port's delete planner runs on `device="cpu"`;
without it, it runs on the card.
"""

import threading

import pytest
import torch

from test_torch_indexing import (  # noqa: F401 - python_paths: a fixture
    PACKAGES, WriteEngine, listed, make_docs, python_paths, run_both)
from test_torch_write_path import run_merges

from quickwit_tpu_torch.ops.kernels.build import KernelError

POLICY = {"type": "stable_log", "merge_factor": 2, "max_merge_factor": 2,
          "min_level_num_docs": 100}


def publish_small_splits(env, count, start=0):
    """`count` one-doc splits (what `node.ingest` of one doc publishes)."""
    e = env.e
    env.pipeline(e.sources.VecSource(make_docs(count, start=start)),
                 target=1, batch=1).run_to_completion()


def supervisor(e, env, **kw):
    return e.compaction.CompactorSupervisor(env.metastore, env.resolver,
                                            **kw)


def compaction_pass(e, env, planner, sup, synchronous=True):
    """`Node.run_compaction_pass` on a node that is the only compactor."""
    slots = sup.available_slots()
    if slots == 0:
        return 0

    def on_done(task, ok):
        (planner.complete_task if ok else planner.fail_task)(task.task_id)

    submitted = 0
    for task in planner.plan(max_tasks=slots):
        if sup.submit(task, on_done=on_done, synchronous=synchronous):
            submitted += 1
        else:
            planner.fail_task(task.task_id)
    return submitted


def task_ids(tasks):
    return [t.split_ids for t in tasks]


# --- compaction ----------------------------------------------------------

def scenario_planner_claims(e, env):
    publish_small_splits(env, 2)
    planner = e.compaction.CompactionPlanner(env.metastore)
    tasks = planner.plan()
    assert len(tasks) == 1 and len(tasks[0].split_ids) == 2
    assert planner.plan() == []  # in flight: nothing new
    assert planner.num_in_flight == 1
    planner.complete_task(tasks[0].task_id)
    again = planner.plan()
    assert len(again) == 1  # nothing merged them: the same merge again
    planner.fail_task(again[0].task_id)
    assert planner.num_in_flight == 0
    return task_ids(tasks), task_ids(again)


def scenario_planner_timeout(e, env):
    now = [0.0]
    publish_small_splits(env, 2)
    planner = e.compaction.CompactionPlanner(
        env.metastore, task_timeout_secs=100, clock=lambda: now[0])
    first = planner.plan()
    assert len(first) == 1 and planner.plan() == []
    now[0] = 101.0  # the stuck worker's claim expires
    again = planner.plan()
    assert len(again) == 1
    return task_ids(first), task_ids(again)


def scenario_supervisor_executes(e, env):
    publish_small_splits(env, 2)
    planner = e.compaction.CompactionPlanner(env.metastore)
    sup = supervisor(e, env, max_concurrent_merges=1)
    [task] = planner.plan()
    done = []
    assert sup.submit(task, on_done=lambda t, ok: done.append(ok),
                      synchronous=True)
    assert done == [True] and sup.num_completed == 1
    [merged] = env.published()
    assert merged.metadata.num_docs == 2
    return sup.status(), listed(env.splits())


def scenario_supervisor_threaded(e, env):
    publish_small_splits(env, 4)
    planner = e.compaction.CompactionPlanner(env.metastore)
    sup = supervisor(e, env, max_concurrent_merges=1)
    tasks = planner.plan()
    assert len(tasks) == 2
    finished = threading.Event()
    results = []

    def on_done(task, ok):
        results.append((task.split_ids, ok))
        finished.set()

    assert sup.submit(tasks[0], on_done=on_done)
    # one slot: a second task waits for the first to finish
    assert finished.wait(timeout=30)
    assert sup.available_slots() == 1
    finished.clear()
    assert sup.submit(tasks[1], on_done=on_done)
    assert finished.wait(timeout=30)
    assert sup.decommission(timeout=30)
    assert [ok for _, ok in results] == [True, True]
    assert sorted(s.metadata.num_docs for s in env.published()) == [2, 2]
    return sorted(results), sup.status(), listed(env.splits())


def scenario_stale_inputs_skipped(e, env):
    publish_small_splits(env, 2)
    planner = e.compaction.CompactionPlanner(env.metastore)
    sup = supervisor(e, env)
    [task] = planner.plan()
    assert run_merges(e, env) == 1  # an indexer merged them first
    assert sup.submit(task, synchronous=True)
    assert (sup.num_failed, sup.num_completed) == (1, 0)
    return sup.status(), listed(env.splits())


def scenario_compaction_pass(e, env):
    publish_small_splits(env, 4)
    planner = e.compaction.CompactionPlanner(env.metastore)
    sup = supervisor(e, env, max_concurrent_merges=2)
    assert compaction_pass(e, env, planner, sup) == 2
    published = env.published()
    assert [s.metadata.num_docs for s in published] == [2, 2]
    assert planner.num_in_flight == 0
    # merge_factor 2: the two merged splits merge in the next pass
    assert compaction_pass(e, env, planner, sup) == 1
    [final] = env.published()
    assert (final.metadata.num_docs, final.metadata.num_merge_ops) == (4, 2)
    return sup.status(), listed(env.splits())


@pytest.mark.parametrize("scenario", [
    scenario_planner_claims, scenario_planner_timeout,
    scenario_supervisor_executes, scenario_supervisor_threaded,
    scenario_stale_inputs_skipped, scenario_compaction_pass],
    ids=["planner_claims", "planner_timeout", "supervisor_executes",
         "supervisor_threaded", "stale_inputs", "compaction_pass"])
def test_compaction_matches_jax(scenario, python_paths):
    run_both(scenario, merge_policy=POLICY)


@pytest.mark.parametrize("root", PACKAGES)
def test_supervisor_slots_and_drain(root):
    e = WriteEngine(root)
    env = e.env()
    sup = supervisor(e, env, max_concurrent_merges=2)
    assert sup.available_slots() == 2
    assert sup.state is e.compaction.CompactorState.RUNNING
    assert sup.decommission(timeout=1.0)
    assert sup.state is e.compaction.CompactorState.DRAINED
    assert sup.available_slots() == 0
    assert not sup.submit(e.compaction.MergeTask("t", "uid", ("a", "b")))


@pytest.mark.parametrize("root", PACKAGES)
def test_drain_waits_for_in_flight_merge(root):
    """Draining reports no slots and rejects work while a merge runs, and
    turns DRAINED when it finishes."""
    e = WriteEngine(root)
    sup = supervisor(e, e.env(), max_concurrent_merges=2)
    release, started = threading.Event(), threading.Event()

    def slow_merge(task):
        started.set()
        assert release.wait(timeout=30)
        return True

    sup._run_merge = slow_merge
    done = threading.Event()
    assert sup.submit(e.compaction.MergeTask("t1", "uid", ("a",)),
                      on_done=lambda t, ok: done.set())
    assert started.wait(timeout=30)
    assert not sup.decommission(timeout=0.05)
    assert sup.state is e.compaction.CompactorState.DRAINING
    assert sup.available_slots() == 0
    assert not sup.submit(e.compaction.MergeTask("t2", "uid", ("b",)))
    release.set()
    assert sup.decommission(timeout=30)
    assert done.wait(timeout=30)
    assert sup.state is e.compaction.CompactorState.DRAINED
    assert sup.status()["num_completed"] == 1


# --- janitor ---------------------------------------------------------------

def delete_planner(e, env):
    return e.delete_planner.DeleteTaskPlanner(
        "logs:01", e.mapper, env.metastore, env.split_storage, **e.cpu)


def two_tenant_splits(e, env):
    """A mixed split (tenants 0/1/2) and a tenant-2-only split."""
    env.pipeline(e.sources.VecSource(make_docs(30)), batch=50) \
        .run_to_completion()
    env.pipeline(e.sources.VecSource(
        [{"ts": 5000 + i, "body": f"late {i}", "tenant": 2}
         for i in range(10)]), batch=50, source_id="src2") \
        .run_to_completion()


def scenario_planner_rewrites_and_fast_forwards(e, env):
    two_tenant_splits(e, env)
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "1"})
    planner = delete_planner(e, env)
    stats = planner.run_pass()
    assert (stats["delete_splits_rewritten"],
            stats["delete_splits_fast_forwarded"]) == (1, 1)
    published = env.published()
    assert all(s.metadata.delete_opstamp == 1 for s in published)
    counts = [env.count(s.metadata.split_id,
                        lambda Q: Q.Term("tenant", "1")) for s in published]
    assert counts == [0, 0]
    assert sum(s.metadata.num_docs for s in published) == 30
    again = planner.run_pass()
    assert again == {"delete_splits_rewritten": 0,
                     "delete_splits_fast_forwarded": 0,
                     "delete_splits_pending": 0}
    return stats, again, listed(env.splits())


def scenario_run_delete_planner(e, env):
    env.pipeline(e.sources.VecSource(make_docs(12)), batch=50) \
        .run_to_completion()
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "0"})
    stats = e.janitor.run_delete_planner(env.metastore, env.resolver,
                                         **e.cpu)
    assert stats["delete_splits_rewritten"] == 1
    assert sum(s.metadata.num_docs for s in env.published()) == 8
    return stats, listed(env.splits())


def scenario_max_rewrites_leaves_pending(e, env):
    env.pipeline(e.sources.VecSource(make_docs(30)), target=10) \
        .run_to_completion()
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "1"})
    stats = delete_planner(e, env).run_pass(max_rewrites=2)
    assert stats == {"delete_splits_rewritten": 2,
                     "delete_splits_fast_forwarded": 0,
                     "delete_splits_pending": 1}
    return stats, listed(env.splits())


def scenario_gc_orphans(e, env):
    env.pipeline(e.sources.VecSource(make_docs(40)), batch=50) \
        .run_to_completion()
    live = [f"{s.metadata.split_id}.split" for s in env.splits()]
    clean = e.gc.run_garbage_collection(env.metastore, env.resolver)
    assert clean["gc_deleted_orphans"] == 0
    env.split_storage.put("deadbeef-orphan.split", b"\x00" * 64)
    env.split_storage.put("notes.txt", b"keep me")
    stats = e.gc.run_garbage_collection(env.metastore, env.resolver)
    assert stats["gc_deleted_orphans"] == 1
    files = set(env.split_storage.list_files())
    assert "deadbeef-orphan.split" not in files and "notes.txt" in files
    assert all(name in files for name in live)
    return clean, stats, sorted(files)


def scenario_gc_grace_periods(e, env):
    """Marked splits past the deletion grace lose their files and entries;
    staged splits past the staged grace are marked, then removed."""
    env.pipeline(e.sources.VecSource(make_docs(60)), target=20) \
        .run_to_completion()
    [a, b, c] = env.published()
    env.metastore.mark_splits_for_deletion("logs:01",
                                           [a.metadata.split_id])
    staged = e.split_md.SplitMetadata(
        split_id=e.split_md.new_split_id(), index_uid="logs:01",
        num_docs=1)
    env.metastore.stage_splits("logs:01", [staged])
    now = e.clock.wall_time()
    early = e.gc.run_garbage_collection(env.metastore, env.resolver,
                                        now=now + 60)
    assert early["gc_deleted_splits"] == 0
    late = e.gc.run_garbage_collection(
        env.metastore, env.resolver,
        now=now + e.gc.DELETION_GRACE_SECS + 1)
    assert late["gc_deleted_splits"] == 1
    stale = e.gc.run_garbage_collection(
        env.metastore, env.resolver,
        now=now + e.gc.STAGED_GRACE_SECS + 1)
    assert stale["gc_deleted_splits"] == 1
    assert sorted(s.metadata.split_id for s in env.splits()) == sorted(
        [b.metadata.split_id, c.metadata.split_id])
    return early, late, stale, sorted(env.split_storage.list_files())


def scenario_retention(e, env):
    env.pipeline(e.sources.VecSource(make_docs(40)), target=20) \
        .run_to_completion()
    env.metastore.update_retention_policy(
        "logs:01", e.index_md.RetentionPolicy(period_seconds=3600))
    # the splits' docs hold timestamps near 1970: everything expires
    stats = e.janitor.apply_retention(env.metastore,
                                      now=e.clock.wall_time())
    assert stats == {"retention_marked_splits": 2}
    none_yet = e.janitor.apply_retention(env.metastore, now=1000 + 1800)
    assert none_yet == {"retention_marked_splits": 0}
    return stats, listed(env.splits())


def scenario_janitor_pass(e, env):
    """`Node.run_janitor`: GC, retention, then the delete planner."""
    two_tenant_splits(e, env)
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "0"})
    env.split_storage.put("orphan.split", b"x")
    stats = {**e.gc.run_garbage_collection(env.metastore, env.resolver),
             **e.janitor.apply_retention(env.metastore),
             **e.janitor.run_delete_planner(env.metastore, env.resolver,
                                            **e.cpu)}
    assert stats["gc_deleted_orphans"] == 1
    assert stats["delete_splits_rewritten"] == 1
    assert stats["delete_splits_fast_forwarded"] == 1
    return stats, listed(env.splits())


@pytest.mark.parametrize("scenario", [
    scenario_planner_rewrites_and_fast_forwards, scenario_run_delete_planner,
    scenario_max_rewrites_leaves_pending, scenario_gc_orphans,
    scenario_gc_grace_periods, scenario_retention, scenario_janitor_pass],
    ids=["rewrite_and_fast_forward", "run_delete_planner", "max_rewrites",
         "gc_orphans", "gc_grace", "retention", "janitor_pass"])
def test_janitor_matches_jax(scenario, python_paths):
    run_both(scenario)


def test_failed_probe_counts_as_a_match(python_paths, monkeypatch):
    """A probe that fails for another reason than the device is read as a
    match: the clean split is rewritten too, in both packages."""
    def scenario(e, env):
        two_tenant_splits(e, env)
        env.metastore.create_delete_task(
            "logs:01", {"type": "term", "field": "tenant", "value": "1"})

        def failing_probe(*args, **kw):
            raise RuntimeError("probe failed")
        monkeypatch.setattr(e.leaf, "leaf_search_single_split",
                            failing_probe)
        stats = delete_planner(e, env).run_pass()
        assert stats["delete_splits_rewritten"] == 2
        return stats, listed(env.splits())

    run_both(scenario)


@pytest.mark.parametrize("fault", [
    lambda: KernelError("score_topk did not launch"),
    lambda: RuntimeError("CUDA error: an illegal memory access"),
    lambda: torch.OutOfMemoryError("CUDA out of memory")],
    ids=["kernel_error", "cuda_error", "out_of_memory"])
def test_device_fault_in_probe_propagates(fault, monkeypatch):
    """A fault of the device in the port's probe is not read as a match:
    the pass raises it, and no split is rewritten or fast-forwarded."""
    e = WriteEngine("quickwit_tpu_torch")
    env = e.env()
    two_tenant_splits(e, env)
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "1"})
    before = listed(env.splits())

    def failing_probe(*args, **kw):
        raise fault()
    monkeypatch.setattr(e.leaf, "leaf_search_single_split", failing_probe)
    with pytest.raises(type(fault())):
        delete_planner(e, env).run_pass()
    assert listed(env.splits()) == before
    assert all(s.metadata.delete_opstamp == 0 for s in env.splits())


def test_delete_planner_probe_runs_on_its_device(monkeypatch):
    """The probe passes the planner's device to the leaf; without one the
    planner runs on the card and raises where there is none."""
    e = WriteEngine("quickwit_tpu_torch")
    env = e.env()
    two_tenant_splits(e, env)
    env.metastore.create_delete_task(
        "logs:01", {"type": "term", "field": "tenant", "value": "1"})
    devices = []
    probe = e.leaf.leaf_search_single_split

    def spy(*args, **kw):
        devices.append(kw.get("device"))
        return probe(*args, **kw)
    monkeypatch.setattr(e.leaf, "leaf_search_single_split", spy)
    stats = e.janitor.run_delete_planner(env.metastore, env.resolver,
                                         device="cpu")
    assert stats["delete_splits_fast_forwarded"] == 1
    assert devices == [torch.device("cpu")] * 2
    if torch.cuda.is_available():
        planner = e.delete_planner.DeleteTaskPlanner(
            "logs:01", e.mapper, env.metastore, env.split_storage)
        assert planner.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            e.delete_planner.DeleteTaskPlanner(
                "logs:01", e.mapper, env.metastore, env.split_storage)
