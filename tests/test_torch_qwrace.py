"""The port's PCT race controller against the JAX package's `tools/qwrace`.

`quickwit_tpu_torch/tools/qwrace/` gates the port's `common/sync.py` seam
as `tools/qwrace` gates the JAX package's. Held here, in one process, with
every search of the port's cluster on the CPU (`device="cpu"`; the card in
`chip_smoke.py`'s phase 19):

- the detector's five primitive programs (a synchronized counter,
  unsynchronized writes, a condition handoff, a nested acquisition, the
  AB-BA deadlock at seed 17) give equal findings, steps and schedule
  digests under both runtimes;
- both planted races (`QW_RACE_BREAK_POOL`, `QW_RACE_BREAK_THRESHOLD`) are
  found on `fanout` at the JAX package's seeds, on the same object and
  field, shrunk to the same ops, and replayed byte-identically twice from
  a JSON round trip without the environment variable;
- the `race` section reads the same in both packages;
- the lock-graph bridge conforms over `quickwit_tpu_torch/`;
- the CLIs' exit codes, and the import boundary of the port's tools.

A scenario's trace under `--pct` equals the JAX harness's in every event
but the `race` event (and `end`, which quotes a finding's sites): the
port's warmup takes `SplitColumns.staging_lock` and pins its owner with a
zero-byte `HbmBudget.admit` before it reads the resident store
(`search/leaf.py` `_pinned_owner`), seam calls the JAX warmup does not
make, so its schedule has more steps.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

# the JAX package builds its chunk scheduler's gate and sizer at the first
# import of `search/chunkexec.py`; imported inside a gated run, they join
# that run's schedule and no later one's. Importing it here, outside any
# run, keeps each JAX schedule a function of its seed alone
import quickwit_tpu.search.chunkexec  # noqa: F401
import quickwit_tpu.common.sync as j_sync
from quickwit_tpu.dst import SCENARIOS as J_SCENARIOS
from quickwit_tpu.dst import run_scenario as j_run_scenario
from quickwit_tpu.dst import sweep as j_sweep
from tools.qwrace.harness import PctRace as JPctRace
from tools.qwrace.runtime import SchedulerAbort as JSchedulerAbort

import quickwit_tpu_torch.common.sync as t_sync
from quickwit_tpu_torch.dst import SCENARIOS, replay, run_scenario, sweep
from quickwit_tpu_torch.dst.__main__ import main as dst_main
from quickwit_tpu_torch.search.pruning import ThresholdBox
from quickwit_tpu_torch.tools.qwrace.bridge import (DECLARED_EDGES,
                                                    compare,
                                                    static_lock_graph)
from quickwit_tpu_torch.tools.qwrace.harness import (BREAK_ENV_VARS,
                                                     PctRace, race_from_dict)
from quickwit_tpu_torch.tools.qwrace.runtime import SchedulerAbort

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
PLANTED_BUDGET = 10  # each plant must fall within this many seeds
PLANTED = {"QW_RACE_BREAK_POOL": ("WorkerPool", "workers", 0),
           "QW_RACE_BREAK_THRESHOLD": ("ThresholdBox", "value", 2)}
RUNTIMES = {"jax": (j_sync, JPctRace, JSchedulerAbort),
            "port": (t_sync, PctRace, SchedulerAbort)}


# --- detector primitives (no DST; a few scheduler runs each) -----------------

def _run_gated(which: str, seed: int, body, depth: int = 3,
               horizon: int = 4096):
    """Run `body(sync)` under a fresh gated scheduler of one package;
    returns the finished per-run state."""
    sync, pct, abort = RUNTIMES[which]
    racer = pct(depth=depth, horizon=horizon, break_flags={}).begin(seed)
    with racer.activate():
        try:
            body(sync)
        except abort:
            pass
        racer.finalize()
    return racer


def _run_both(seed: int, body, **kw):
    """(JAX run, port run) of one program; asserts that the two runtimes
    reach the same findings, steps and schedule digest."""
    j = _run_gated("jax", seed, body, **kw)
    t = _run_gated("port", seed, body, **kw)
    assert t.detector.findings() == j.detector.findings()
    assert t.runtime.steps == j.runtime.steps
    assert t.runtime.schedule_digest() == j.runtime.schedule_digest()
    assert t.detector.witness_edges == j.detector.witness_edges
    return j, t


def test_synchronized_counter_is_clean():
    def body(sync):
        class Box:
            def __init__(self):
                self.n = 0
        box = Box()
        sync.register_shared(box, "Box")
        lock = sync.lock("Box._lock")

        def bump():
            for _ in range(3):
                with lock:
                    sync.note_write(box, "n")
                    box.n += 1
        ts = [sync.thread(target=bump, name=f"b{i}") for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    _, racer = _run_both(5, body)
    assert racer.detector.findings() == []
    assert racer.runtime.steps > 0


def test_unsynchronized_writes_report_a_race():
    def body(sync):
        class Box:
            def __init__(self):
                self.n = 0
        box = Box()
        sync.register_shared(box, "Box")

        def bump():
            sync.note_write(box, "n")
            box.n += 1
        ts = [sync.thread(target=bump, name=f"b{i}") for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    _, racer = _run_both(5, body)
    kinds = {f["kind"] for f in racer.detector.findings()}
    assert "write-write" in kinds
    finding = racer.detector.findings()[0]
    assert finding["object"].startswith("Box#")
    assert finding["field"] == "n"
    # the site is the line that noted the access, never the seam itself
    assert finding["access"]["site"].startswith("tests/test_torch_qwrace.py:")


def test_condition_handoff_orders_accesses():
    # notify→wake is a happens-before edge: the consumer's reads of the
    # produced items must NOT race the producer's writes
    def body(sync):
        class Q:
            def __init__(self):
                self.items = []
        q = Q()
        sync.register_shared(q, "Q")
        cv = sync.condition(name="Q._lock")

        def producer():
            for i in range(3):
                with cv:
                    sync.note_write(q, "items")
                    q.items.append(i)
                    cv.notify()

        def consumer():
            got = 0
            while got < 3:
                with cv:
                    while not q.items:
                        cv.wait(timeout=0.5)
                    sync.note_write(q, "items")
                    q.items.pop(0)
                    got += 1
        ts = [sync.thread(target=producer, name="p"),
              sync.thread(target=consumer, name="c")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    _, racer = _run_both(5, body)
    assert racer.detector.findings() == []


def test_nested_acquisition_records_witness_edge():
    def body(sync):
        a = sync.lock("A._lock")
        b = sync.lock("B._lock")

        def f():
            with a:
                with b:
                    pass
        t = sync.thread(target=f, name="t")
        t.start()
        t.join()
    _, racer = _run_both(7, body)
    assert ("A._lock", "B._lock") in racer.detector.witness_edges


def test_abba_deadlock_found_at_pinned_seed():
    # horizon=32 puts the PCT change points inside the two-lock window:
    # seed 17 is the first AB-BA deadlock in both runtimes
    def body(sync):
        a = sync.lock("A._lock")
        b = sync.lock("B._lock")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        ts = [sync.thread(target=ab, name="ab"),
              sync.thread(target=ba, name="ba")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    for seed in range(17):
        _, racer = _run_both(seed, body, depth=3, horizon=32)
        assert not any(f["kind"] == "deadlock"
                       for f in racer.detector.findings()), seed
    _, racer = _run_both(17, body, depth=3, horizon=32)
    deadlocks = [f for f in racer.detector.findings()
                 if f["kind"] == "deadlock"]
    assert deadlocks, "seed 17 must deadlock (scheduler changed?)"
    assert {b["name"] for b in deadlocks[0]["blocked"]} == \
        {"main", "ab", "ba"}


# --- planted races: the mandatory pipeline self-test -------------------------

def _port_sweep(flag):
    return sweep(SCENARIOS["fanout"], seeds=PLANTED_BUDGET,
                 race=PctRace(break_flags={flag: True}), device=CPU)


def _jax_sweep(flag):
    return j_sweep(J_SCENARIOS["fanout"], seeds=PLANTED_BUDGET,
                   race=JPctRace(break_flags={flag: True}))


@pytest.fixture(scope="module")
def planted_sweeps():
    return {flag: (_jax_sweep(flag), _port_sweep(flag)) for flag in PLANTED}


def _without_sites(details):
    """A finding with each side's site cut to its module below the
    package root: the two packages' lines differ, their modules do not."""
    out = json.loads(json.dumps(details))
    for side in ("access", "previous"):
        path = out[side]["site"].rsplit(":", 1)[0]
        out[side]["site"] = path.split("/", 1)[1]
    return out


@pytest.mark.parametrize("flag", sorted(PLANTED))
def test_planted_race_found_and_shrunk_as_jax(flag, planted_sweeps):
    j_summary, summary = planted_sweeps[flag]
    obj, field, seed = PLANTED[flag]
    entry, j_entry = summary["violations"][0], j_summary["violations"][0]
    assert entry["invariant"] == j_entry["invariant"] == "data_race"
    assert entry["seed"] == j_entry["seed"] == seed
    details = entry["violation"]["details"]
    assert details["object"].startswith(obj)
    assert details["field"] == field
    assert _without_sites(details) == \
        _without_sites(j_entry["violation"]["details"])
    assert details["previous"]["site"].startswith("quickwit_tpu_torch/")
    assert entry["ops_after_shrink"] < entry["ops_before_shrink"]
    for key in ("ops_before_shrink", "ops_after_shrink",
                "fault_rules_after_shrink"):
        assert entry[key] == j_entry[key], key
    artifact = entry["artifact_inline"]
    j_artifact = j_entry["artifact_inline"]
    assert artifact["ops"] == j_artifact["ops"]
    assert artifact["race"] == j_artifact["race"]


@pytest.mark.parametrize("flag", sorted(PLANTED))
def test_race_artifact_replays_byte_identically(flag, planted_sweeps,
                                                monkeypatch):
    _, summary = planted_sweeps[flag]
    for name in BREAK_ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    # the artifact pins the planted-race switch: JSON round trip and a
    # replay must reproduce WITHOUT the ambient environment variable
    artifact = json.loads(json.dumps(
        summary["violations"][0]["artifact_inline"]))
    assert artifact["race"]["pct"]["break_flags"] == {flag: True}
    first, match_first = replay(artifact, device=CPU)
    second, match_second = replay(artifact, device=CPU)
    assert match_first and match_second
    assert first.digest == second.digest == artifact["trace_digest"]
    assert first.trace.events == second.trace.events
    assert any(v.invariant == "data_race" for v in first.violations)
    assert flag not in os.environ


def test_threshold_switch_writes_without_the_lock(monkeypatch):
    class Refuses:
        def __enter__(self):
            raise AssertionError("ThresholdBox.update took its lock")

        def __exit__(self, *exc):
            return False

    monkeypatch.setenv("QW_RACE_BREAK_THRESHOLD", "1")
    box = ThresholdBox(1.0)
    box._lock = Refuses()
    box.update(2.0)
    box.update(0.5)
    monkeypatch.delenv("QW_RACE_BREAK_THRESHOLD")
    plain = ThresholdBox(1.0)
    plain._lock = Refuses()
    with pytest.raises(AssertionError, match="took its lock"):
        plain.update(2.0)
    assert box._value == 2.0


def test_race_section_round_trips():
    kw = dict(depth=5, horizon=64, max_steps=1000,
              break_flags={"QW_RACE_BREAK_THRESHOLD": True})
    race = PctRace(**kw)
    clone = race_from_dict(race.to_dict())
    assert clone.to_dict() == race.to_dict() == JPctRace(**kw).to_dict()
    assert race_from_dict(None) is None
    assert PctRace(break_flags={}).to_dict() == \
        JPctRace(break_flags={}).to_dict()
    assert BREAK_ENV_VARS == ("QW_RACE_BREAK_THRESHOLD", "QW_RACE_BREAK_POOL")


# --- scenario traces under --pct ---------------------------------------------

@pytest.mark.parametrize("name,seed", [("fanout", 0), ("fanout", 1),
                                       ("mixed", 0)])
def test_pct_trace_equals_jax_but_the_schedule(name, seed):
    got = run_scenario(SCENARIOS[name], seed, break_publish=False,
                       break_wal=False, race=PctRace(), device=CPU)
    want = j_run_scenario(J_SCENARIOS[name], seed, break_publish=False,
                          break_wal=False, race=JPctRace())
    assert got.ok and want.ok
    assert len(got.trace.events) == len(want.trace.events)
    for mine, theirs in zip(got.trace.events, want.trace.events):
        if mine["kind"] == "race":
            assert mine["findings"] == theirs["findings"] == 0
            # the port's warmup seam calls: more steps, another digest
            assert mine["steps"] > theirs["steps"]
        else:
            assert mine == theirs
    again = run_scenario(SCENARIOS[name], seed, break_publish=False,
                         break_wal=False, race=PctRace(), device=CPU)
    assert again.trace.events == got.trace.events


def test_pct_schedule_does_not_depend_on_the_process():
    code = (
        "from quickwit_tpu_torch.dst import SCENARIOS, run_scenario\n"
        "from quickwit_tpu_torch.tools.qwrace.harness import PctRace\n"
        "r = run_scenario(SCENARIOS['fanout'], 0, break_publish=False,\n"
        "                 break_wal=False, race=PctRace(), device='cpu')\n"
        "print('DIGEST', r.digest)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    here = run_scenario(SCENARIOS["fanout"], 0, break_publish=False,
                        break_wal=False, race=PctRace(), device=CPU)
    assert f"DIGEST {here.digest}" in proc.stdout


# --- static↔dynamic lock-graph bridge ----------------------------------------

@pytest.fixture(scope="module")
def gate_result():
    from quickwit_tpu_torch.tools.qwrace.__main__ import run_gate
    return run_gate(seeds=2, device=CPU)


def test_clean_repo_bridge_conforms(gate_result):
    rc, doc = gate_result
    assert rc == 0
    assert doc["race_violations"] == []
    bridge = doc["bridge"]
    assert bridge["conforms"] and bridge["gaps"] == []
    # the offload + cache-tier + staging path witnesses every declared
    # cross-procedural edge; fewer means the sweep lost coverage
    witnessed_declared = {(e["held"], e["acquired"])
                          for e in bridge["declared_used"]}
    assert witnessed_declared == set(DECLARED_EDGES)
    assert ("SplitColumns.staging_lock", "ResidentColumnStore._lock") \
        in witnessed_declared


def test_gate_doc_has_the_jax_gate_shape(gate_result):
    from tools.qwrace.__main__ import run_gate as j_run_gate
    j_rc, j_doc = j_run_gate(seeds=1)
    rc, doc = gate_result
    assert rc == j_rc == 0
    assert set(doc) == set(j_doc)
    assert set(doc["bridge"]) == set(j_doc["bridge"])


def test_static_graph_is_the_ports_tree():
    static = static_lock_graph()
    sites = [site["path"] for edge_sites in static.values()
             for site in edge_sites]
    assert sites and all(p.startswith("quickwit_tpu_torch/") for p in sites)


def test_injected_runtime_edge_is_a_scope_gap():
    report = compare(
        {("Fake._lock", "Other._mutex"): "quickwit_tpu_torch/fake.py:1"},
        static_edges={}, declared={})
    assert not report["conforms"]
    assert report["gaps"] == [{"held": "Fake._lock",
                               "acquired": "Other._mutex",
                               "site": "quickwit_tpu_torch/fake.py:1"}]


def test_anonymous_edges_are_info_not_gaps():
    report = compare(
        {("offload_cv", "WorkerPool._lock"): "quickwit_tpu_torch/x.py:2"},
        static_edges={}, declared={})
    assert report["conforms"]
    assert len(report["anonymous"]) == 1


def test_unwitnessed_static_edges_are_coverage_info():
    report = compare(
        {}, static_edges={("A._lock", "B._lock"): [{"site": "s"}]},
        declared={})
    assert report["conforms"]
    assert report["unwitnessed"] == [
        {"held": "A._lock", "acquired": "B._lock", "sites": 1}]


# --- CLI ---------------------------------------------------------------------

def test_cli_selftest_and_exit_codes(tmp_path, capsys, monkeypatch):
    from quickwit_tpu_torch.tools.qwrace.__main__ import main
    # clean check: exit 0
    assert main(["check", "--seeds", "1", "--device", CPU]) == 0
    capsys.readouterr()
    # a planted race makes sweep exit 1 and lands in the SARIF log
    sarif = tmp_path / "qwrace.sarif"
    race_art = tmp_path / "arts"
    monkeypatch.setenv("QW_RACE_BREAK_POOL", "1")
    assert main(["sweep", "--scenario", "fanout", "--seeds", "1",
                 "--artifacts-dir", str(race_art), "--sarif", str(sarif),
                 "--device", CPU]) == 1
    monkeypatch.delenv("QW_RACE_BREAK_POOL")
    capsys.readouterr()
    log = json.loads(sarif.read_text())
    assert any(r["ruleId"] == "QWRACE001"
               for r in log["runs"][0]["results"])
    # the persisted artifact replays through both CLIs: exit 0
    [artifact_path] = race_art.iterdir()
    assert main(["replay", str(artifact_path), "--json",
                 "--device", CPU]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["digest_match"] and out["violation_reproduced"]
    assert out["race"]["pct"]["break_flags"] == \
        {"QW_RACE_BREAK_POOL": True}
    assert dst_main(["replay", str(artifact_path), "--device", CPU]) == 0
    assert "REPLAYED byte-identically" in capsys.readouterr().out


def test_dst_cli_grows_pct_flag(capsys, monkeypatch):
    monkeypatch.setenv("QW_DEVICE", CPU)     # the flag's default
    assert dst_main(["sweep", "--scenario", "fanout", "--seeds", "1",
                     "--pct", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["race"] == {"pct": {"depth": 3, "horizon": 4096,
                                   "max_steps": 500_000,
                                   "seed_salt": "qwrace",
                                   "break_flags": {}}}
    assert out["race"] == JPctRace(break_flags={}).to_dict()


# --- the import boundary -----------------------------------------------------

def _absolute_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted((REPO / "quickwit_tpu_torch" / "tools").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_tools_import_neither_jax_nor_the_jax_tools(path):
    for name in _absolute_imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "quickwit_tpu", "torch"), name
        assert not name.startswith("tools.qwrace"), name
