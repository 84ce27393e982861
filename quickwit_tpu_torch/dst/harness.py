"""The deterministic scheduler: one run = one seeded, replayable execution.

`run_scenario` owns the whole run: it installs a `FakeClock` and a seeded
`random.Random` process-wide (every component routed through
`quickwit_tpu_torch.common.clock`), builds the
`FaultInjector` + `SimNetwork` + `SimCluster`, then executes the
materialized op list **synchronously, one op at a time** — the op order IS
the interleaving, FoundationDB-style, so a run is pinned by
(scenario, seed, op list, fault plan) and nothing else. Virtual time
advances only when the scheduler (or a latency fault) says so; scenario
hours cost milliseconds of wall clock.

`sweep` explores seeds; on a violation it `shrink`s the op list and fault
plan (greedy single-pass delta-debugging, keeping a candidate only if the
SAME invariant still fires) and persists a self-contained replay artifact.
`replay` re-executes an artifact from its own contents alone and reports
whether the trace digest matches byte-for-byte.

Every entry point runs the cluster's searches on `device` (default
`cuda`); `mesh_devices` gives each node a device grid. Neither enters the
trace, so a run on the card and a run on the CPU of the same (scenario,
seed, op list, fault plan) give the same digest.

`race` is duck-typed: a controller with `begin(seed)`, `to_dict()` and a
per-run object (`activate`, `before_op`, `detector`, `abort_exc`,
`finalize`, `violations`, `trace_event`): this package's
`tools.qwrace.PctRace`, which gates `common/sync.py`. A replay artifact
that names a race rebuilds its controller through `race_from_dict`.
"""

from __future__ import annotations

import dataclasses
import os
import random
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Optional

from ..common.clock import FakeClock, use_clock, use_rng
from ..common.faults import FaultInjector
from ..observability.flight import FLIGHT
from .artifact import make_artifact, save_artifact
from .cluster import SimCluster
from .invariants import InvariantChecker, Violation
from .network import SimNetwork
from .scenario import SCENARIOS, Scenario
from .trace import Trace

# virtual start of every run: far enough from zero that monotonic deltas
# and wall timestamps are both well-behaved, and identical across runs
_VIRTUAL_START = 1000.0
_VIRTUAL_EPOCH = 1_700_000_000.0


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


@dataclass
class RunResult:
    scenario: Scenario
    seed: int
    ops: list[dict[str, Any]]
    violations: list[Violation]
    trace: Trace
    # the op thread's flight-recorder timeline (FLIGHT.dst_tail()): virtual
    # timestamps, no thread/span ids — byte-identical across replays of the
    # same (scenario, seed, ops, fault plan)
    flight_tail: list = dataclasses.field(default_factory=list)

    @property
    def digest(self) -> str:
        return self.trace.digest()

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def first_violation(self) -> Optional[Violation]:
        return self.violations[0] if self.violations else None


def run_scenario(scenario: Scenario, seed: int,
                 ops: Optional[list[dict[str, Any]]] = None,
                 fault_plan: Optional[dict[str, Any]] = None,
                 break_publish: Optional[bool] = None,
                 break_wal: Optional[bool] = None,
                 race: Optional[Any] = None,
                 device=None, mesh_devices=None) -> RunResult:
    """Execute one deterministic run. `ops` / `fault_plan` default to the
    scenario's materialization and fault rules for `seed`; replay and
    shrinking pass explicit (possibly reduced) values. The break flags
    default to the `QW_DST_BREAK_{PUBLISH,WAL}` env switches; replay pins
    them from the artifact so a run reproduces from the file alone.

    `device` is where every search of the cluster runs (default `cuda`),
    `mesh_devices` each node's device grid (default none: no mesh).

    `race` is a `tools.qwrace.PctRace` controller (or None): when set,
    the run executes under the gated PCT scheduler — every thread and lock the
    cluster builds goes through the `common.sync` seam, interleavings are
    explored at sync-op granularity inside each (still serial) DST op, and
    happens-before race findings become ordinary `Violation`s so shrink /
    artifact / replay apply unchanged."""
    if ops is None:
        ops = scenario.materialize(seed)
    if break_publish is None:
        break_publish = _env_flag("QW_DST_BREAK_PUBLISH")
    if break_wal is None:
        break_wal = _env_flag("QW_DST_BREAK_WAL")
    if fault_plan is not None:
        injector = FaultInjector.from_plan(fault_plan)
    else:
        injector = FaultInjector(seed, list(scenario.fault_rules))

    expected_index_of_n = {
        int(doc["n"]): op["index"]
        for op in ops if op["kind"] == "ingest" for doc in op["docs"]
    }
    checker = InvariantChecker(scenario.invariants, expected_index_of_n)
    trace = Trace()
    clock = FakeClock(start=_VIRTUAL_START, epoch=_VIRTUAL_EPOCH)
    rng = random.Random(seed)

    racer = race.begin(seed) if race is not None else None
    # () never matches in an except clause: abort_exc is only "live" when
    # a race controller is installed
    abort_exc = racer.abort_exc if racer is not None else ()

    # activate BEFORE the cluster is built: a lock constructed outside the
    # runtime would be invisible to happens-before and yield false races
    with use_clock(clock), use_rng(rng), \
            (racer.activate() if racer is not None else nullcontext()):
        # rebase the flight recorder on the just-installed FakeClock: the
        # run's timeline starts at t=0 virtual and depends on nothing but
        # the run inputs
        FLIGHT.begin_run()
        network = SimNetwork(injector, seed, duplicate_probability=0.05)
        cluster = SimCluster(scenario, injector, network, clock,
                             break_publish=break_publish,
                             break_wal=break_wal, device=device,
                             mesh_devices=mesh_devices)
        try:
            start_extra = {"race": race.to_dict()} if race is not None else {}
            trace.record("start", scenario=scenario.name, seed=seed,
                         num_ops=len(ops), break_publish=break_publish,
                         break_wal=break_wal, **start_extra)
            aborted = False
            try:
                for step, op in enumerate(ops):
                    if racer is not None:
                        racer.before_op(step)
                    clock.advance(scenario.step_secs)
                    # every op marks the op thread's ring, so even an
                    # ingest/drain-only shrunk repro carries a timeline
                    FLIGHT.emit("dst.op",
                                attrs={"step": step, "kind": op["kind"]})
                    result = _execute(cluster, op)
                    trace.record("op", step=step,
                                 now=round(clock.monotonic(), 6),
                                 op=op if op["kind"] != "ingest" else {
                                     "kind": "ingest", "node": op["node"],
                                     "index": op["index"],
                                     "num_docs": len(op["docs"])},
                                 result=result)
                    checker.after_op(cluster, op, result, step)
                    if checker.violations:
                        break
                    if racer is not None and racer.detector.findings():
                        break   # stop at the first race, like any violation
            except abort_exc:
                # scheduler deadlock / budget abort: the finding is already
                # in the detector; the run ends here
                aborted = True
            if racer is not None:
                racer.finalize()
                checker.violations.extend(racer.violations())
                trace.record("race", **racer.trace_event())
            if not checker.violations and not aborted:
                summary = cluster.quiesce()
                trace.record("quiesce", now=round(clock.monotonic(), 6),
                             summary=summary)
                checker.at_quiescence(cluster, step=len(ops))
            trace.record("fault_schedule", schedule=injector.schedule())
            trace.record("end",
                         violations=[v.to_dict() for v in checker.violations])
        finally:
            if racer is not None:
                racer.finalize()
            cluster.close()
    return RunResult(scenario=scenario, seed=seed, ops=ops,
                     violations=checker.violations, trace=trace,
                     flight_tail=FLIGHT.dst_tail())


def _execute(cluster: SimCluster, op: dict[str, Any]) -> Any:
    kind = op["kind"]
    if kind == "ingest":
        return cluster.ingest(op["node"], op["index"], op["docs"])
    if kind == "drain":
        return cluster.drain(op["node"])
    if kind == "search":
        return cluster.search(op["index"], op["max_hits"],
                              sort=op.get("sort"))
    if kind == "merge":
        return cluster.merge(op["node"], op["index"])
    if kind == "kill":
        return cluster.kill(op["node"])
    if kind == "restart":
        return cluster.restart(op["node"])
    if kind == "autoscale":
        return cluster.autoscale(op["queue_depth"])
    if kind == "plan":
        return cluster.plan()
    if kind == "cancel":
        return cluster.cancel_search(op["index"], op["max_hits"])
    if kind == "dashboard":
        return cluster.dashboard(op["index"], op["max_hits"], op["panels"],
                                 cancel_panel=op.get("cancel_panel", False))
    raise ValueError(f"unknown op kind: {kind!r}")


# --- shrinking ---------------------------------------------------------------

def shrink(scenario: Scenario, seed: int, ops: list[dict[str, Any]],
           violation: Violation,
           break_publish: bool = False,
           break_wal: bool = False,
           race: Optional[Any] = None,
           device=None,
           mesh_devices=None) -> tuple[Scenario, list[dict[str, Any]]]:
    """Greedy seed-local shrink: one backward elimination pass over the op
    list, then one over the fault rules — a candidate survives only if the
    SAME-NAMED invariant still fires. Single-pass keeps the cost linear in
    the op count (each probe is a full deterministic run). Race findings
    shrink exactly like any other violation: each probe re-runs under the
    same PCT controller (same seed → same schedule for the surviving op
    prefix)."""
    name = violation.invariant

    def still_fails(sc: Scenario, candidate_ops: list[dict[str, Any]]) -> bool:
        result = run_scenario(sc, seed, ops=candidate_ops,
                              break_publish=break_publish,
                              break_wal=break_wal, race=race,
                              device=device, mesh_devices=mesh_devices)
        return any(v.invariant == name for v in result.violations)

    current = list(ops)
    for i in reversed(range(len(current))):
        candidate = current[:i] + current[i + 1:]
        if still_fails(scenario, candidate):
            current = candidate

    rules = list(scenario.fault_rules)
    for i in reversed(range(len(rules))):
        candidate_rules = rules[:i] + rules[i + 1:]
        candidate_sc = dataclasses.replace(scenario,
                                           fault_rules=tuple(candidate_rules))
        if still_fails(candidate_sc, current):
            rules = candidate_rules
            scenario = candidate_sc
    return scenario, current


# --- sweep -------------------------------------------------------------------

def sweep(scenario: Scenario, seeds: int, start_seed: int = 0,
          artifacts_dir: Optional[str] = None,
          break_publish: Optional[bool] = None,
          break_wal: Optional[bool] = None,
          shrink_violations: bool = True,
          stop_on_first: bool = True,
          conformance: bool = False,
          race: Optional[Any] = None,
          device=None, mesh_devices=None) -> dict[str, Any]:
    """Run `seeds` consecutive seeds; shrink + persist an artifact for each
    violating seed. Returns a JSON-safe summary (the CLI prints it).

    With `conformance=True` every run's trace is additionally replayed
    against the qwmc checkpoint model's abstract transition relation
    (`tools.qwmc.conformance.check_trace`) — a second, independent oracle:
    the runtime invariants compare against the acked ledger, the
    conformance check against what the exhaustively-verified model permits,
    so a planted bug must fall to both."""
    if break_publish is None:
        break_publish = _env_flag("QW_DST_BREAK_PUBLISH")
    if break_wal is None:
        break_wal = _env_flag("QW_DST_BREAK_WAL")
    check_trace = None
    if conformance:
        # lazy: tools/ sits beside the package at the repo root; the DST
        # layer must stay importable without it (wheel installs). The
        # checker is stdlib only: tools/qwmc/{__init__,kernel,conformance}
        from tools.qwmc.conformance import check_trace
    summary: dict[str, Any] = {
        "scenario": scenario.name, "seeds": seeds, "start_seed": start_seed,
        "passed": [], "violations": [],
    }
    if conformance:
        summary["nonconforming"] = []
    if race is not None:
        summary["race"] = race.to_dict()
    for seed in range(start_seed, start_seed + seeds):
        result = run_scenario(scenario, seed,
                              break_publish=break_publish,
                              break_wal=break_wal, race=race,
                              device=device, mesh_devices=mesh_devices)
        if check_trace is not None:
            report = check_trace(result.trace.events)
            if not report["conforms"]:
                summary["nonconforming"].append(
                    {"seed": seed, "report": report})
        if result.ok:
            summary["passed"].append(seed)
            continue
        violation = result.first_violation
        entry: dict[str, Any] = {"seed": seed,
                                 "invariant": violation.invariant,
                                 "violation": violation.to_dict()}
        shrunk_scenario, shrunk_ops = scenario, result.ops
        if shrink_violations:
            shrunk_scenario, shrunk_ops = shrink(
                scenario, seed, result.ops, violation,
                break_publish=break_publish, break_wal=break_wal, race=race,
                device=device, mesh_devices=mesh_devices)
            entry["ops_before_shrink"] = len(result.ops)
            entry["ops_after_shrink"] = len(shrunk_ops)
            entry["fault_rules_after_shrink"] = len(
                shrunk_scenario.fault_rules)
        # re-run the shrunk repro to capture its trace for the artifact
        repro = run_scenario(shrunk_scenario, seed, ops=shrunk_ops,
                             break_publish=break_publish,
                             break_wal=break_wal, race=race,
                             device=device, mesh_devices=mesh_devices)
        repro_violation = (repro.first_violation
                           if repro.first_violation else violation)
        artifact = make_artifact(
            shrunk_scenario, seed, shrunk_ops, repro_violation, repro.trace,
            break_publish=break_publish, break_wal=break_wal, race=race,
            flight_tail=repro.flight_tail)
        if artifacts_dir:
            os.makedirs(artifacts_dir, exist_ok=True)
            path = os.path.join(
                artifacts_dir,
                f"dst-{scenario.name}-seed{seed}-"
                f"{violation.invariant}.json")
            save_artifact(artifact, path)
            entry["artifact"] = path
        else:
            entry["artifact_inline"] = artifact
        summary["violations"].append(entry)
        if stop_on_first:
            break
    summary["ok"] = not summary["violations"] \
        and not summary.get("nonconforming")
    return summary


# --- replay ------------------------------------------------------------------

def replay(artifact: dict[str, Any], device=None,
           mesh_devices=None) -> tuple[RunResult, bool]:
    """Re-execute a replay artifact from its contents alone (on `device`,
    default `cuda`). Returns the fresh `RunResult` and whether its trace
    digest matches the recorded one byte-for-byte. An artifact recorded
    under a race controller re-runs under the controller its `race`
    section describes."""
    scenario = Scenario.from_dict(artifact["scenario"])
    flags = artifact.get("break_flags", {})
    race = None
    if artifact.get("race"):
        # lazy: the controller is only loaded for a race artifact
        from ..tools.qwrace.harness import race_from_dict
        race = race_from_dict(artifact["race"])
    result = run_scenario(
        scenario, int(artifact["seed"]), ops=list(artifact["ops"]),
        fault_plan=artifact.get("fault_plan"),
        break_publish=bool(flags.get("publish", False)),
        break_wal=bool(flags.get("wal", False)),
        race=race, device=device, mesh_devices=mesh_devices)
    ok = result.digest == artifact["trace_digest"]
    # artifacts that embed a flight-recorder tail must re-derive it
    # byte-identically too — the runtime timeline is part of the repro
    if "flight_tail" in artifact:
        ok = ok and result.flight_tail == artifact["flight_tail"]
    return result, ok


def scenario_by_name(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None
