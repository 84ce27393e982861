"""CLI: ``python -m quickwit_tpu_torch.tools.qwrace {sweep,replay,bridge,
selftest,check}``: the JAX package's ``tools/qwrace`` CLI, with its flags
and exit codes, over this package's ``dst``.

- ``sweep --scenario fanout --seeds 10`` explores PCT schedules over a
  DST scenario with happens-before race detection; exit 1 on any race
  finding or lock-graph scope gap. ``--sarif PATH`` writes the findings
  through the shared ``tools/sarif.py`` emitter.
- ``replay path/to/artifact.json`` re-executes a race artifact from its
  contents alone (schedule seed, PCT config, and planted-race switches
  are all pinned inside); exit 1 unless the trace digest matches
  byte-for-byte AND the recorded violation fires again.
- ``bridge`` runs a clean sweep purely to collect the runtime lock-order
  witness graph and cross-checks it against qwlint QW007's static graph;
  exit 1 on a scope gap (see ``tools/qwrace/bridge.py``).
- ``selftest`` is the mandatory pipeline proof: for each planted race
  switch (``QW_RACE_BREAK_THRESHOLD``, ``QW_RACE_BREAK_POOL``) it must
  find the race within a bounded seed budget, shrink it, and replay the
  artifact byte-identically. A selftest failure means the detector — not
  the code under test — regressed.
- ``check`` is the qwcheck gate: bridge conformance + a short clean
  sweep (no races tolerated) in one exit code.

Every command that runs the cluster runs its searches on ``--device``
(default ``QW_DEVICE``, else ``cuda``; ``--device cpu`` for the CPU). The
schedule does not depend on the device: a seed gives the same schedule
digest on the card and on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any, Optional

from ...dst.artifact import load_artifact
from ...dst.harness import replay, scenario_by_name, sweep

from .bridge import compare
from .harness import (BREAK_ENV_VARS, QWRACE_RULES, PctRace,
                      findings_to_sarif_results)


def _race_findings(summary: dict[str, Any]) -> list[dict]:
    """Extract the raw detector findings from a sweep summary's
    violation entries (the `details` of race-invariant violations)."""
    out = []
    for entry in summary["violations"]:
        details = entry.get("violation", {}).get("details", {})
        if details:
            out.append(details)
    return out


def _emit_sarif(path: str, findings: list[dict],
                gaps: Optional[list[dict]] = None) -> None:
    from tools.sarif import write_sarif
    results = findings_to_sarif_results(findings, gaps)
    write_sarif(Path(path), "qwrace", QWRACE_RULES, results)


def _pct_from_args(args: argparse.Namespace,
                   break_flags: Optional[dict[str, bool]] = None) -> PctRace:
    return PctRace(depth=args.depth, horizon=args.horizon,
                   max_steps=args.max_steps, break_flags=break_flags)


def _cmd_sweep(args: argparse.Namespace) -> int:
    scenario = scenario_by_name(args.scenario)
    race = _pct_from_args(args)
    summary = sweep(scenario, seeds=args.seeds, start_seed=args.start_seed,
                    artifacts_dir=args.artifacts_dir,
                    stop_on_first=not args.keep_going, race=race,
                    device=args.device)
    report = compare(race.witness_union)
    out = {"sweep": {k: v for k, v in summary.items()
                     if k != "violations"},
           "violations": summary["violations"],
           "bridge": report,
           "ok": summary["ok"] and report["conforms"]}
    if args.sarif:
        _emit_sarif(args.sarif, _race_findings(summary), report["gaps"])
    if args.json:
        print(json.dumps(out, sort_keys=True, indent=2))
    else:
        print(f"qwrace sweep: scenario={scenario.name} seeds={args.seeds} "
              f"passed={len(summary['passed'])} "
              f"violations={len(summary['violations'])} "
              f"bridge={'conforms' if report['conforms'] else 'GAPS'}")
        for entry in summary["violations"]:
            line = f"  seed {entry['seed']}: {entry['invariant']}"
            details = entry.get("violation", {}).get("details", {})
            if details.get("object"):
                line += f" on {details['object']}.{details.get('field')}"
            if "ops_after_shrink" in entry:
                line += (f" (shrunk {entry['ops_before_shrink']}"
                         f"→{entry['ops_after_shrink']} ops)")
            if "artifact" in entry:
                line += f" -> {entry['artifact']}"
            print(line)
        for gap in report["gaps"]:
            print(f"  scope gap: {gap['held']} -> {gap['acquired']} "
                  f"(witnessed at {gap['site']})")
    return 0 if out["ok"] else 1


def _cmd_replay(args: argparse.Namespace) -> int:
    artifact = load_artifact(args.artifact)
    result, digest_match = replay(artifact, device=args.device)
    expected = artifact["violation"]["invariant"]
    reproduced = any(v.invariant == expected for v in result.violations)
    out = {
        "seed": result.seed,
        "scenario": result.scenario.name,
        "digest": result.digest,
        "expected_digest": artifact["trace_digest"],
        "digest_match": digest_match,
        "expected_violation": expected,
        "violation_reproduced": reproduced,
        "race": artifact.get("race"),
        "violations": [v.to_dict() for v in result.violations],
    }
    if args.json:
        print(json.dumps(out, sort_keys=True, indent=2))
    else:
        status = ("REPLAYED byte-identically" if digest_match
                  else "TRACE DIVERGED")
        print(f"seed {result.seed} ({result.scenario.name}): {status}; "
              f"violation {expected!r} "
              f"{'reproduced' if reproduced else 'NOT reproduced'}")
    return 0 if (digest_match and reproduced) else 1


def _cmd_bridge(args: argparse.Namespace) -> int:
    scenario = scenario_by_name(args.scenario)
    race = _pct_from_args(args)
    summary = sweep(scenario, seeds=args.seeds, race=race,
                    shrink_violations=False, device=args.device)
    report = compare(race.witness_union)
    report["sweep_violations"] = len(summary["violations"])
    if args.sarif:
        _emit_sarif(args.sarif, _race_findings(summary), report["gaps"])
    if args.json:
        print(json.dumps(report, sort_keys=True, indent=2))
    else:
        print(f"qwrace bridge: witnessed={report['witnessed']} "
              f"static={report['static_edges']} "
              f"declared_used={len(report['declared_used'])} "
              f"anonymous={len(report['anonymous'])} "
              f"unwitnessed={len(report['unwitnessed'])} "
              f"{'CONFORMS' if report['conforms'] else 'SCOPE GAPS'}")
        for gap in report["gaps"]:
            print(f"  scope gap: {gap['held']} -> {gap['acquired']} "
                  f"(witnessed at {gap['site']})")
        for edge in report["declared_used"]:
            print(f"  declared: {edge['held']} -> {edge['acquired']}")
        for edge in report["unwitnessed"]:
            print(f"  unwitnessed static edge: {edge['held']} -> "
                  f"{edge['acquired']} ({edge['sites']} sites)")
    return 0 if report["conforms"] else 1


# planted switch -> the shared object its race lives on; selftest asserts
# the finding names the right object so a different (accidental) race
# cannot mask a broken plant
_PLANTED = {
    "QW_RACE_BREAK_THRESHOLD": "ThresholdBox",
    "QW_RACE_BREAK_POOL": "WorkerPool",
}


def run_selftest(budget: int = 10, depth: int = 3,
                 horizon: int = 4096, device=None) -> dict[str, Any]:
    """Find, shrink, and byte-identically replay both planted races.
    Pure function (no argparse) so tests and the qwcheck gate share it."""
    scenario = scenario_by_name("fanout")
    checks = []
    for flag in BREAK_ENV_VARS:
        race = PctRace(depth=depth, horizon=horizon,
                       break_flags={flag: True})
        summary = sweep(scenario, seeds=budget, race=race, device=device)
        doc: dict[str, Any] = {"flag": flag,
                               "expected_object": _PLANTED[flag]}
        hits = [e for e in summary["violations"]
                if e["invariant"] == "data_race"]
        if not hits:
            doc.update(ok=False, error=f"no data_race in {budget} seeds")
            checks.append(doc)
            continue
        entry = hits[0]
        details = entry["violation"]["details"]
        doc.update(seed=entry["seed"],
                   object=details.get("object", ""),
                   field=details.get("field", ""),
                   ops_before_shrink=entry.get("ops_before_shrink"),
                   ops_after_shrink=entry.get("ops_after_shrink"))
        result, digest_match = replay(entry["artifact_inline"],
                                      device=device)
        reproduced = any(v.invariant == "data_race"
                         for v in result.violations)
        doc.update(digest_match=digest_match, reproduced=reproduced,
                   ok=(digest_match and reproduced
                       and doc["object"].startswith(_PLANTED[flag])))
        checks.append(doc)
    return {"ok": all(c["ok"] for c in checks), "budget": budget,
            "checks": checks}


def _cmd_selftest(args: argparse.Namespace) -> int:
    doc = run_selftest(budget=args.budget, depth=args.depth,
                       horizon=args.horizon, device=args.device)
    if args.json:
        print(json.dumps(doc, sort_keys=True, indent=2))
    else:
        for c in doc["checks"]:
            if c["ok"]:
                print(f"qwrace selftest: {c['flag']}: found at seed "
                      f"{c['seed']} on {c['object']}.{c['field']} "
                      f"(shrunk {c['ops_before_shrink']}"
                      f"→{c['ops_after_shrink']} ops), replayed "
                      "byte-identically")
            else:
                print(f"qwrace selftest: {c['flag']}: FAIL — "
                      f"{c.get('error', c)}")
    return 0 if doc["ok"] else 1


def run_gate(seeds: int = 3, device=None) -> tuple[int, dict[str, Any]]:
    """The qwcheck gate: a short clean PCT sweep over the fanout scenario
    (no race findings tolerated) plus static↔dynamic lock-graph
    conformance over the witnessed edges."""
    race = PctRace()
    summary = sweep(scenario_by_name("fanout"), seeds=seeds, race=race,
                    shrink_violations=False, device=device)
    report = compare(race.witness_union)
    ok = summary["ok"] and report["conforms"]
    doc = {
        "ok": ok,
        "seeds": seeds,
        "race_violations": [
            {"seed": e["seed"], "invariant": e["invariant"],
             "details": e.get("violation", {}).get("details", {})}
            for e in summary["violations"]],
        "bridge": {k: report[k] for k in
                   ("conforms", "gaps", "declared_used", "anonymous",
                    "unwitnessed", "witnessed", "static_edges")},
    }
    return (0 if ok else 1), doc


def _cmd_check(args: argparse.Namespace) -> int:
    rc, doc = run_gate(seeds=args.seeds, device=args.device)
    if args.json:
        print(json.dumps(doc, sort_keys=True, indent=2))
    else:
        print(f"qwrace check: {'ok' if rc == 0 else 'FAIL'} "
              f"(seeds={doc['seeds']}, "
              f"races={len(doc['race_violations'])}, "
              f"bridge={'conforms' if doc['bridge']['conforms'] else 'GAPS'})")
    return rc


def _add_pct_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--depth", type=int, default=3,
                        help="PCT bug depth d (d-1 change points)")
    parser.add_argument("--horizon", type=int, default=4096,
                        help="PCT horizon k: change points drawn from the "
                             "first k decisions; match to trace length "
                             "for deep lock-order bugs")
    parser.add_argument("--max-steps", type=int, default=500_000,
                        help="scheduler step budget per run")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m quickwit_tpu_torch.tools.qwrace",
        description="deterministic happens-before race detection over "
                    "the DST scheduler")
    sub = parser.add_subparsers(dest="command", required=True)

    p_sweep = sub.add_parser("sweep", help="PCT schedule exploration "
                                           "with race detection")
    p_sweep.add_argument("--scenario", default="fanout")
    p_sweep.add_argument("--seeds", type=int, default=10)
    p_sweep.add_argument("--start-seed", type=int, default=0)
    p_sweep.add_argument("--artifacts-dir", default=None)
    p_sweep.add_argument("--keep-going", action="store_true")
    p_sweep.add_argument("--sarif", default=None, metavar="PATH")
    p_sweep.add_argument("--json", action="store_true")
    _add_pct_args(p_sweep)
    p_sweep.set_defaults(fn=_cmd_sweep)

    p_replay = sub.add_parser("replay",
                              help="re-execute a race artifact")
    p_replay.add_argument("artifact")
    p_replay.add_argument("--json", action="store_true")
    p_replay.set_defaults(fn=_cmd_replay)

    p_bridge = sub.add_parser("bridge",
                              help="static↔dynamic lock-graph conformance")
    p_bridge.add_argument("--scenario", default="fanout")
    p_bridge.add_argument("--seeds", type=int, default=3)
    p_bridge.add_argument("--sarif", default=None, metavar="PATH")
    p_bridge.add_argument("--json", action="store_true")
    _add_pct_args(p_bridge)
    p_bridge.set_defaults(fn=_cmd_bridge)

    p_self = sub.add_parser("selftest",
                            help="planted-race pipeline proof")
    p_self.add_argument("--budget", type=int, default=10,
                        help="seed budget per planted race")
    p_self.add_argument("--json", action="store_true")
    _add_pct_args(p_self)
    p_self.set_defaults(fn=_cmd_selftest)

    p_check = sub.add_parser("check", help="the qwcheck gate: clean "
                                           "sweep + bridge conformance")
    p_check.add_argument("--seeds", type=int, default=3)
    p_check.add_argument("--json", action="store_true")
    p_check.set_defaults(fn=_cmd_check)

    for p in (p_sweep, p_replay, p_bridge, p_self, p_check):
        p.add_argument("--device", default=os.environ.get("QW_DEVICE"),
                       help="where the cluster searches (default "
                            "QW_DEVICE, else cuda)")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
