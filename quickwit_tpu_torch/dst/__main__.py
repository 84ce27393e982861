"""CLI: ``python -m quickwit_tpu_torch.dst {sweep,replay,list}``.

- ``sweep --scenario mixed --seeds 200 [--artifacts-dir DIR] [--json]``
  explores seeds; exit code 1 if any seed violated an invariant (its
  shrunk replay artifact is persisted / printed). ``--conformance``
  additionally replays every trace against the qwmc checkpoint model
  (``tools.qwmc.conformance``): a trace that is not a behavior of the
  exhaustively-checked model fails the sweep even if no runtime
  invariant fired. ``--pct`` layers the qwrace PCT scheduler
  (``quickwit_tpu_torch.tools.qwrace``) under every run: thread
  interleavings become seed-deterministic and a FastTrack happens-before
  detector reports data races / deadlocks as regular DST violations
  (shrunk and persisted like any other).
- ``replay path/to/artifact.json [--json]`` re-executes an artifact and
  exits 1 unless the trace digest matches byte-for-byte AND the recorded
  violation fires again (an artifact recorded under ``--pct`` re-runs
  under the controller its ``race`` section describes).
- ``list`` prints the scenario and invariant catalogs.

``sweep`` and ``replay`` run the cluster's searches on ``--device``
(default ``QW_DEVICE``, else ``cuda``; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .artifact import load_artifact
from .harness import replay, scenario_by_name, sweep
from .invariants import INVARIANTS
from .scenario import SCENARIOS


def _cmd_sweep(args: argparse.Namespace) -> int:
    scenario = scenario_by_name(args.scenario)
    race = None
    if args.pct:
        # lazy: a sweep without --pct never loads the controller
        from ..tools.qwrace.harness import PctRace
        race = PctRace(depth=args.pct_depth, horizon=args.pct_horizon)
    summary = sweep(scenario, seeds=args.seeds, start_seed=args.start_seed,
                    artifacts_dir=args.artifacts_dir,
                    shrink_violations=not args.no_shrink,
                    stop_on_first=not args.keep_going,
                    conformance=args.conformance,
                    race=race, device=args.device)
    if args.json:
        print(json.dumps(summary, sort_keys=True, indent=2))
    else:
        line = (f"scenario={summary['scenario']} seeds={summary['seeds']} "
                f"passed={len(summary['passed'])} "
                f"violations={len(summary['violations'])}")
        if "nonconforming" in summary:
            line += f" nonconforming={len(summary['nonconforming'])}"
        print(line)
        for entry in summary.get("nonconforming", []):
            for v in entry["report"]["violations"]:
                print(f"  seed {entry['seed']}: trace not a model "
                      f"behavior — {v['invariant']} on {v['index']}: "
                      f"{v['detail']}")
        for entry in summary["violations"]:
            line = (f"  seed {entry['seed']}: {entry['invariant']}")
            if "ops_after_shrink" in entry:
                line += (f" (shrunk {entry['ops_before_shrink']}"
                         f"→{entry['ops_after_shrink']} ops)")
            if "artifact" in entry:
                line += f" -> {entry['artifact']}"
            print(line)
    return 0 if summary["ok"] else 1


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


def _cmd_list(args: argparse.Namespace) -> int:
    out = {
        "scenarios": {
            name: {"nodes": sc.nodes, "steps": sc.steps,
                   "invariants": list(sc.invariants),
                   "fault_rules": len(sc.fault_rules)}
            for name, sc in sorted(SCENARIOS.items())
        },
        "invariants": INVARIANTS,
    }
    if args.json:
        print(json.dumps(out, sort_keys=True, indent=2))
    else:
        print("scenarios:")
        for name, info in out["scenarios"].items():
            print(f"  {name}: nodes={info['nodes']} steps={info['steps']} "
                  f"invariants={len(info['invariants'])}")
        print("invariants:")
        for name, desc in INVARIANTS.items():
            print(f"  {name}: {desc}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m quickwit_tpu_torch.dst",
        description="deterministic whole-cluster simulation harness")
    sub = parser.add_subparsers(dest="command", required=True)

    p_sweep = sub.add_parser("sweep", help="run a seed sweep")
    p_sweep.add_argument("--scenario", default="mixed",
                         choices=sorted(SCENARIOS))
    p_sweep.add_argument("--seeds", type=int, default=100)
    p_sweep.add_argument("--start-seed", type=int, default=0)
    p_sweep.add_argument("--artifacts-dir", default=None)
    p_sweep.add_argument("--no-shrink", action="store_true",
                         help="persist violations without shrinking")
    p_sweep.add_argument("--keep-going", action="store_true",
                         help="continue past the first violating seed")
    p_sweep.add_argument("--conformance", action="store_true",
                         help="also replay every trace against the qwmc "
                              "checkpoint model (refinement check)")
    p_sweep.add_argument("--pct", action="store_true",
                         help="run every seed under the qwrace PCT "
                              "scheduler: randomized-but-deterministic "
                              "thread interleavings with happens-before "
                              "race detection (tools/qwrace)")
    p_sweep.add_argument("--pct-depth", type=int, default=3,
                         help="PCT bug depth d: d-1 priority change "
                              "points per schedule (default 3)")
    p_sweep.add_argument("--pct-horizon", type=int, default=4096,
                         help="PCT horizon k: change points are drawn "
                              "from the first k scheduling decisions; "
                              "match to trace length for deep "
                              "deadlock-order bugs (default 4096)")
    p_sweep.add_argument("--json", action="store_true")
    p_sweep.set_defaults(fn=_cmd_sweep)

    p_replay = sub.add_parser("replay", help="re-execute a replay artifact")
    p_replay.add_argument("artifact")
    p_replay.add_argument("--json", action="store_true")
    p_replay.set_defaults(fn=_cmd_replay)

    for p in (p_sweep, p_replay):
        p.add_argument("--device", default=os.environ.get("QW_DEVICE"),
                       help="where the cluster searches (default "
                            "QW_DEVICE, else cuda)")

    p_list = sub.add_parser("list", help="list scenarios and invariants")
    p_list.add_argument("--json", action="store_true")
    p_list.set_defaults(fn=_cmd_list)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
