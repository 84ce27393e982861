"""qwrace ↔ DST glue: the PCT race controller `run_scenario` accepts.

`PctRace` is the `race=` argument for `quickwit_tpu_torch.dst.harness.
run_scenario/sweep/shrink/replay`: per run it derives a scheduler seed
from the DST seed, builds a fresh `RaceRuntime` + `RaceDetector`, installs
them through the `common/sync.py` seam for the run's whole lifetime
(cluster build included — a lock created outside the runtime would be
invisible to happens-before and produce false races), and converts
detector findings into DST `Violation`s (invariant `data_race` /
`race_deadlock` / `race_scheduler`) so the existing shrinker and artifact
machinery apply unchanged.

The controller also unions each run's lock-order witness edges, feeding
`bridge.py`'s static↔dynamic conformance check.

`to_dict()` gives the JAX package's controller dict key for key, so the
`race` section of an artifact reads the same in both packages.
"""

from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator, Optional

from ...common import sync
from ...dst.invariants import Violation

from .detector import RaceDetector
from .runtime import RaceRuntime, SchedulerAbort

RACE_INVARIANTS = ("data_race", "race_deadlock", "race_scheduler")

# planted-race switches (mandatory self-test of the detection pipeline):
# read at object construction time by ThresholdBox / WorkerPool, so they
# must be pinned in the artifact and re-applied by replay — an artifact
# must reproduce from the file ALONE, not from ambient environment
BREAK_ENV_VARS = ("QW_RACE_BREAK_THRESHOLD", "QW_RACE_BREAK_POOL")


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


def _scheduler_seed(seed: int, salt: str) -> int:
    digest = hashlib.blake2b(f"{salt}:{seed}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


class ActiveRace:
    """Per-run state; created by `PctRace.begin(seed)`."""

    abort_exc = SchedulerAbort

    def __init__(self, config: "PctRace", seed: int):
        self.config = config
        self.detector = RaceDetector()
        self.runtime = RaceRuntime(
            seed=_scheduler_seed(seed, config.seed_salt),
            depth=config.depth, horizon=config.horizon,
            max_steps=config.max_steps, detector=self.detector)
        self._finalized = False

    @contextmanager
    def activate(self) -> Iterator["ActiveRace"]:
        previous = sync.set_runtime(self.runtime)
        self.runtime.install_main()
        # pin the planted-race env switches to the CONTROLLER's recorded
        # values for the run's duration: replay of a break-flag artifact
        # reproduces in a fresh process with a clean environment
        saved = {name: os.environ.get(name) for name in BREAK_ENV_VARS}
        for name in BREAK_ENV_VARS:
            if self.config.break_flags.get(name):
                os.environ[name] = "1"
            else:
                os.environ.pop(name, None)
        try:
            yield self
        finally:
            sync.set_runtime(previous)
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value

    def before_op(self, step: int) -> None:
        self.detector.set_op_step(step)

    def finalize(self) -> None:
        """Idempotent end-of-run teardown: abort + wake parked threads,
        flip the instrumented primitives into plain fallback mode (so
        `cluster.close()` still works), and fold this run's witness
        edges into the sweep-level union."""
        if self._finalized:
            return
        self._finalized = True
        self.runtime.shutdown()
        for edge, site in self.detector.witness_edges.items():
            self.config.witness_union.setdefault(edge, site)

    def violations(self) -> list[Violation]:
        out = []
        for finding in self.detector.findings():
            kind = finding.get("kind", "")
            if kind == "deadlock":
                invariant = "race_deadlock"
            elif kind == "scheduler_budget_exhausted":
                invariant = "race_scheduler"
            else:
                invariant = "data_race"
            out.append(Violation(invariant=invariant,
                                 step=int(finding.get("op_step", 0)),
                                 details=finding))
        return out

    def trace_event(self) -> dict[str, Any]:
        return {"steps": self.runtime.steps,
                "schedule_digest": self.runtime.schedule_digest(),
                "findings": len(self.detector.findings()),
                "witness_edges": len(self.detector.witness_edges)}


@dataclass
class PctRace:
    """The `race=` controller: seeded PCT schedule exploration. One
    instance can drive a whole sweep — `begin` hands out fresh per-run
    state; `witness_union` accumulates lock-order edges across runs."""

    depth: int = 3
    horizon: int = 4096
    max_steps: int = 500_000
    seed_salt: str = "qwrace"
    # None = snapshot the ambient QW_RACE_BREAK_* environment once, at
    # construction; an explicit dict (replay) overrides the environment
    break_flags: Optional[dict[str, bool]] = None

    def __post_init__(self) -> None:
        self.witness_union: dict[tuple[str, str], str] = {}
        if self.break_flags is None:
            self.break_flags = {name: _env_flag(name)
                                for name in BREAK_ENV_VARS}

    def begin(self, seed: int) -> ActiveRace:
        return ActiveRace(self, seed)

    def to_dict(self) -> dict[str, Any]:
        return {"pct": {"depth": self.depth, "horizon": self.horizon,
                        "max_steps": self.max_steps,
                        "seed_salt": self.seed_salt,
                        "break_flags": {k: bool(v) for k, v
                                        in sorted(self.break_flags.items())
                                        if v}}}


def race_from_dict(data: Optional[dict[str, Any]]) -> Optional[PctRace]:
    """Reconstruct the controller from an artifact's `race` section —
    the hook `dst replay` uses so a race artifact re-executes from the
    file alone."""
    if not data:
        return None
    pct = data.get("pct", {})
    return PctRace(depth=int(pct.get("depth", 3)),
                   horizon=int(pct.get("horizon", 4096)),
                   max_steps=int(pct.get("max_steps", 500_000)),
                   seed_salt=str(pct.get("seed_salt", "qwrace")),
                   break_flags={str(k): bool(v) for k, v
                                in pct.get("break_flags", {}).items()})


# --- SARIF ------------------------------------------------------------------

QWRACE_RULES = {
    "QWRACE001": "data race: conflicting accesses with no happens-before "
                 "order",
    "QWRACE002": "deadlock: every instrumented thread blocked with no "
                 "timed waiter",
    "QWRACE003": "lock-graph scope gap: runtime lock-order edge absent "
                 "from qwlint QW007's static graph",
}


def findings_to_sarif_results(findings: list[dict[str, Any]],
                              bridge_gaps: Optional[list[dict]] = None
                              ) -> list[dict]:
    """Map detector findings (+ bridge scope gaps) onto the result shape
    of the repo's shared SARIF emitter (`tools/sarif.py`)."""
    results: list[dict] = []
    for f in findings:
        kind = f.get("kind", "")
        if kind == "deadlock":
            results.append({
                "ruleId": "QWRACE002",
                "message": "deadlock: blocked threads "
                           + ", ".join(b["name"] for b in f["blocked"]),
                "site": "scheduler",
            })
            continue
        if kind == "scheduler_budget_exhausted":
            results.append({
                "ruleId": "QWRACE002",
                "message": f"scheduler budget exhausted after "
                           f"{f['steps']} steps (livelock suspect)",
                "site": "scheduler",
            })
            continue
        site = f["access"]["site"]
        path, _, line = site.rpartition(":")
        results.append({
            "ruleId": "QWRACE001",
            "message": f"{f['kind']} race on {f['object']}.{f['field']}: "
                       f"{f['access']['site']} "
                       f"(locks {f['access']['lockset'] or 'none'}) vs "
                       f"{f['previous']['site']} "
                       f"(locks {f['previous']['lockset'] or 'none'})",
            "file": path or site,
            "line": int(line) if line.isdigit() else None,
            "id": f"{f['kind']}:{f['object']}.{f['field']}",
        })
    for gap in bridge_gaps or []:
        results.append({
            "ruleId": "QWRACE003",
            "message": f"runtime lock-order edge {gap['held']} -> "
                       f"{gap['acquired']} (witnessed at {gap['site']}) "
                       "is absent from QW007's static graph",
            "site": f"{gap['held']}->{gap['acquired']}",
        })
    return results
