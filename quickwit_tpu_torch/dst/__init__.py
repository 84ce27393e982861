"""Deterministic whole-cluster simulation (DST).

Counterpart of the JAX package's `dst/`, over this package's components;
the cluster's searches run on one device (`device=`, default `cuda`).

Role of the reference fork's `quickwit-dst` crate + TLA+ specs (PAPER.md):
run a full in-process cluster — ingest with chained replication, WAL
drain/publish, merges, a polling metastore, control-plane planning, search
fan-out, the offload autoscaler — under ONE seeded scheduler that owns
virtual time, the op interleaving, the simulated network, and the fault
schedule, then check a library of invariants continuously and at
quiescence. Any violation emits a self-contained JSON replay artifact
that `python -m quickwit_tpu_torch.dst replay` re-executes byte-identically,
after automatic seed-local shrinking.

Entry points:

- `Scenario` / `SCENARIOS` — the workload DSL (`scenario.py`)
- `run_scenario(scenario, seed)` — one deterministic run (`harness.py`)
- `sweep(scenario, seeds)` — explore seeds, shrink + persist violations
- `replay(artifact)` — re-execute a replay artifact
- `python -m quickwit_tpu_torch.dst sweep|replay` — the CLI (`__main__.py`)

Everything the simulation touches must read time and randomness through
`quickwit_tpu_torch.common.clock` — the harness
installs a `FakeClock` and a seeded `random.Random` process-wide for the
duration of a run, so scenario hours cost milliseconds of wall time and
two runs of the same seed produce bit-identical traces.
"""

from .artifact import load_artifact, save_artifact
from .harness import RunResult, replay, run_scenario, shrink, sweep
from .invariants import INVARIANTS, Violation
from .scenario import SCENARIOS, Scenario

__all__ = [
    "INVARIANTS",
    "RunResult",
    "SCENARIOS",
    "Scenario",
    "Violation",
    "load_artifact",
    "replay",
    "run_scenario",
    "save_artifact",
    "shrink",
    "sweep",
]
