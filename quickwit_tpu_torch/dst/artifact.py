"""Replay artifacts: self-contained canonical-JSON repro files.

One schema, two kinds. Every artifact this repo emits — a DST replay
artifact (``quickwit-dst-replay``) or a qwmc model-checker counterexample
(``quickwit-qwmc-counterexample``, `tools/qwmc/artifact.py`) — shares the
SAME envelope: a single ``version`` field (`ARTIFACT_VERSION`), a ``kind``
from `KNOWN_KINDS`, and a ``digest`` computed by the one blake2b helper in
`trace.py` over the canonical-JSON body. `save_artifact`/`load_artifact`
here are the only writers/readers for both families, so the formats cannot
drift apart: a version bump or digest change lands on every artifact kind
at once.

A DST replay artifact carries everything a fresh process needs to
re-execute a violating run byte-identically — the (shrunk) scenario, the
seed, the explicit op list, the fault plan with zeroed cursors, the
break-flag switches that were active, the violation, and the reference
trace + digest `dst replay` compares against. Nothing in it references
local filesystem state; `python -m quickwit_tpu_torch.dst replay <file>` on any
machine reproduces the run from the file alone. A qwmc counterexample
carries the model name, config, violated property, and the minimal action
path — `python -m tools.qwmc replay <file>` re-executes it the same way.
"""

from __future__ import annotations

import json
from typing import Any

from ..common.faults import FaultInjector
from .invariants import Violation
from .scenario import Scenario
from .trace import Trace, blake2b_digest, canonical_json

# single version for EVERY artifact kind: bumping it revs the DST replay
# and the qwmc counterexample formats together (version 1 = pre-envelope
# DST artifacts without the integrity digest; still loadable)
ARTIFACT_VERSION = 2
ARTIFACT_KIND = "quickwit-dst-replay"
QWMC_KIND = "quickwit-qwmc-counterexample"
KNOWN_KINDS = frozenset({ARTIFACT_KIND, QWMC_KIND})


def finish_artifact(kind: str, body: dict[str, Any]) -> dict[str, Any]:
    """Stamp the shared envelope onto an artifact body: version, kind, and
    the integrity digest over the canonical-JSON body (digest excludes the
    envelope fields themselves so it is reproducible from the payload)."""
    if kind not in KNOWN_KINDS:
        raise ValueError(f"unknown artifact kind: {kind!r}")
    payload = {k: v for k, v in body.items()
               if k not in ("version", "kind", "digest")}
    artifact = {"version": ARTIFACT_VERSION, "kind": kind,
                "digest": blake2b_digest(payload)}
    artifact.update(payload)
    return artifact


def make_artifact(scenario: Scenario, seed: int, ops: list[dict[str, Any]],
                  violation: Violation, trace: Trace,
                  break_publish: bool = False,
                  break_wal: bool = False,
                  race: Any = None,
                  flight_tail: Any = None) -> dict[str, Any]:
    # a FRESH injector's plan (cursors at zero): replay must start the
    # fault decision streams from the beginning, not where the run ended
    fault_plan = FaultInjector(seed, list(scenario.fault_rules)).to_plan()
    body = {
        "scenario": scenario.to_dict(),
        "seed": int(seed),
        "ops": list(ops),
        "fault_plan": fault_plan,
        "break_flags": {"publish": bool(break_publish),
                        "wal": bool(break_wal)},
        "violation": violation.to_dict(),
        "trace_digest": trace.digest(),
        "trace": list(trace.events),
    }
    if race is not None:
        # the PCT controller config: with it, `dst replay` reconstructs
        # the race runtime and the schedule re-derives from the seed alone
        body["race"] = race.to_dict()
    if flight_tail is not None:
        # the repro run's flight-recorder timeline (op-thread ring, virtual
        # timestamps): the shrunk artifact carries the device/runtime
        # timeline of the failure, and replay re-derives it byte-identically
        body["flight_tail"] = list(flight_tail)
    return finish_artifact(ARTIFACT_KIND, body)


def save_artifact(artifact: dict[str, Any], path: str,
                  kind: str = ARTIFACT_KIND) -> None:
    if artifact.get("kind") != kind:
        raise ValueError(
            f"not a {kind} artifact (kind={artifact.get('kind')!r})")
    with open(path, "w", encoding="utf-8") as f:
        # canonical form on disk too: diffing two artifacts is meaningful
        f.write(canonical_json(artifact))
        f.write("\n")


def load_artifact(path: str, kind: str = ARTIFACT_KIND) -> dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        artifact = json.load(f)
    if artifact.get("kind") != kind:
        raise ValueError(f"{path}: not a {kind} artifact")
    if int(artifact.get("version", -1)) > ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact version {artifact['version']} is newer than "
            f"this harness ({ARTIFACT_VERSION})")
    recorded = artifact.get("digest")
    if recorded is not None:
        payload = {k: v for k, v in artifact.items()
                   if k not in ("version", "kind", "digest")}
        actual = blake2b_digest(payload)
        if actual != recorded:
            raise ValueError(
                f"{path}: artifact digest mismatch (file says {recorded}, "
                f"payload hashes to {actual}) — corrupted or hand-edited")
    return artifact
