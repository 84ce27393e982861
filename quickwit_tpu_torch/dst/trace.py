"""Run trace: the deterministic event log a simulation run produces.

The trace is the determinism oracle: two executions of the same
(seed, scenario, op list, fault plan) must produce byte-identical traces —
`digest()` is what the harness, the self-tests, and `dst replay` compare.
Consequently every recorded field must be a pure function of the run's
inputs: op summaries, virtual timestamps, invariant observations, fault
decisions — never wall-clock times, filesystem paths, object ids, or
anything else that varies across processes.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def canonical_json(value: Any) -> str:
    """Stable serialization: sorted keys, no whitespace — the byte form
    every digest in the DST layer is computed over."""
    return json.dumps(value, sort_keys=True, separators=(",", ":"))


def blake2b_digest(value: Any) -> str:
    """THE digest of the artifact/trace schema: blake2b-128 over canonical
    JSON. Every digest field in a DST replay artifact, a qwmc counterexample
    artifact, or a run trace is computed by this one function, so the two
    artifact families cannot drift apart byte-format-wise."""
    return hashlib.blake2b(canonical_json(value).encode(),
                           digest_size=16).hexdigest()


class Trace:
    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []

    def record(self, kind: str, **fields: Any) -> None:
        event = {"kind": kind}
        event.update(fields)
        # round-trip through canonical JSON now: a non-serializable or
        # non-deterministic value should fail at the recording site, not
        # at digest time three hundred events later
        self.events.append(json.loads(canonical_json(event)))

    def digest(self) -> str:
        return blake2b_digest(self.events)

    def __len__(self) -> int:
        return len(self.events)
