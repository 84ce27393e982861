"""qwrace — deterministic happens-before race detection over the DST
scheduler, for this package.

Counterpart of the JAX package's `tools/qwrace`, with the same modules:
FastTrack-style vector-clock detection (`detector`) running under a gated,
seeded PCT thread scheduler (`runtime`) installed through this package's
`common/sync.py` seam, so every detected race is deterministic, shrinkable
by the DST shrinker, and replayable byte-identically from a canonical-JSON
artifact (`harness`). `bridge` cross-checks the runtime lock-order witness
graph against qwlint QW007's static acquisition graph over this package's
tree. Host code: it imports neither torch nor the JAX package.
"""

from .detector import RaceDetector
from .harness import PctRace, race_from_dict
from .runtime import RaceRuntime, SchedulerAbort

__all__ = ["PctRace", "RaceDetector", "RaceRuntime", "SchedulerAbort",
           "race_from_dict"]
