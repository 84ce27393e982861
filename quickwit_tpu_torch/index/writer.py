"""Split-writer pieces that the synthetic split generator and plan lowering
use.

Subset of the JAX package's `index/writer.py`: `ANALYZER_VERSION` and the
format-v3 impact ordering pass (`apply_impact_ordering`). The document
writer itself is not carried over yet.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from .impact import IMPACT_BLOCK, IMPACT_BUCKETS, build_impact_arrays

# current analyzer generation (v2 = Porter2 en_stem); stamped into split
# footers so stale-analysis splits are detectable at plan time
ANALYZER_VERSION = 2


def _impact_enabled() -> bool:
    """Kill switch mirroring `_packing_enabled`: QW_DISABLE_IMPACT=1 keeps
    postings doc-ordered with no impact arrays (the v2 layout under a v3
    footer) — the comparator for the impact equivalence suite and bench."""
    return os.environ.get("QW_DISABLE_IMPACT", "0") != "1"


def apply_impact_ordering(arrays: dict[str, np.ndarray], avg_len: float,
                          num_docs: int) -> Optional[dict[str, Any]]:
    """Impact-order one inverted field's posting arenas in place of the
    doc-ordered ones and attach the v3 `impact.*` arrays. `arrays` uses the
    writer's suffix keys (`postings.ids`, `terms.df`, ...); mutated in
    place. Returns the field-meta impact descriptor, or None when the field
    keeps doc order (kill switch, positions recorded, or no terms).

    Shared by the initial write (`_write_inverted`) and the merge path
    (`merge_arrays._merge_inverted`), so merged splits re-quantize against
    their merged df/fieldnorm/avg_len instead of inheriting stale scales.
    """
    if (not _impact_enabled() or "positions.offsets" in arrays
            or not len(arrays["terms.df"])):
        return None
    ids, tfs, quant, bmax, scales = build_impact_arrays(
        arrays["postings.ids"], arrays["postings.tfs"],
        arrays["terms.post_off"], arrays["terms.df"],
        arrays["fieldnorm"], avg_len, num_docs)
    arrays["postings.ids"] = ids
    arrays["postings.tfs"] = tfs
    arrays["impact.quant"] = quant
    arrays["impact.bmax"] = bmax
    arrays["impact.scale"] = scales
    return {"buckets": IMPACT_BUCKETS, "block": IMPACT_BLOCK,
            "ordered": True}
