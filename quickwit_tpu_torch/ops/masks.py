"""Lane masks over key arrays.

Subset of the JAX package's `ops/masks.py`: `dead_lane_mask`, the one mask
the posting-space program needs. The doc-space predicate masks are not
carried over yet.
"""

from __future__ import annotations

import torch


def dead_lane_mask(keyed: torch.Tensor) -> torch.Tensor:
    """Lanes whose higher-is-better sort key is -inf: non-matching docs,
    threshold-pruned lanes, and search_after-excluded lanes. These never
    surface through top-k, and the hit lists are meaningless past the live
    prefix."""
    return torch.isneginf(keyed)
